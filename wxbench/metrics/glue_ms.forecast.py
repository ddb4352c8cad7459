"""Device ms per forecast step of the kernels launched under none of the
spans around the port's kernel entry points (cuBLAS, gathers, copies
made by kernels, element-wise work): torch's glue.  Copies by the copy
engine are not kernels and are left out."""

PANGU = "skyrim_tpu_torch.models.pangu"
GRAPHCAST = "skyrim_tpu_torch.models.graphcast"
KERNELS = ("K1", "K2", "K3", "K4", "K6", "K7", "K8", "K9")
SPANS = [(PANGU, "fused_swin_block", "K1"), (PANGU, "shift_roll", "K2"), (PANGU, "fused_downsample", "K3"),
         (PANGU, "fused_upsample", "K4"), (GRAPHCAST, "fused_mlp", "K6"),
         (GRAPHCAST, "fused_round_messages", "K7"), (GRAPHCAST, "fused_m2g_tiled", "K8"),
         (GRAPHCAST, "fused_g2m_tiled", "K9")]


def read(run):
    if run.profile is None or not run.steps or run.traffic["kind"] != "forecast":
        return None
    glue = sum(s for label, s in run.profile.kernel_s.items() if label not in KERNELS)
    return 1e3 * glue / run.steps

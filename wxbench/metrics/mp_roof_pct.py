"""GraphCast's message passing (K6-K9) as a share of its roofline: the sum
of the calls' bounds over the device time of the kernels launched under
the spans around ``fused_mlp``, ``fused_round_messages``,
``fused_m2g_tiled`` and ``fused_g2m_tiled``."""

from wxbench.harness.metric_util import roof_pct

SPANS = [("skyrim_tpu_torch.models.graphcast", "fused_mlp", "K6"),
         ("skyrim_tpu_torch.models.graphcast", "fused_round_messages", "K7"),
         ("skyrim_tpu_torch.models.graphcast", "fused_m2g_tiled", "K8"),
         ("skyrim_tpu_torch.models.graphcast", "fused_g2m_tiled", "K9")]


def read(run):
    return roof_pct(run, ["K6", "K7", "K8", "K9"])

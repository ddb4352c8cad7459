"""K1's share of its roofline: the sum over the window's
``fused_swin_block`` calls of their bound (the benchmark's count of each
call's FLOPs and bytes), over the device time of the kernels launched
under the span around those calls."""

from wxbench.harness.metric_util import roof_pct

SPANS = [("skyrim_tpu_torch.models.pangu", "fused_swin_block", "K1")]


def read(run):
    return roof_pct(run, ["K1"])

"""Device-timeline ms per forecast step inside the port's ``skyrim.K15``
spans (``ops/fused_block.py`` ``fused_swin_v2_block``, FuXi's Swin-V2
blocks): each span's CUDA events at entry and exit."""

from wxbench.harness.program_spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "forecast", "skyrim.K15")

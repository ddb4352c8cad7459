"""K15's share of its roofline: the window's ``skyrim.K15`` spans (one a
Swin-V2 block) times the bound of one block, over the device time inside
those spans (each span's CUDA events).

The bound is the benchmark's own count of a block at the configuration's
shapes, by ``harness/counts.py``'s rules: each input read once and each
output written once, activations and weights in bf16, vectors, the CPB bias
table, the shift mask and the head scales in f32; FLOPs of the four products
and the attention's two batched products.  Every block of the trunk has the
same shapes, the shift mask included (the unshifted blocks mask the padded
rows)."""

import math

from wxbench.harness.counts import BF16, F32, bound_s
from wxbench.harness.program_spans import records


def block_count(cfg: dict) -> tuple[int, int]:
    """(FLOPs, bytes) of one Swin-V2 block of the trunk."""
    wh, ww = cfg["window"]
    C, heads, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch"]
    Hd = -(-(-(-cfg["lat"] // p)) // 2)  # token rows after the 2 x 2 merge
    H = -(-Hd // wh) * wh  # padded to whole windows
    W = cfg["lon"] // p // 2
    N, wlen, hidden = H * W, wh * ww, 4 * C
    flops = 2 * N * (3 * C * C + C * C + 2 * C * hidden) + 4 * (N // wlen) * heads * wlen * wlen * (C // heads)
    nbytes = (2 * N * C + 4 * C * C + 2 * C * hidden) * BF16 + (9 * C + hidden + heads) * F32 \
        + (heads + H // wh) * wlen * wlen * F32
    return flops, nbytes


def read(run):
    recs = records(run, "forecast", "skyrim.K15")
    if recs is None:
        return None
    ms = [s.device_ms for s in recs]
    if None in ms or sum(ms) <= 0:
        return None
    return 100.0 * len(recs) * bound_s(*block_count(run.cfg)) / (math.fsum(ms) * 1e-3)

"""The benchmark's own count of the work in a kernel call, and the card's
peaks: the yardstick of the roofline shares and of ``mfu``.

Each function takes a port entry point's arguments and returns (FLOPs,
bytes) of the work at the call's shapes: each input read once and each
output written once, activations and weights in bf16 (2 bytes), vectors,
bias tables and masks in f32 (4 bytes), indices in int32.  FLOPs count the
products (2 per multiply-add) and the attention's two batched products;
element-wise work is not counted.  Nothing here asks the port what a call
costs, so the count reads the same work whatever implements it.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 989e12  # H100 SXM, bf16 dense, NVIDIA's data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
BF16, F32, I32 = 2, 4, 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _numel(t) -> int:
    return 0 if t is None else math.prod(t.shape)


def swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads):
    """K1: LN1 → qkv → window attention (earth bias, mask) → proj + x →
    LN2 → fc1 → GELU → fc2 + x1 on a window-padded (Z, H, W, C) tensor."""
    Z, H, W, C = x.shape
    N = Z * H * W
    hidden = mlp_wb[0].shape[1]
    wlen = math.prod(window)
    nwin = N // wlen
    flops = 2 * N * (3 * C * C + C * C + 2 * C * hidden) + 4 * nwin * heads * wlen * wlen * (C // heads)
    nbytes = (2 * N * C * BF16 + (4 * C * C + 2 * C * hidden) * BF16
              + (4 * C + 5 * C + hidden) * F32 + (_numel(bias) + _numel(mask)) * F32)
    return flops, nbytes


def shift_roll(x, shift, forward):
    """K2: a cyclic shift, zero flops; nothing runs for a zero shift."""
    if not any(int(s) for s in shift):
        return 0, 0
    return 0, 2 * _numel(x) * BF16


def downsample(x, ln, wb, prepared=None):
    """K3: 2×2 merge (odd H padded) → LN → Dense, (Z, H, W, C) → (Z, ⌈H/2⌉, W/2, N)."""
    Z, H, W, C = x.shape
    N = wb[0].shape[1]
    rows = Z * -(-H // 2) * (W // 2)
    return 2 * rows * 4 * C * N, (Z * H * W * C + rows * N + 4 * C * N) * BF16 + (8 * C + N) * F32


def upsample(x, wb, ln, prepared=None):
    """K4: Dense(4·Co) → 2×2 expand → LN, (Z, H, W, C) → (Z, 2H, 2W, Co)."""
    Z, H, W, C = x.shape
    Co4 = wb[0].shape[1]
    rows = Z * H * W
    return 2 * rows * C * Co4, (rows * C + rows * Co4 + C * Co4) * BF16 + (Co4 + Co4 // 2) * F32


def row_mlp(x, w1b1, w2b2, ln=None, x2=None, residual=None, x_transposed=False):
    """K6: swish([x ‖ x2] @ W0 + b0) @ W1 + b1 [→ LN] [+ residual] over rows."""
    n, cin = (x.shape[1], x.shape[0]) if x_transposed else (x.shape[0], x.shape[1])
    cin += 0 if x2 is None else x2.shape[1]
    hid, cout = w1b1[0].shape[1], w2b2[0].shape[1]
    flops = 2 * n * (cin * hid + hid * cout)
    acts = n * (cin + cout + (cout if residual is not None else 0))
    return flops, (acts + cin * hid + hid * cout) * BF16 + (hid + 3 * cout) * F32


def round_messages(edges, gsrc, staged, local, we, b0, wb, ln, SB):
    """K7: per edge LN(swish(e @ We + src + dst + b0) @ W1 + b1) + e, the new
    edges summed into their destinations; (B, M, L) edge blocks."""
    B, M, L = edges.shape
    flops = 2 * B * M * 2 * L * L + B * M * L
    nbytes = (3 * B * M * L + 2 * B * SB * L + 2 * L * L) * BF16 + B * M * I32 + 4 * L * F32
    return flops, nbytes


def m2g_tiled(uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th, tw):
    """K8: for each grid point the sum over its ``deg`` face vertices of
    LN(swish(src + bias + dst + b0) @ W1 + b1)."""
    H, W, KL = bias_hw.shape
    L = KL // deg
    P = H * W
    flops = 2 * P * deg * L * L + P * deg * L
    nbytes = (_numel(uniq) + P * KL + 2 * P * L + L * L) * BF16 + _numel(local_hw) * I32 + 4 * L * F32
    return flops, nbytes


def g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw, plan=None):
    """K9: the messages of the filled slots, LN(swish(src + bias + b0) @ W1 + b1),
    summed into their tile's mesh nodes.  Without the row plan every slot
    counts."""
    H, W, L = asrc_hw.shape
    slots = plan[0].shape[0] if plan is not None else H * W * D
    TH, TW = H // th, W // tw
    flops = 2 * slots * L * L + slots * L
    nbytes = (H * W * L + slots * L + TH * TW * U * L + L * L) * BF16 + slots * I32 + 4 * L * F32
    return flops, nbytes


COUNTS = {"K1": swin_block, "K2": shift_roll, "K3": downsample, "K4": upsample,
          "K6": row_mlp, "K7": round_messages, "K8": m2g_tiled, "K9": g2m_tiled}


def call_cost(label: str, args, kwargs):
    """(flops, bytes) of one call of the entry point spanned as ``label``, or
    None where the benchmark counts no work for it."""
    fn = COUNTS.get(label)
    return None if fn is None else fn(*args, **kwargs)

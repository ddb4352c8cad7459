"""Declared cost of each kernel call: FLOPs, bytes and transcendentals.

Each TPU kernel of the JAX package declares what one call costs in its
``pl.CostEstimate``, and XLA's cost analysis folds those into a step's
totals.  This module holds the port's copy: one function per kernel (K1–K14)
of the port wrapper's arguments, returning ``Cost(flops, bytes_accessed,
transcendentals)`` equal to the JAX kernel's estimate at these sites of
``skyrim_tpu/ops/``:

====  =========================================  =============================
K1    ``fused_swin_block``                       fused_block.py:377
K2    ``roll3d``                                 roll.py:71
K3    ``fused_downsample``                       resample.py:156
K4    ``fused_upsample``                         resample.py:263
K5    ``fused_window_attention_4d``              flash_window_attention.py:313
K6    ``fused_mlp``                              fused_mlp.py:201
K7    ``fused_round_messages``                   graph_kernels.py:423
K8    ``fused_m2g_tiled``                        graph_kernels.py:567
K9    ``fused_g2m_tiled``                        graph_kernels.py:715
K10   ``fused_window_attention``                 flash_window_attention.py:178
K11   ``flash_window_attention``                 flash_window_attention.py:450
K12   ``fused_finish``                           fused_mlp.py:287
K13   ``fused_fixed_degree_messages``            graph_kernels.py:154
K14   ``fused_block_messages``                   graph_kernels.py:269
====  =========================================  =============================

The formulas are the JAX ones, their simplifications included (K1 counts
its MLP as 4C wide, K7 and K9 count 2-byte elements), so a step's roofline
reads the same work whatever implements the kernels.  K3 counts the
row-padded input JAX's Pangu hands its kernel (an odd H padded to even,
``skyrim_tpu/models/pangu.py:227-229``); the port pads inside the wrapper.

Every public wrapper runs inside ``kernel(name, cost_fn, *args)``: it adds
the call's cost to each active ``count_costs()`` and suspends every
``TorchDispatchMode`` (``utils/op_bytes.py``'s, ``FlopCounterMode``'s)
while the wrapper runs.  That holds whichever version runs — the plain
PyTorch version on a CPU tensor or the kernel on a CUDA one — so a step
counts the same on both: the kernel's declared cost, and none of the plain
version's ops.  Only the outermost wrapper is charged, so a call counts
once however many launches it makes (K1's seven-launch chain at C > 512
counts K1 once, as the JAX kernel does).  Nothing is computed when no
count is active.  The outermost wrapper is also the kernel's span,
``skyrim.<name>`` (``utils/profiling.py`` ``annotate``), timed on the
device of the call's first argument.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from skyrim_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class Cost:
    flops: int
    bytes_accessed: int
    transcendentals: int


class CostCount:
    """Running totals, and per kernel name ``[calls, flops, bytes, transcendentals]``."""

    def __init__(self):
        self.flops = self.bytes_accessed = self.transcendentals = 0
        self.by_kernel: dict[str, list[int]] = {}

    def add(self, name: str, c: Cost) -> None:
        self.flops += c.flops
        self.bytes_accessed += c.bytes_accessed
        self.transcendentals += c.transcendentals
        row = self.by_kernel.setdefault(name, [0, 0, 0, 0])
        for i, v in enumerate((1, c.flops, c.bytes_accessed, c.transcendentals)):
            row[i] += v

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals,
                "by_kernel": {k: dict(zip(("calls", "flops", "bytes_accessed", "transcendentals"), v))
                              for k, v in sorted(self.by_kernel.items())}}


_ACTIVE: list[CostCount] = []
_DEPTH = [0]  # wrappers open now: only the outermost is charged


@contextlib.contextmanager
def count_costs():
    """Count the declared cost of every kernel call made in the block."""
    c = CostCount()
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


@contextlib.contextmanager
def kernel(name: str, cost_fn, *args):
    """The block is one call of kernel ``name``: ``cost_fn(*args)`` is added to
    every active count, the dispatch modes are suspended inside it, and the
    outermost call is the span ``skyrim.<name>``."""
    outer = _DEPTH[0] == 0
    if outer and _ACTIVE:
        c = cost_fn(*args)
        for count in _ACTIVE:
            count.add(name, c)
    _DEPTH[0] += 1
    try:
        if not outer:
            yield
            return
        with annotate("skyrim." + name, device=args[0] if args else None):
            if torch._C._len_torch_dispatch_stack():
                from torch.utils._python_dispatch import _disable_current_modes

                with _disable_current_modes():
                    yield
            else:
                yield
    finally:
        _DEPTH[0] -= 1


def _isz(t) -> int:
    return t.element_size()


# --- K1, K2, K5, K10, K11: the window blocks and attention -----------------------


def swin_block(x, qkv_wb, mlp_wb, window, heads) -> Cost:
    Z, H, Wd, C = x.shape
    wz, wh, ww = window
    wlen = wz * wh * ww
    nwin = (Z // wz) * (H // wh) * (Wd // ww)
    hidden = mlp_wb[0].shape[1]
    isz = _isz(x)
    weights_b = (C * 3 * C + C * C + C * hidden + hidden * C) * isz
    return Cost(24 * Z * H * Wd * C * C + 4 * nwin * heads * wlen * wlen * (C // heads),
                2 * Z * H * Wd * C * isz + weights_b,
                nwin * heads * wlen * wlen + Z * H * Wd * hidden)


def roll(x) -> Cost:
    return Cost(0, 2 * x.numel() * _isz(x), 0)


def window_attention_4d(qkv, window, heads) -> Cost:
    Z, H, Wd, c3 = qkv.shape
    C = c3 // 3
    wz, wh, ww = window
    wlen = wz * wh * ww
    nwin = (Z // wz) * (H // wh) * (Wd // ww)
    return Cost(4 * nwin * heads * wlen * wlen * (C // heads), Z * H * Wd * (c3 + C) * _isz(qkv),
                nwin * heads * wlen * wlen)


def window_attention_rows(qkv, heads) -> Cost:
    n_win, wlen, c3 = qkv.shape
    C = c3 // 3
    return Cost(4 * n_win * heads * wlen * wlen * (C // heads), n_win * wlen * (c3 + C) * _isz(qkv),
                n_win * heads * wlen * wlen)


def window_attention_split(q) -> Cost:
    n_win, heads, wlen, hd = q.shape
    return Cost(4 * n_win * heads * wlen * wlen * hd, 4 * n_win * heads * wlen * hd * _isz(q),
                n_win * heads * wlen * wlen)


# --- K3, K4: the resample kernels ----------------------------------------------


def downsample(x, wb) -> Cost:
    Z, H, Wd, C = x.shape
    H += H % 2  # the row JAX's Pangu pads before its kernel
    H2, W2 = H // 2, Wd // 2
    Co = wb[0].shape[1]
    isz = _isz(x)
    return Cost(2 * Z * H2 * W2 * 4 * C * Co, Z * H * Wd * C * isz + Z * H2 * W2 * Co * isz, 0)


def upsample(x, wb) -> Cost:
    Z, H, Wd, C = x.shape
    Co = wb[0].shape[1] // 4
    isz = _isz(x)
    return Cost(2 * Z * H * Wd * C * 4 * Co, Z * H * Wd * C * isz + Z * 4 * H * Wd * Co * isz, 0)


# --- K6, K12: the row MLPs -------------------------------------------------------


def mlp(x, w1b1, w2b2, x2, x_transposed) -> Cost:
    Cin, N = x.shape if x_transposed else x.shape[::-1]
    H, Cout = w1b1[0].shape[1], w2b2[0].shape[1]
    Cin2 = x2.shape[1] if x2 is not None else 0
    return Cost(2 * N * ((Cin + Cin2) * H + H * Cout), N * (Cin + Cin2 + 2 * Cout) * _isz(x), N * H)


def finish(x, wb) -> Cost:
    N, L = x.shape
    Cout = wb[0].shape[1]
    return Cost(2 * N * L * Cout, N * (L + Cout) * _isz(x), N * L)


# --- K7, K8, K9, K13, K14: GraphCast's messages ------------------------------------


def round_messages(edges, SB) -> Cost:
    B, M, L = edges.shape
    return Cost(2 * B * M * L * (2 * L + 2 * SB), B * (3 * M + 2 * SB) * L * 2, B * M * L)


def m2g_tiled(uniq, bias_hw, deg) -> Cost:
    H, W, KL = bias_hw.shape
    TH, TW, U, _ = uniq.shape
    L = KL // deg
    return Cost(2 * H * W * (U * KL + deg * L * L), (H * W * (2 * KL + 2 * L) + TH * TW * U * KL) * _isz(uniq),
                H * W * deg * L)


def g2m_tiled(asrc_hw, D, U, th, tw) -> Cost:
    H, W, L = asrc_hw.shape
    TH, TW = H // th, W // tw
    return Cost(2 * H * W * D * (L * L + U * L), H * W * (D + 2) * L * 2 + TH * TW * U * L * 2, H * W * D * L)


def fixed_degree_messages(wide, deg) -> Cost:
    N, KL = wide.shape
    L = KL // deg
    return Cost(2 * N * deg * L * L, N * (2 * KL + 2 * L) * _isz(wide), N * deg * L)


def block_messages(src_rows, SB) -> Cost:
    B, M, L = src_rows.shape
    isz = _isz(src_rows)
    return Cost(2 * B * M * L * L + 2 * B * SB * M * L, 2 * B * M * L * isz + B * SB * L * isz, B * M * L)

"""Pre-norm Swin/Pangu window block (K1).

Replaces ``skyrim_tpu/ops/fused_block.py`` ``fused_swin_block_4d``
(Pallas body ``_fused_block_kernel``): on a window-padded (Z, H, W, C)
activation, LN1 → qkv → windowed multi-head attention with the earth
bias and the shift mask → proj → +residual → LN2 → GELU-tanh MLP →
+residual.  The shifted-window roll stays outside (ops/roll.py): the
block commutes with it.

Bound on this card: operations.  At Pangu stage 1 one block does
24·N·C² + 4·nWin·heads·wlen²·hd ≈ 0.53 TFLOP on ≈ 0.48 GB of inputs and
output (N = 535,680 tokens, C = 192), ≈ 0.54 ms at 989 TFLOP/s bf16.

Design: the TPU kernel keeps a whole window tile in VMEM; a Hopper
thread block has 227 KB of shared memory, less than the packed qkv of
one 144-token window at C = 384 with its scores, so the block runs as a
chain of hand-written kernels, chosen by width in ``block_path``:

- ``"ln_gemm"`` (C ≤ 512: both Pangu widths), five launches: LN1 + qkv
  GEMM + bias (``ops.gemm.ln_gemm``: csrc/gemm.cu on ``ln_gemm_kernel``
  of csrc/rowgemm.cuh, the LayerNorm computed once a row in shared memory
  in the prologue of the product that consumes it) → window attention
  (csrc/attention.cuh, the bodies of K5: scores in registers at the
  models' geometries, a shared-memory score tile for any other wlen and
  hd that fit) → proj GEMM + bias + residual (``ops.gemm.gemm``, the wgmma
  row GEMM) → LN2 + fc1 GEMM + bias + GELU (``ln_gemm``) → fc2 GEMM + bias
  + residual.
- ``"wide"`` (wider rows of whole 64-column slices: FengWu's fuser at
  C 1152, FuXi V1's trunk at C 1536), five launches in the same order,
  each product on ``ops.gemm.wide_gemm`` (``wide_gemm_kernel``): a row
  block of them does not fit shared memory, so LN1 and LN2 are applied
  slice by slice in the ring of the product that consumes them, from each
  row's statistics taken in a first pass over the row block.  Bound by the
  products' flops (K 1152-6144): both consumer warpgroups share each
  128 × 256 tile's slices, 85 flops a byte brought from L2 against the 64
  of ``gemm``'s separate 128 × 128 tiles, and the epilogue stores
  accumulator pairs without an exchange.
- ``"chain"`` (other rows wider than 512), seven launches: the
  LayerNorms run alone (csrc/fused_block.cu, the LayerNorm rows kernel)
  and each product on ``gemm``.

LN and the GEMMs are per token and run on the flat (Z·H·W, C) view; the
attention kernel reads q/k/v straight out of (Z, H, W, 3C) by index
math, so no window relayout touches memory.  qkv, the attention output,
x1 and the MLP hidden round-trip device memory (ROADMAP §2: fusing fc1
with fc2 needs more registers than a thread has).

On a CPU tensor the wrapper runs ``reference_swin_block``, the plain
PyTorch version of the same function; on a CUDA tensor it launches the
kernels or raises.  Reverse mode is JAX's ``_fused_swin_block_bwd``
(``ops/vjp.py``): the inputs are saved, and the backward differentiates
``reference_swin_block`` on them; the mask, the window and the heads get
no gradient.  On the card the replay's attention is an autograd Function
of its own where ``attention_backward_body`` takes the window: forward
the block's attention kernel (``window_attention``), backward
``window_attention_backward`` (csrc/attention_bwd.cuh: scores, softmax
and dS recomputed in f32 registers a window at a time, P and dS rounded
to bf16 only as operands of the dq, dk and dv products, dbias summed in
f32 without atomics), in place of the f32 composition's whole-stage score
tensors.  Each of its two LayerNorms is a Function of its own where
``layernorm_backward_body`` takes the rows (bf16, C % 8 == 0, C <= 1536):
forward the LayerNorm rows kernel (``layernorm``), backward
``layernorm_backward`` (csrc/fused_block.cu: one warp a row, f32 statistics
recomputed from x, dx rounded once to bf16, the scale's and bias's
gradients summed in f32 without atomics), in place of the f32
composition's elementwise passes; the four products, GELU and the
residuals stay in the plain replay.  ``fused_swin_block.launches`` counts
wrapper calls that launched the kernels, ``launches_by_shape`` the same by input shape
and ``launches_by_path`` by ``block_path``; ``layernorm.launches``,
``window_attention.launches``, ``window_attention_backward.launches`` and
``layernorm_backward.launches`` count those kernels' launches,
``window_attention_backward.launches_by_body`` the replays' attentions by
body, ``"plain"`` for a window the kernel does not take, and
``layernorm_backward.launches_by_body`` the replays' LayerNorms the same way
(``ops.gemm``'s wrappers, ``wide_gemm`` among them, count theirs).

K15, ``fused_swin_v2_block``: FuXi's Swin-V2 block (the port's own kernel
entry point; the JAX package computes this block outside Pallas), on a
window-padded (H, W, C) activation: K2 into the shifted frame → qkv + bias
→ cosine window attention (q and k L2-normalised, each head's
``exp(min(logit_scale, log 100))``, the CPB bias and the shift mask) →
proj + bias → ``x + LN1(·)`` → fc1 + bias → GELU-tanh → fc2 + bias →
``x + LN2(·)`` and back to the unshifted frame.  Residual-post-norm: each
LayerNorm is of a product's output, not of the block's input.  On the card
seven launches (eight shifted): the four products on ``wide_gemm`` without
a LayerNorm (the bias and GELU in their epilogues), the attention on
csrc/attention.cuh's bodies in their cosine variant
(``cosine_window_attention``: FuXi's windows on the register body, any
other window the general body takes on that one), each post-norm one row
pass (``post_norm_rows``, csrc/fused_block.cu) that reads the product and
the residual and writes bf16, the second rolling its rows back as it
stores.  No f32 tensor of the block's width is made; a shape the kernels
do not take raises, as K1's does.  ``reference_swin_v2_block`` is the plain
PyTorch composition of the same function, which the wrapper runs on a CPU
tensor; the kernels have no backward, and models/fuxi.py runs the
composition itself where autograd needs a gradient and for the ``int8``
collection.  ``fused_swin_v2_block.launches`` counts the calls that
launched the kernels; ``cosine_window_attention.launches`` (by body in
``launches_by_body``) and ``post_norm_rows.launches`` those kernels'
launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from skyrim_tpu_torch.ops import _build, cost
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.flash_window_attention import (
    _f32_tables,
    _stream,
    _tables,
    attention_4d,
    attention_body,
    reference_window_attention_4d,
    reference_window_attention_qkv,  # noqa: F401  (the attention-alone checks of K1 reach it here)
)
from skyrim_tpu_torch.ops.gemm import LN_GEMM_MAX_K, WIDE_LN_SLICE, _EPS, _layernorm_f32, gemm, ln_gemm, wide_gemm
from skyrim_tpu_torch.ops.roll import shift_roll
from skyrim_tpu_torch.ops.vjp import plain_only, with_plain_vjp

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reference_swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads, *,
                         attention=reference_window_attention_4d, layernorm=_layernorm_f32):
    """Plain PyTorch version of K1 (JAX ``reference_swin_block``); the
    backward replay passes its own ``attention`` and ``layernorm``."""
    dt = x.dtype
    h = layernorm(x, *ln1).to(dt)
    qkv = h @ qkv_wb[0].to(dt) + qkv_wb[1].to(dt)
    o = attention(qkv, bias, mask, window, heads).to(dt)
    x1 = x + (o @ proj_wb[0].to(dt) + proj_wb[1].to(dt))
    h2 = layernorm(x1, *ln2).to(dt)
    m = F.gelu(h2 @ mlp_wb[0].to(dt) + mlp_wb[1].to(dt), approximate="tanh")
    return x1 + m @ mlp_wb[2].to(dt) + mlp_wb[3].to(dt)


def _lib():
    lib = _build.load("fused_block")
    lib.skt_layernorm_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _F, _P]
    lib.skt_layernorm_bf16.restype = _I
    lib.skt_window_attention_bf16.argtypes = [_P] * 4 + [_I] * 10 + [_F, _I, _P]
    lib.skt_window_attention_bf16.restype = _I
    lib.skt_window_attention_backward_bf16.argtypes = [_P] * 6 + [_I] * 11 + [_F, _P]
    lib.skt_window_attention_backward_bf16.restype = _I
    lib.skt_layernorm_backward_blocks.argtypes = [_I, _I]
    lib.skt_layernorm_backward_blocks.restype = _I
    lib.skt_layernorm_backward_bf16.argtypes = [_P] * 5 + [_I] * 3 + [_F, _P]
    lib.skt_layernorm_backward_bf16.restype = _I
    lib.skt_cosine_window_attention_bf16.argtypes = [_P] * 4 + [_I] * 10 + [_F, _I, _P, _P]
    lib.skt_cosine_window_attention_bf16.restype = _I
    lib.skt_post_norm_rows_bf16.argtypes = [_P] * 5 + [_I] * 5 + [_F, _P]
    lib.skt_post_norm_rows_bf16.restype = _I
    return lib


def _f32(t):
    return t.detach().to(torch.float32).contiguous()


def _bf16(t):
    return t.detach().to(torch.bfloat16).contiguous()


def layernorm(x2d, scale, bias):
    """Row LayerNorm of a contiguous bf16 (rows, C) CUDA tensor → bf16."""
    rows, C = x2d.shape
    if C % 8:
        raise ValueError(f"layernorm needs C divisible by 8, got {C}")
    out = torch.empty_like(x2d)
    lib = _lib()
    err = lib.skt_layernorm_bf16(
        x2d.data_ptr(), _f32(scale).data_ptr(), _f32(bias).data_ptr(), out.data_ptr(),
        rows, C, _EPS, torch.cuda.current_stream(x2d.device).cuda_stream,
    )
    _build.check(lib, err, "layernorm")
    layernorm.launches += 1
    return out


layernorm.launches = 0


def window_attention(qkv, bias, mask, window, heads):
    """K1's windowed MHA of a contiguous bf16 (Z, H, W, 3C) CUDA tensor →
    (Z, H, W, C): the kernel of ``ops/flash_window_attention.py``'s K5, built
    into this block's library.

    ``bias`` (n_types, heads, wlen, wlen) with n_types 1 or nz·nh, or 3-D;
    ``mask`` (nz, nh, wlen, wlen) or None."""
    lib = _lib()
    out = attention_4d(qkv, bias, mask, window, heads, lib, lib.skt_window_attention_bf16, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0

# (WLP, largest hd) of csrc/attention_bwd.cuh's instantiations: hd in (HDP - 32, HDP], a multiple of 8
_BACKWARD_SHAPES = ((144, 32), (80, 64))
#: blocks an SM the backward kernel's grid asks for before it cuts rows of windows into runs
BACKWARD_BLOCKS_PER_SM = 2


def attention_backward_body(wlen: int, hd: int) -> str:
    """The reverse of K1's attention for a (wlen, hd) window, by shape alone:
    ``"registers"`` (csrc/attention_bwd.cuh, the register body's geometries:
    Pangu's wlen 129-144 with hd <= 32, FuXi's and FengWu's wlen 65-80 with
    hd 33-64, hd a multiple of 8), else ``"plain"`` (the f32 replay of
    ``reference_window_attention_4d``)."""
    wlp = -(-wlen // 16) * 16
    ok = hd % 8 == 0 and any(wlp == w and h - 32 < hd <= h for w, h in _BACKWARD_SHAPES)
    return "registers" if ok else "plain"


def reference_window_attention_backward(qkv, bias, mask, dout, window, heads):
    """Plain version of ``window_attention_backward``: the gradients of
    ``reference_window_attention_4d(qkv, bias, mask, window, heads)`` for the
    output gradient ``dout`` in closed form, in f32 — per window and head, P =
    softmax(q kᵀ·scale + bias + mask), dS = P∘(dO vᵀ − rowsum(P∘dO vᵀ)), dq =
    dS k·scale, dk = dSᵀ q·scale, dv = Pᵀ dO, dbias the sum of dS over the
    windows of each bias type.  Returns (dqkv in qkv's dtype, dbias in
    bias's shape and dtype); the mask gets no gradient."""
    Z, H, Wd, c3 = qkv.shape
    C = c3 // 3
    hd, wlen, nw = C // heads, math.prod(window), Wd // window[2]
    scale = hd**-0.5

    def split_heads(t, n):  # (Z, H, W, n·C) → n × (nWin, heads, wlen, hd), f32
        p = W.window_partition(t.float(), window)
        return p.reshape(p.shape[0], wlen, n, heads, hd).permute(2, 0, 3, 1, 4)

    q, k, v = split_heads(qkv, 3)
    (do,) = split_heads(dout, 1)
    n_win = q.shape[0]
    b = (bias if bias.ndim == 4 else bias[None]).float()
    nt = b.shape[0]
    s = (q @ k.transpose(-1, -2)) * scale
    s = (s.reshape(nt, n_win // nt, heads, wlen, wlen) + b[:, None]).reshape(n_win, heads, wlen, wlen)
    if mask is not None:
        nz, nh = mask.shape[:2]
        s = (s.reshape(nz, nh, nw, heads, wlen, wlen) + mask.float()[:, :, None, None]).reshape(s.shape)
    p = torch.softmax(s, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    grads = torch.stack((ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do))
    dqkv = grads.permute(1, 3, 0, 2, 4).reshape(n_win, wlen, c3)
    dqkv = W.window_reverse(dqkv, window, (Z, H, Wd)).to(qkv.dtype)
    dbias = ds.reshape(nt, n_win // nt, heads, wlen, wlen).sum(1)
    return dqkv, dbias.reshape(bias.shape).to(bias.dtype)


def window_attention_backward(qkv, bias, mask, dout, window, heads):
    """The gradients of ``window_attention(qkv, bias, mask, window, heads)``
    for the output gradient ``dout``: (dqkv, bf16 like qkv; dbias, in bias's
    shape and dtype).  On a CPU tensor ``reference_window_attention_backward``;
    on a CUDA tensor one launch of csrc/attention_bwd.cuh for a window that
    ``attention_backward_body`` takes, or raises.  dbias is summed in f32 in a
    fixed order: two calls on the same inputs give the same bits."""
    if qkv.device.type == "cpu":
        return reference_window_attention_backward(qkv, bias, mask, dout, window, heads)
    what = "window_attention_backward"
    Z, H, Wd, c3 = qkv.shape
    C = c3 // 3
    wz, wh, ww = window
    nz, nh, nw = Z // wz, H // wh, Wd // ww
    wlen, hd = wz * wh * ww, C // heads
    if attention_backward_body(wlen, hd) == "plain":
        raise ValueError(f"{what}: no kernel takes wlen {wlen} with hd {hd} (attention_backward_body)")
    dout = dout.to(torch.bfloat16).contiguous()
    for t in (qkv, dout):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} takes contiguous, 16-byte aligned bf16 tensors, got {t.dtype} {tuple(t.shape)}")
    if tuple(dout.shape) != (Z, H, Wd, C) or Z % wz or H % wh or Wd % ww or C % heads:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)}, dout {tuple(dout.shape)}, window {window}, {heads} heads")
    b4, n_types, n_masks = _tables(bias, mask, nz * nh * nw, nw, heads, wlen, what)
    b32, _, mask_ptr = _f32_tables(b4, mask, qkv.device)
    # rows of windows that share a bias type and mask table, cut into runs to fill the card
    rows = nz * nh if n_types > 1 or (mask is not None and n_masks > 1) else 1
    per_row = nz * nh * nw // rows
    sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
    want = min(-(-BACKWARD_BLOCKS_PER_SM * sms // (rows * heads)), per_row)
    run = -(-per_row // want)
    runs = -(-per_row // run)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((rows, runs, heads, wlen, wlen), dtype=torch.float32, device=qkv.device)
    lib = _lib()
    err = lib.skt_window_attention_backward_bf16(
        qkv.data_ptr(), dout.data_ptr(), b32.data_ptr(), mask_ptr, dqkv.data_ptr(), part.data_ptr(),
        Z, H, Wd, C, heads, wz, wh, ww, n_types, rows, run, hd**-0.5, _stream(qkv),
    )  # fmt: skip
    _build.check(lib, err, what)
    window_attention_backward.launches += 1
    counts = window_attention_backward.launches_by_body
    counts["registers"] = counts.get("registers", 0) + 1
    if n_types == 1:
        dbias = part.sum((0, 1)) if rows * runs > 1 else part[0, 0]
    else:
        dbias = part.sum(1) if runs > 1 else part[:, 0]
    return dqkv, dbias.reshape(bias.shape).to(bias.dtype)


window_attention_backward.launches = 0
window_attention_backward.launches_by_body = {}  # "registers", or "plain" for a replay the kernel does not take


class _ReplayAttention(torch.autograd.Function):
    """K1's attention inside its backward replay on the card: forward the
    block's attention kernel, backward ``window_attention_backward``."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, window, heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.window, ctx.heads = window, heads
        return window_attention(qkv, bias, mask, window, heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_backward(qkv, bias, mask, dout, ctx.window, ctx.heads)
        return dqkv, dbias if ctx.needs_input_grad[1] else None, None, None, None


def _replay_attention(qkv, bias, mask, window, heads):
    """The attention of K1's backward replay: ``_ReplayAttention`` on a card
    where ``attention_backward_body`` takes the window, else the plain
    version (counted as ``"plain"`` on a card)."""
    if qkv.device.type != "cpu":
        if attention_backward_body(math.prod(window), qkv.shape[-1] // 3 // heads) == "registers":
            return _ReplayAttention.apply(qkv, bias, mask, window, heads)
        counts = window_attention_backward.launches_by_body
        counts["plain"] = counts.get("plain", 0) + 1
    return reference_window_attention_4d(qkv, bias, mask, window, heads)


#: the widest rows csrc/fused_block.cu's LayerNorm backward holds in a warp's registers
LAYERNORM_BACKWARD_MAX_C = 1536


def layernorm_backward_body(x) -> str:
    """The reverse of a LayerNorm of K1's replay on rows like ``x``, by what
    ``x`` shows: ``"kernel"`` (``layernorm_backward``) for a bf16 CUDA tensor
    of C % 8 == 0 and C <= ``LAYERNORM_BACKWARD_MAX_C``, else ``"plain"``
    (autograd through ``_layernorm_f32``)."""
    C = x.shape[-1]
    ok = x.device.type == "cuda" and x.dtype == torch.bfloat16 and C % 8 == 0 and 0 < C <= LAYERNORM_BACKWARD_MAX_C
    return "kernel" if ok else "plain"


def reference_layernorm_backward(x, scale, bias, dy):
    """Plain version of ``layernorm_backward``: the gradients of
    ``_layernorm_f32(x, scale, bias)`` for the output gradient ``dy`` in
    closed form, in f32 — with x̂ = (x − mean)·rstd (flax's statistics) and
    g = dy·scale, dx = rstd·(g − mean(g) − x̂·mean(g·x̂)), the last term left
    out in a row whose fast variance the clip at 0 raised; dscale = Σ dy·x̂
    and dbias = Σ dy over the rows.  Returns (dx in x's dtype, dscale in
    scale's, dbias in bias's)."""
    xf, d = x.float(), dy.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var.clamp_min(0.0) + _EPS)
    xh = (xf - mu) * inv
    g = d * scale.float()
    mgx = torch.where(var < 0, 0.0, (g * xh).mean(-1, keepdim=True))
    dx = inv * (g - g.mean(-1, keepdim=True) - xh * mgx)
    rows = tuple(range(xf.ndim - 1))
    return dx.to(x.dtype), (d * xh).sum(rows).to(scale.dtype), d.sum(rows).to(bias.dtype)


def layernorm_backward(x, scale, bias, dy):
    """The gradients of ``layernorm(x, scale, bias)`` (rows of x's last axis)
    for the output gradient ``dy``: (dx, bf16 like x; dscale; dbias, in their
    dtypes).  On a CPU tensor ``reference_layernorm_backward``; on a CUDA
    tensor one launch of csrc/fused_block.cu's LayerNorm backward where
    ``layernorm_backward_body`` takes the rows, or raises.  The scale's and
    bias's gradients are summed in f32 in a fixed order: two calls on the
    same inputs give the same bits."""
    if x.device.type == "cpu":
        return reference_layernorm_backward(x, scale, bias, dy)
    what = "layernorm_backward"
    C = x.shape[-1]
    if layernorm_backward_body(x) == "plain":
        raise ValueError(f"{what} takes bf16 rows of C % 8 == 0, C <= {LAYERNORM_BACKWARD_MAX_C}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    x2, dy2 = x.reshape(-1, C).contiguous(), dy.to(torch.bfloat16).reshape(-1, C).contiguous()
    if dy2.shape != x2.shape or x2.data_ptr() % 16 or dy2.data_ptr() % 16:
        raise ValueError(f"{what} takes 16-byte aligned x and dy of one shape, got {tuple(x.shape)}, {tuple(dy.shape)}")
    rows = x2.shape[0]
    lib = _lib()
    blocks = lib.skt_layernorm_backward_blocks(rows, C)
    if blocks <= 0:
        raise ValueError(f"{what}: no grid for {rows} rows of {C}")
    dx = torch.empty_like(x2)
    part = torch.empty((blocks, 2, C), dtype=torch.float32, device=x.device)
    err = lib.skt_layernorm_backward_bf16(x2.data_ptr(), dy2.data_ptr(), _f32(scale).data_ptr(), dx.data_ptr(),
                                          part.data_ptr(), rows, C, blocks, _EPS, _stream(x2))
    _build.check(lib, err, what)
    layernorm_backward.launches += 1
    counts = layernorm_backward.launches_by_body
    counts["kernel"] = counts.get("kernel", 0) + 1
    sums = part.sum(0) if blocks > 1 else part[0]
    return dx.view(x.shape), sums[0].to(scale.dtype), sums[1].to(bias.dtype)


layernorm_backward.launches = 0
layernorm_backward.launches_by_body = {}  # K1's replayed LayerNorms: "kernel", or "plain" for rows it does not take


class _ReplayLayerNorm(torch.autograd.Function):
    """A LayerNorm of K1's backward replay on the card: forward the
    LayerNorm rows kernel (``layernorm``), backward ``layernorm_backward``."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        ctx.save_for_backward(x, scale, bias)
        return layernorm(x.reshape(-1, x.shape[-1]).contiguous(), scale, bias).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = layernorm_backward(x, scale, bias, dy)
        need = ctx.needs_input_grad
        return dx, dscale if need[1] else None, dbias if need[2] else None


def _replay_layernorm(x, scale, bias):
    """A LayerNorm of K1's backward replay: ``_ReplayLayerNorm`` where
    ``layernorm_backward_body`` takes the rows (its backward counts
    ``"kernel"`` when it launches), else ``_layernorm_f32``, counted as
    ``"plain"``."""
    if layernorm_backward_body(x) == "kernel":
        return _ReplayLayerNorm.apply(x, scale, bias)
    counts = layernorm_backward.launches_by_body
    counts["plain"] = counts.get("plain", 0) + 1
    return _layernorm_f32(x, scale, bias)


def _replay_swin_block(*args):
    """What K1's backward differentiates: ``reference_swin_block`` with
    ``_replay_attention`` and ``_replay_layernorm``."""
    return reference_swin_block(*args, attention=_replay_attention, layernorm=_replay_layernorm)


def block_path(C: int) -> str:
    """K1's launches for rows of width C, chosen by shape before any launch:
    ``"ln_gemm"`` (five: each LayerNorm in the prologue of the product that
    consumes it) where a row block fits ``ln_gemm_kernel``'s shared memory,
    ``"wide"`` (five, on ``wide_gemm_kernel``) for wider rows of whole
    64-column slices, else ``"chain"`` (seven: the LayerNorms launched
    alone)."""
    if C <= LN_GEMM_MAX_K:
        return "ln_gemm"
    return "wide" if C % WIDE_LN_SLICE == 0 else "chain"


def fused_swin_block(
    x: torch.Tensor,  # (Z, H, W, C) window-padded activation (pre-rolled if shifted)
    ln1,  # LayerNorm_0 (scale, bias), (C,)
    qkv_wb,  # ((C, 3C), (3C,))
    bias: torch.Tensor,  # (n_types, heads, wlen, wlen) or (heads, wlen, wlen)
    mask: torch.Tensor | None,  # (nz, nh, wlen, wlen) or None
    proj_wb,  # ((C, C), (C,))
    ln2,  # LayerNorm_1 (scale, bias)
    mlp_wb,  # (W1 (C, hidden), b1, W2 (hidden, C), b2)
    window: tuple[int, int, int],
    heads: int,
) -> torch.Tensor:
    """Whole pre-norm window-attention block; returns (Z, H, W, C) in x's dtype."""
    with cost.kernel("K1", cost.swin_block, x, qkv_wb, mlp_wb, window, heads):
        return with_plain_vjp(_swin_block, reference_swin_block, x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb,
                              window, heads, replay=_replay_swin_block)


def _swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads):
    if x.device.type == "cpu":
        return reference_swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads)
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"fused_swin_block takes a contiguous bf16 (Z, H, W, C) tensor, got {x.dtype} {tuple(x.shape)}")
    Z, H, Wd, C = x.shape
    N = Z * H * Wd
    xf = x.view(N, C)
    path = block_path(C)
    product = wide_gemm if path == "wide" else gemm

    def ln_product(h, ln, wb, gelu=False):  # LN, then the product that consumes it
        if path == "ln_gemm":
            return ln_gemm(h, ln, _bf16(wb[0]), _f32(wb[1]), gelu=gelu)
        if path == "wide":
            return wide_gemm(h, _bf16(wb[0]), _f32(wb[1]), ln=ln, gelu=gelu)
        return gemm(layernorm(h, *ln), _bf16(wb[0]), _f32(wb[1]), gelu=gelu)

    qkv = ln_product(xf, ln1, qkv_wb)
    o = window_attention(qkv.view(Z, H, Wd, 3 * C), bias, mask, window, heads)
    x1 = product(o.view(N, C), _bf16(proj_wb[0]), _f32(proj_wb[1]), residual=xf)
    m = ln_product(x1, ln2, mlp_wb[:2], gelu=True)
    out = product(m, _bf16(mlp_wb[2]), _f32(mlp_wb[3]), residual=x1)
    fused_swin_block.launches += 1
    for counts, key in ((fused_swin_block.launches_by_shape, x.shape), (fused_swin_block.launches_by_path, path)):
        counts[key] = counts.get(key, 0) + 1
    return out.view(Z, H, Wd, C)


fused_swin_block.launches = 0
fused_swin_block.launches_by_shape = {}  # Pangu runs two block widths
fused_swin_block.launches_by_path = {}  # block_path's choice


# --- K15: the Swin-V2 block (FuXi) ------------------------------------------------


def _dense_wb(h, wb):
    """``h @ kernel + bias`` in h's dtype, as flax's Dense computes it (bias
    optional)."""
    y = h @ wb[0].to(h.dtype)
    return y if wb[1] is None else y + wb[1].to(h.dtype)


def _unit_rows(t):
    """Rows of t scaled to unit L2 norm in t's dtype: the squares in t's dtype
    summed in f32, ``rsqrt(sum + 1e-12)`` rounded to t's dtype."""
    return t * torch.rsqrt((t * t).float().sum(-1, keepdim=True) + 1e-12).to(t.dtype)


def reference_cosine_attention(parts, bias, scale, mask, heads):
    """Plain version of K15's cosine window attention on partitioned packed
    rows (n_win, wlen, 3C) → (n_win, wlen, C), numerics as the JAX block's:
    q and k normalised (``_unit_rows``), f32 scores times each head's
    ``scale`` plus ``bias`` and the mask (nz, nh, wlen, wlen), f32 softmax,
    the probabilities in the rows' dtype, f32 accumulation of AV."""
    n_win, wlen, c3 = parts.shape
    dt, hd = parts.dtype, c3 // 3 // heads
    q, k, v = parts.view(n_win, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    attn = (_unit_rows(q).float() @ _unit_rows(k).float().transpose(-1, -2)) * scale.reshape(heads, 1, 1) + bias
    if mask is not None:
        nz, nh = mask.shape[:2]
        attn = (attn.view(nz, nh, -1, heads, wlen, wlen) + mask[:, :, None, None]).view(n_win, heads, wlen, wlen)
    probs = torch.softmax(attn, dim=-1).to(dt)
    return (probs.float() @ v.float()).to(dt).transpose(1, 2).reshape(n_win, wlen, c3 // 3)


def reference_swin_v2_block(x, qkv_wb, bias, scale, mask, proj_wb, norm1, mlp_wb, norm2, window, heads, shift, *,
                            dense=_dense_wb):
    """Plain PyTorch version of K15 on x (H, W, C): ``reference_cosine_attention``
    between the products, residual-post-norm with f32 LayerNorm statistics.
    ``dense(h, wb)`` computes a product (an int8 collection passes its own)."""
    H, Wd, C = x.shape
    win3, shift3 = (1, *window), (0, *shift)
    dt = x.dtype
    parts = W.window_partition(shift_roll(x[None], shift3, forward=True), win3)
    out = reference_cosine_attention(dense(parts, qkv_wb), bias, scale, mask, heads)
    out = shift_roll(dense(W.window_reverse(out, win3, (1, H, Wd)), proj_wb), shift3, forward=False)[0]
    x = x + _layernorm_f32(out, *norm1).to(dt)
    m = dense(F.gelu(dense(x, mlp_wb[:2]), approximate="tanh"), mlp_wb[2:])
    return x + _layernorm_f32(m, *norm2).to(dt)


def cosine_window_attention(qkv, bias, scale, mask, window, heads):
    """K15's cosine window attention of a contiguous bf16 (Z, H, W, 3C) CUDA
    tensor → (Z, H, W, C): ``softmax(q̂ k̂ᵀ·scale[head] + bias + mask) v`` with
    q̂, k̂ the rows normalised as ``_unit_rows`` does (plain version
    ``reference_cosine_attention`` on the partitioned rows); ``bias`` (heads, wlen,
    wlen) or (n_types, heads, wlen, wlen) f32, ``scale`` (heads,) f32,
    ``mask`` (nz, nh, wlen, wlen) or None.  The body is K1's choice by shape
    (``attention_body``); a window that no body takes raises."""
    heads_scale = scale.detach().to(torch.float32).reshape(heads).contiguous()
    lib = _lib()
    out = attention_4d(qkv, bias, mask, window, heads, lib,
                       lambda *a: lib.skt_cosine_window_attention_bf16(*a, heads_scale.data_ptr()),
                       "cosine_window_attention")  # fmt: skip
    cosine_window_attention.launches += 1
    body = attention_body(math.prod(window), qkv.shape[-1] // 3 // heads)
    counts = cosine_window_attention.launches_by_body
    counts[body] = counts.get(body, 0) + 1
    return out


cosine_window_attention.launches = 0
cosine_window_attention.launches_by_body = {}  # "registers" (FuXi's windows) or "shared"


def post_norm_rows(y, ln, res, roll=(0, 0), out=None):
    """``res + LN(y)`` of contiguous bf16 (H, W, C) CUDA tensors, each row's
    LayerNorm rounded to bf16 before the add (f32 statistics, eps 1e-6), the
    row of (h, w) stored at ((h + roll[0]) % H, (w + roll[1]) % W); into
    ``out`` (y itself will do where nothing rolls) or a new tensor."""
    H, Wd, C = y.shape
    if C % 8 or any(t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16 for t in (y, res)):
        raise ValueError(f"post_norm_rows takes contiguous, 16-byte aligned bf16 rows of C % 8 == 0, got {tuple(y.shape)}")
    s1, s2 = roll[0] % H, roll[1] % Wd
    if out is None or ((s1 or s2) and out.data_ptr() in (y.data_ptr(), res.data_ptr())):
        out = torch.empty_like(y)
    scale, shift = _f32(ln[0]), _f32(ln[1])
    lib = _lib()
    err = lib.skt_post_norm_rows_bf16(y.data_ptr(), scale.data_ptr(), shift.data_ptr(), res.data_ptr(), out.data_ptr(),
                                      H, Wd, C, s1, s2, _EPS, _stream(y))
    _build.check(lib, err, "post_norm_rows")
    post_norm_rows.launches += 1
    return out


post_norm_rows.launches = 0


def fused_swin_v2_block(
    x: torch.Tensor,  # (H, W, C) window-padded activation, in the unshifted frame
    qkv_wb,  # ((C, 3C), (3C,))
    bias: torch.Tensor,  # (heads, wlen, wlen) f32: 16·sigmoid(CPB MLP)
    scale: torch.Tensor,  # (heads,) or (heads, 1, 1): exp(min(logit_scale, log 100))
    mask: torch.Tensor | None,  # (1, nh, wlen, wlen) or None
    proj_wb,  # ((C, C), (C,))
    norm1,  # (scale, bias), (C,)
    mlp_wb,  # (W1 (C, hidden), b1, W2 (hidden, C), b2)
    norm2,
    window: tuple[int, int],
    heads: int,
    shift: tuple[int, int],  # (0, 0) for an unshifted block
) -> torch.Tensor:
    """Whole Swin-V2 block (K15); returns (H, W, C) in x's dtype.  No
    backward: raises where autograd would need one."""
    args = (x, qkv_wb, bias, scale, mask, proj_wb, norm1, mlp_wb, norm2, window, heads, shift)
    with cost.kernel("K15", cost.swin_v2_block, x, qkv_wb, mlp_wb, window, heads):
        if plain_only(x):
            return reference_swin_v2_block(*args)
        tensors = (x, *qkv_wb, bias, scale, *proj_wb, *norm1, *mlp_wb, *norm2)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
            raise NotImplementedError(
                "fused_swin_v2_block has no backward; under autograd models/fuxi.py runs reference_swin_v2_block"
            )
        return _swin_v2_block(*args)


def _swin_v2_block(x, qkv_wb, bias, scale, mask, proj_wb, norm1, mlp_wb, norm2, window, heads, shift):
    if x.dtype != torch.bfloat16 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"fused_swin_v2_block takes a contiguous bf16 (H, W, C) tensor, got {x.dtype} {tuple(x.shape)}")
    H, Wd, C = x.shape
    N = H * Wd
    xs = shift_roll(x[None], (0, *shift), forward=True)[0]
    qkv = wide_gemm(xs.view(N, C), _bf16(qkv_wb[0]), _f32(qkv_wb[1]))
    o = cosine_window_attention(qkv.view(1, H, Wd, 3 * C), bias, scale, mask, (1, *window), heads)
    y = wide_gemm(o.view(N, C), _bf16(proj_wb[0]), _f32(proj_wb[1])).view(H, Wd, C)
    x1 = post_norm_rows(y, norm1, xs, out=y)
    m = wide_gemm(x1.view(N, C), _bf16(mlp_wb[0]), _f32(mlp_wb[1]), gelu=True)
    y2 = wide_gemm(m, _bf16(mlp_wb[2]), _f32(mlp_wb[3])).view(H, Wd, C)
    out = post_norm_rows(y2, norm2, x1, roll=shift, out=y2)
    fused_swin_v2_block.launches += 1
    return out


fused_swin_v2_block.launches = 0

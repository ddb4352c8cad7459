"""Hand-written bf16 GEMMs with fused epilogues (csrc/gemm.cu).

The matrix products inside K1 (ops/fused_block.py) run through
``gemm``: ``epilogue(a @ w + b)`` with
``a`` (M, K) bf16, ``w`` the Dense kernel (K, N) bf16 in flax layout,
``b`` (N,) f32 and f32 accumulation.  Epilogues: none, GELU (tanh
approximation, on the bf16-rounded value) or a residual add (after the
bf16 rounding of the product, as the reference adds two bf16 tensors).

``ln_gemm`` is ``gemm`` with a LayerNorm of ``a``'s rows in its prologue,
``epilogue(bf16(LN(a)) @ w + b)`` for rows of K ≤ 512 (K1's LN1 + qkv and
LN2 + fc1 + GELU): one launch of ``ln_gemm_kernel``, which normalises each
row block once in shared memory and multiplies it by every column tile.
The LayerNorm is flax's (``_layernorm_f32``: f32 statistics, fast variance
clipped at 0, eps 1e-6, f32 affine), rounded to bf16 before the product,
as the chain of a LayerNorm launch and ``gemm`` rounds it.

``wide_gemm`` is the row GEMM for long rows (K1's four products at
C > 512: FengWu's 1152, FuXi V1's 1536), one launch of
``wide_gemm_kernel``: both consumer warpgroups on one 128 × 256 tile
(128 × 192 where that divides N and 256 does not), and with ``ln`` the
LayerNorm applied to each 64-column slice of the rows in shared memory
from statistics of a first pass over the row block (K % 64 == 0), the
product taking bf16(LN(a)) as ``ln_gemm`` does.

On a CPU tensor ``gemm``, ``ln_gemm`` and ``wide_gemm`` run ``plain_gemm``
and ``plain_ln_gemm``; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from skyrim_tpu_torch.ops import _build

_EPI_BIAS, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_EPS = 1e-6
LN_GEMM_MAX_K = 512  # the widest rows ln_gemm_kernel normalises in shared memory
WIDE_LN_SLICE = 64  # wide_gemm normalises rows in slices of 64 columns: K a multiple of it
_CUDA_ERROR_INVALID_VALUE = 1
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _layernorm_f32(t, scale, bias):
    """flax LayerNorm numerics: f32 stats, fast variance, eps 1e-6."""
    tf = t.float()
    mu = tf.mean(-1, keepdim=True)
    var = ((tf * tf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    h = (tf - mu) * torch.rsqrt(var + _EPS)
    return h * scale.float() + bias.float()


def plain_gemm(a, w, b, *, gelu: bool = False, residual=None):
    """Plain PyTorch version of the kernel's arithmetic (f32 product)."""
    dt = a.dtype
    y = (a.float() @ w.float() + b.float()).to(dt)
    if gelu:
        return F.gelu(y.float(), approximate="tanh").to(dt)
    if residual is not None:
        return (y.float() + residual.float()).to(dt)
    return y


def plain_ln_gemm(x, ln, w, b, *, gelu: bool = False):
    """Plain PyTorch version of ``ln_gemm``: the LayerNorm rounded to x's
    dtype, then ``plain_gemm``."""
    return plain_gemm(_layernorm_f32(x, *ln).to(x.dtype), w, b, gelu=gelu)


def _lib():
    lib = _build.load("gemm")
    lib.skt_gemm_bf16.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.skt_gemm_bf16.restype = _I
    lib.skt_ln_gemm_bf16.argtypes = [_P] * 6 + [_I] * 4 + [_F, _P]
    lib.skt_ln_gemm_bf16.restype = _I
    lib.skt_wide_gemm_bf16.argtypes = [_P] * 7 + [_I] * 4 + [_F, _I, _P]
    lib.skt_wide_gemm_bf16.restype = _I
    return lib


def gemm(a, w, b, *, gelu: bool = False, residual=None):
    if a.device.type == "cpu":
        return plain_gemm(a, w, b, gelu=gelu, residual=residual)
    M, K = a.shape
    N = w.shape[1]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemm takes bf16 operands, got {a.dtype} @ {w.dtype}")
    if b.dtype != torch.float32 or b.shape != (N,) or w.shape[0] != K:
        raise ValueError(f"gemm shapes: a {tuple(a.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} {b.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"gemm needs K and N divisible by 8, got K={K} N={N}")
    if not (a.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm operands must be contiguous")
    if residual is not None and (
        residual.shape != (M, N) or residual.dtype != torch.bfloat16 or not residual.is_contiguous()
    ):
        raise ValueError("gemm residual must be a contiguous bf16 (M, N) tensor")
    if gelu and residual is not None:
        raise ValueError("gemm takes one epilogue")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    epi = _EPI_GELU if gelu else _EPI_RESIDUAL if residual is not None else _EPI_BIAS
    lib = _lib()
    err = lib.skt_gemm_bf16(
        a.data_ptr(), w.data_ptr(), b.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), M, N, K, epi, torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(lib, err, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0


def ln_gemm(x, ln, w, b, *, gelu: bool = False):
    """``epilogue(bf16(LN(x)) @ w + b)``: x (M, K) bf16 rows with K ≤ 512,
    ``ln`` the LayerNorm's (scale, bias) (K,), w (K, N) bf16, b (N,) f32;
    the bias epilogue or GELU."""
    if x.device.type == "cpu":
        return plain_ln_gemm(x, ln, w, b, gelu=gelu)
    M, K = x.shape
    N = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"ln_gemm takes bf16 operands, got {x.dtype} @ {w.dtype}")
    if b.dtype != torch.float32 or b.shape != (N,) or w.shape[0] != K:
        raise ValueError(f"ln_gemm shapes: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} {b.dtype}")
    if K % 8 or N % 8 or K > LN_GEMM_MAX_K:
        raise ValueError(f"ln_gemm needs K and N divisible by 8 and K <= {LN_GEMM_MAX_K}, got K={K} N={N}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("ln_gemm operands must be contiguous")
    scale, shift = (t.detach().to(torch.float32).contiguous() for t in ln)
    if scale.shape != (K,) or shift.shape != (K,):
        raise ValueError(f"ln_gemm's LayerNorm takes ({K},) scale and bias, got {tuple(scale.shape)}, {tuple(shift.shape)}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_ln_gemm_bf16(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        M, N, K, int(gelu), _EPS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"ln_gemm_kernel refused x {tuple(x.shape)} @ w {tuple(w.shape)} (alignment or shape)")
    _build.check(lib, err, "ln_gemm")
    ln_gemm.launches += 1
    return out


ln_gemm.launches = 0


def wide_gemm(a, w, b, *, ln=None, gelu: bool = False, residual=None):
    """``epilogue(a @ w + b)``, or ``epilogue(bf16(LN(a)) @ w + b)`` with
    ``ln`` the LayerNorm's (scale, bias), each (K,): a (M, K) bf16, w (K, N)
    bf16, b (N,) f32; the bias epilogue, GELU, or (without ``ln``) the
    residual add.  K1's products at C > 512, on ``wide_gemm_kernel``."""
    if a.device.type == "cpu":
        if ln is not None:
            return plain_ln_gemm(a, ln, w, b, gelu=gelu)
        return plain_gemm(a, w, b, gelu=gelu, residual=residual)
    M, K = a.shape
    N = w.shape[1]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"wide_gemm takes bf16 operands, got {a.dtype} @ {w.dtype}")
    if b.dtype != torch.float32 or b.shape != (N,) or w.shape[0] != K:
        raise ValueError(f"wide_gemm shapes: a {tuple(a.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} {b.dtype}")
    if K % 8 or N % 8 or (ln is not None and K % WIDE_LN_SLICE):
        raise ValueError(f"wide_gemm needs K and N divisible by 8 (K by {WIDE_LN_SLICE} with ln), got K={K} N={N}")
    if not (a.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("wide_gemm operands must be contiguous")
    if residual is not None and (
        residual.shape != (M, N) or residual.dtype != torch.bfloat16 or not residual.is_contiguous()
    ):
        raise ValueError("wide_gemm residual must be a contiguous bf16 (M, N) tensor")
    if residual is not None and (gelu or ln is not None):
        raise ValueError("wide_gemm takes one epilogue, and the residual without ln")
    scale = shift = None
    if ln is not None:
        # 16-byte aligned (the kernel reads them four floats at a time): a
        # view that starts elsewhere is copied
        scale, shift = (t.detach().to(torch.float32).contiguous() for t in ln)
        scale, shift = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (scale, shift))
        if scale.shape != (K,) or shift.shape != (K,):
            raise ValueError(f"wide_gemm's LayerNorm takes ({K},) scale and bias, got {tuple(scale.shape)}, {tuple(shift.shape)}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    epi = _EPI_GELU if gelu else _EPI_RESIDUAL if residual is not None else _EPI_BIAS
    lib = _lib()
    err = lib.skt_wide_gemm_bf16(
        a.data_ptr(), None if scale is None else scale.data_ptr(), None if shift is None else shift.data_ptr(),
        w.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
        M, N, K, epi, _EPS, 0, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"wide_gemm_kernel refused a {tuple(a.shape)} @ w {tuple(w.shape)} (alignment or shape)")
    _build.check(lib, err, "wide_gemm")
    wide_gemm.launches += 1
    return out


wide_gemm.launches = 0

"""Hand-written bf16 GEMM with a fused epilogue (csrc/gemm.cu).

The matrix products inside K1 (ops/fused_block.py), K3 and K4
(ops/resample.py) run through ``gemm``: ``epilogue(a @ w + b)`` with
``a`` (M, K) bf16, ``w`` the Dense kernel (K, N) bf16 in flax layout,
``b`` (N,) f32 and f32 accumulation.  Epilogues: none, GELU (tanh
approximation, on the bf16-rounded value) or a residual add (after the
bf16 rounding of the product, as the reference adds two bf16 tensors).

On a CPU tensor ``gemm`` runs ``plain_gemm``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from skyrim_tpu_torch.ops import _build

_EPI_BIAS, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_P, _I = ctypes.c_void_p, ctypes.c_int


def plain_gemm(a, w, b, *, gelu: bool = False, residual=None):
    """Plain PyTorch version of the kernel's arithmetic (f32 product)."""
    dt = a.dtype
    y = (a.float() @ w.float() + b.float()).to(dt)
    if gelu:
        return F.gelu(y.float(), approximate="tanh").to(dt)
    if residual is not None:
        return (y.float() + residual.float()).to(dt)
    return y


def _lib():
    lib = _build.load("gemm")
    lib.skt_gemm_bf16.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.skt_gemm_bf16.restype = _I
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

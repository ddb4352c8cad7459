"""Patch merging (K3) and patch expansion (K4) for Pangu's stage changes.

K3 replaces ``skyrim_tpu/ops/resample.py`` ``fused_downsample`` (Pallas
body ``_down_kernel``): 2×2 merge (Z, H, W, C) → (Z, ⌈H/2⌉, W/2, 4C) →
LayerNorm over 4C → Dense to N.  K4 replaces ``fused_upsample``
(``_up_kernel``): Dense to 4Co → 2×2 expand to (Z, 2H, 2W, Co) →
LayerNorm per Co group.  Each is one launch of csrc/resample.cu's
``resample_kernel``: the weights of a column block resident in shared
memory, row tiles along a line of pixels brought by TMA, the LayerNorm in
the epilogue, the output stored by TMA.  The 2×2 merge and interleave are
the tensor maps' strides, not passes; K3 reads an odd H (the missing row
as zeros) and a strided view (the stage's cropped buffer) in place.

K3 runs the TPU kernel's algebraic split of LayerNorm + Dense:
``out = inv·(v @ W′) − inv·μ·sw + ct`` with ``W′ = bf16(diag(s)·W)``, ``sw``
the f32 column sums of ``W′`` and ``ct = b_ln @ W + b``, which depend on
the parameters alone: ``prepare_downsample`` computes them once (Pangu
keeps them with its grand weights).

Bound on this card: bytes, narrowly.  At Pangu width each moves ≈ 0.30 GB
of input and output (≈ 0.09 ms at 3.35 TB/s) for 0.077 TFLOP of products
(≈ 0.08 ms at 989 TFLOP/s bf16).

On CPU tensors the wrappers run the plain PyTorch versions
``reference_downsample`` (after the zero pad of an odd H) and
``reference_upsample``; on CUDA tensors they launch the kernel or raise.
Reverse mode is JAX's ``_down_bwd``/``_up_bwd`` (``ops/vjp.py``): each is
a Function over the raw ``(ln, wb)`` whose backward differentiates the
plain version on the saved inputs (K3's cropped view as it is); the
``prepared`` operands get no gradient, and without them the forward
computes them itself.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from skyrim_tpu_torch.ops import _build
from skyrim_tpu_torch.ops.fused_block import _EPS, _bf16, _f32, _layernorm_f32
from skyrim_tpu_torch.ops.vjp import with_plain_vjp

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
DOWN_MAX_C, DOWN_BN, UP_MAX_C, UP_MAX_CO = 192, 128, 384, 192  # the kernel's limits (csrc/resample.cu)


def reference_downsample(x, ln, wb):
    """2×2 merge → LN → Dense (input already padded to even H)."""
    Z, H, Wd, C = x.shape
    v = x.reshape(Z, H // 2, 2, Wd // 2, 2, C)
    v = v.permute(0, 1, 3, 2, 4, 5).reshape(Z, H // 2, Wd // 2, 4 * C)
    h = _layernorm_f32(v, *ln).to(x.dtype)
    return h @ wb[0].to(x.dtype) + wb[1].to(x.dtype)


def reference_upsample(x, wb, ln):
    """Dense(4Co) → 2×2 expand → LN (without the caller's row crop)."""
    Z, H, Wd, C = x.shape
    Co = wb[0].shape[1] // 4
    m = x @ wb[0].to(x.dtype) + wb[1].to(x.dtype)
    m = m.reshape(Z, H, Wd, 2, 2, Co).permute(0, 1, 3, 2, 4, 5)
    m = m.reshape(Z, 2 * H, 2 * Wd, Co)
    return _layernorm_f32(m, *ln).to(x.dtype)


def pad_even_h(x):
    """Zero-pad H to even, as Pangu's DownSample does before the merge."""
    return F.pad(x, (0, 0, 0, 0, 0, 1)) if x.shape[1] % 2 else x


def prepare_downsample(ln, wb):
    """K3's parameter-only terms: ``(wt, sw, ct)``.  ``wt`` is W′ᵀ (N, 4·Cp)
    bf16, W′ = bf16(s ∘ W), in the kernel's K order: slice k (64 columns)
    holds channels 64·(k // 4) .. of parity slab k % 4 (Cp = C rounded up to
    64, zeros past C); ``sw`` (N,) the f32 column sums of W′ (so that the
    mean cancels on the weights the product uses); ``ct = b_ln @ W + b``
    (N,) f32."""
    (s, b_ln), (W, b) = ln, wb
    K, N = W.shape
    C, cp = K // 4, -(-(K // 4) // 64) * 64
    wq = (s.float()[:, None] * W.float()).to(torch.bfloat16)
    sw = wq.double().sum(0).float()
    ct = (b_ln.double() @ W.double() + b.double()).float()
    wt = torch.zeros(N, 4, cp, dtype=torch.bfloat16, device=W.device)
    wt[:, :, :C] = wq.T.reshape(N, 4, C)
    wt = wt.reshape(N, 4, cp // 64, 64).transpose(1, 2)  # (N, chunk, slab, 64)
    return wt.reshape(N, 4 * cp).contiguous(), sw, ct


def prepare_upsample(wb, ln):
    """K4's operands in the kernel's types: ``(w bf16 (C, 4Co), b, scale,
    shift)``, the last three f32."""
    return _bf16(wb[0]), _f32(wb[1]), _f32(ln[0]), _f32(ln[1])


def _lib():
    lib = _build.load("resample")
    lib.skt_downsample_bf16.argtypes = [_P, _L, _L, _L] + [_I] * 4 + [_P] * 4 + [_I, _F, _P]
    lib.skt_upsample_bf16.argtypes = [_P, _L, _L, _L] + [_I] * 4 + [_P] * 5 + [_I, _F, _P]
    lib.skt_downsample_bf16.restype = lib.skt_upsample_bf16.restype = _I
    return lib


def _check_input(x, name):
    """A bf16 (Z, H, W, C) tensor whose channels are contiguous: rows are
    read by TMA at any strides of 16 bytes' multiples."""
    if x.dtype != torch.bfloat16 or x.ndim != 4 or x.stride(3) != 1:
        raise ValueError(f"{name} takes a bf16 (Z, H, W, C) tensor with contiguous channels, "
                         f"got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if x.shape[-1] % 8 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs C and the strides divisible by 8 and a 16-byte aligned base, "
                         f"got C {x.shape[-1]}, strides {x.stride()}")


def fused_downsample(x, ln, wb, prepared=None):
    """x (Z, H, W, C), W even, any H ≥ 2 (an odd H is zero-padded), channels
    contiguous; ln over 4C; wb ((4C, N), (N,)); ``prepared`` the terms of
    ``prepare_downsample(ln, wb)`` (computed here when not given) →
    (Z, ⌈H/2⌉, W/2, N)."""
    return with_plain_vjp(_downsample, _plain_downsample, x, ln, wb, prepared)


def _plain_downsample(x, ln, wb, prepared=None):
    return reference_downsample(pad_even_h(x), ln, wb)


def _downsample(x, ln, wb, prepared=None):
    if x.device.type == "cpu":
        return _plain_downsample(x, ln, wb)
    _check_input(x, "fused_downsample")
    Z, H, Wd, C = x.shape
    N = wb[0].shape[1]
    if H < 2 or Wd % 2 or C > DOWN_MAX_C or N % 8 or (N > DOWN_BN and N % DOWN_BN):
        raise ValueError(f"fused_downsample takes H >= 2, even W, C <= {DOWN_MAX_C} and N a multiple of 8, "
                         f"at most {DOWN_BN} or a multiple of it; got H {H}, W {Wd}, C {C}, N {N}")
    wt, sw, ct = prepared if prepared is not None else prepare_downsample(ln, wb)
    out = torch.empty((Z, (H + 1) // 2, Wd // 2, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_downsample_bf16(
        x.data_ptr(), *x.stride()[:3], Z, H, Wd, C, wt.data_ptr(), sw.data_ptr(), ct.data_ptr(), out.data_ptr(),
        N, _EPS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "downsample")
    fused_downsample.launches += 1
    return out


fused_downsample.launches = 0


def fused_upsample(x, wb, ln, prepared=None):
    """x (Z, H, W, C), channels contiguous, any row strides; wb ((C, 4Co),
    (4Co,)); ln over Co; ``prepared`` = ``prepare_upsample(wb, ln)``
    (made here when not given) → (Z, 2H, 2W, Co)."""
    return with_plain_vjp(_upsample, _plain_upsample, x, wb, ln, prepared)


def _plain_upsample(x, wb, ln, prepared=None):
    return reference_upsample(x, wb, ln)


def _upsample(x, wb, ln, prepared=None):
    if x.device.type == "cpu":
        return _plain_upsample(x, wb, ln)
    _check_input(x, "fused_upsample")
    Z, H, Wd, C = x.shape
    w, b, scale, shift = prepared if prepared is not None else prepare_upsample(wb, ln)
    Co = w.shape[1] // 4
    if C > UP_MAX_C or Co % 8 or Co > UP_MAX_CO:
        raise ValueError(f"fused_upsample takes C <= {UP_MAX_C} and Co <= {UP_MAX_CO} divisible by 8, got C {C}, Co {Co}")
    out = torch.empty((Z, 2 * H, 2 * Wd, Co), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_upsample_bf16(
        x.data_ptr(), *x.stride()[:3], Z, H, Wd, C, w.data_ptr(), b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), Co, _EPS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "upsample")
    fused_upsample.launches += 1
    return out


fused_upsample.launches = 0

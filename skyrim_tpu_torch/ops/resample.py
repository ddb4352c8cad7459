"""Patch merging (K3) and patch expansion (K4) for Pangu's stage changes.

K3 replaces ``skyrim_tpu/ops/resample.py`` ``fused_downsample`` (Pallas
body ``_down_kernel``): 2×2 merge (Z, H, W, C) → (Z, H/2, W/2, 4C) →
LayerNorm over 4C → Dense to Co.  Kernels: the merge-LayerNorm of
csrc/resample.cu gathers the four parity tokens by index math and
normalizes in f32, then the GEMM of csrc/gemm.cu adds the bias.

K4 replaces ``fused_upsample`` (``_up_kernel``): Dense to 4Co → 2×2
expand to (Z, 2H, 2W, Co) → LayerNorm per Co group.  Kernels: the GEMM
with its bias epilogue, then the expand-LayerNorm of csrc/resample.cu,
which writes the interleaved (Z, 2H, 2W, Co) layout directly.

Bound on this card: bytes, narrowly.  At Pangu width each moves
≈ 0.30 GB of input and output (≈ 0.09 ms at 3.35 TB/s) for 0.077 TFLOP
of GEMM (≈ 0.08 ms at 989 TFLOP/s bf16).  The merged (or unexpanded)
rows round-trip device memory between the two launches; fusing the
LayerNorm into the GEMM's prologue/epilogue is later work.

On CPU tensors the wrappers run the plain PyTorch versions
``reference_downsample``/``reference_upsample``; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from skyrim_tpu_torch.ops import _build
from skyrim_tpu_torch.ops.fused_block import _EPS, _bf16, _f32, _layernorm_f32
from skyrim_tpu_torch.ops.gemm import gemm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def _lib():
    lib = _build.load("resample")
    args = [_P] * 4 + [_I] * 4 + [_F, _P]
    for fn in (lib.skt_merge_layernorm_bf16, lib.skt_expand_layernorm_bf16):
        fn.argtypes = args
        fn.restype = _I
    return lib


def _check_input(x, name):
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous bf16 (Z, H, W, C) tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[-1] % 8:
        raise ValueError(f"{name} needs C divisible by 8, got {x.shape[-1]}")


def fused_downsample(x, ln, wb):
    """x (Z, H, W, C), H and W even; ln over 4C; wb ((4C, Co), (Co,)) → (Z, H/2, W/2, Co)."""
    if x.device.type == "cpu":
        return reference_downsample(x, ln, wb)
    _check_input(x, "fused_downsample")
    Z, H, Wd, C = x.shape
    if H % 2 or Wd % 2:
        raise ValueError(f"fused_downsample needs even H and W, got {H}x{Wd}")
    Co = wb[0].shape[1]
    rows = Z * (H // 2) * (Wd // 2)
    merged = torch.empty((rows, 4 * C), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_merge_layernorm_bf16(
        x.data_ptr(), _f32(ln[0]).data_ptr(), _f32(ln[1]).data_ptr(), merged.data_ptr(),
        Z, H, Wd, C, _EPS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "merge_layernorm")
    out = gemm(merged, _bf16(wb[0]), _f32(wb[1]))
    fused_downsample.launches += 1
    return out.view(Z, H // 2, Wd // 2, Co)


fused_downsample.launches = 0


def fused_upsample(x, wb, ln):
    """x (Z, H, W, C); wb ((C, 4Co), (4Co,)); ln over Co → (Z, 2H, 2W, Co)."""
    if x.device.type == "cpu":
        return reference_upsample(x, wb, ln)
    _check_input(x, "fused_upsample")
    Z, H, Wd, C = x.shape
    Co = wb[0].shape[1] // 4
    if Co % 8:
        raise ValueError(f"fused_upsample needs Co divisible by 8, got {Co}")
    m = gemm(x.view(-1, C), _bf16(wb[0]), _f32(wb[1]))
    out = torch.empty((Z, 2 * H, 2 * Wd, Co), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_expand_layernorm_bf16(
        m.data_ptr(), _f32(ln[0]).data_ptr(), _f32(ln[1]).data_ptr(), out.data_ptr(),
        Z, H, Wd, Co, _EPS, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "expand_layernorm")
    fused_upsample.launches += 1
    return out


fused_upsample.launches = 0

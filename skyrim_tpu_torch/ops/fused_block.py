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
- ``"chain"`` (wider rows, FuXi's V1 trunk at C 1536: a row block of
  them does not fit shared memory), seven launches: the LayerNorms run
  alone (csrc/fused_block.cu, the LayerNorm rows kernel) and each product
  on ``gemm``.

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
no gradient.  ``fused_swin_block.launches`` counts wrapper calls
that launched the kernels, ``launches_by_shape`` the same by input shape
and ``launches_by_path`` by ``block_path``; ``layernorm.launches`` and
``window_attention.launches`` count those two kernels' launches
(``ops.gemm``'s wrappers count theirs).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from skyrim_tpu_torch.ops import _build
from skyrim_tpu_torch.ops.flash_window_attention import (
    attention_4d,
    reference_window_attention_4d,
    reference_window_attention_qkv,  # noqa: F401  (the attention-alone checks of K1 reach it here)
)
from skyrim_tpu_torch.ops.gemm import LN_GEMM_MAX_K, _EPS, _layernorm_f32, gemm, ln_gemm
from skyrim_tpu_torch.ops.vjp import with_plain_vjp

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reference_swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads):
    """Plain PyTorch version of K1 (JAX ``reference_swin_block``)."""
    dt = x.dtype
    h = _layernorm_f32(x, *ln1).to(dt)
    qkv = h @ qkv_wb[0].to(dt) + qkv_wb[1].to(dt)
    o = reference_window_attention_4d(qkv, bias, mask, window, heads).to(dt)
    x1 = x + (o @ proj_wb[0].to(dt) + proj_wb[1].to(dt))
    h2 = _layernorm_f32(x1, *ln2).to(dt)
    m = F.gelu(h2 @ mlp_wb[0].to(dt) + mlp_wb[1].to(dt), approximate="tanh")
    return x1 + m @ mlp_wb[2].to(dt) + mlp_wb[3].to(dt)


def _lib():
    lib = _build.load("fused_block")
    lib.skt_layernorm_bf16.argtypes = [_P, _P, _P, _P, _I, _I, _F, _P]
    lib.skt_layernorm_bf16.restype = _I
    lib.skt_window_attention_bf16.argtypes = [_P] * 4 + [_I] * 10 + [_F, _I, _P]
    lib.skt_window_attention_bf16.restype = _I
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


def block_path(C: int) -> str:
    """K1's launches for rows of width C: ``"ln_gemm"`` (five: each
    LayerNorm in the prologue of the product that consumes it) where a row
    block fits ``ln_gemm_kernel``'s shared memory, else ``"chain"`` (seven:
    the LayerNorms launched alone)."""
    return "ln_gemm" if C <= LN_GEMM_MAX_K else "chain"


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
    return with_plain_vjp(_swin_block, reference_swin_block, x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb,
                          window, heads)


def _swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads):
    if x.device.type == "cpu":
        return reference_swin_block(x, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads)
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"fused_swin_block takes a contiguous bf16 (Z, H, W, C) tensor, got {x.dtype} {tuple(x.shape)}")
    Z, H, Wd, C = x.shape
    N = Z * H * Wd
    xf = x.view(N, C)
    path = block_path(C)
    if path == "ln_gemm":
        qkv = ln_gemm(xf, ln1, _bf16(qkv_wb[0]), _f32(qkv_wb[1]))
    else:
        qkv = gemm(layernorm(xf, *ln1), _bf16(qkv_wb[0]), _f32(qkv_wb[1]))
    o = window_attention(qkv.view(Z, H, Wd, 3 * C), bias, mask, window, heads)
    x1 = gemm(o.view(N, C), _bf16(proj_wb[0]), _f32(proj_wb[1]), residual=xf)
    if path == "ln_gemm":
        m = ln_gemm(x1, ln2, _bf16(mlp_wb[0]), _f32(mlp_wb[1]), gelu=True)
    else:
        m = gemm(layernorm(x1, *ln2), _bf16(mlp_wb[0]), _f32(mlp_wb[1]), gelu=True)
    out = gemm(m, _bf16(mlp_wb[2]), _f32(mlp_wb[3]), residual=x1)
    fused_swin_block.launches += 1
    for counts, key in ((fused_swin_block.launches_by_shape, x.shape), (fused_swin_block.launches_by_path, path)):
        counts[key] = counts.get(key, 0) + 1
    return out.view(Z, H, Wd, C)


fused_swin_block.launches = 0
fused_swin_block.launches_by_shape = {}  # Pangu runs two block widths
fused_swin_block.launches_by_path = {}  # block_path's choice

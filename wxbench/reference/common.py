"""Shared pieces of the plain references: f32 products with TF32 off, the
fp8 control's rounding, LayerNorm and GELU as the published models use them.

Every product of a reference goes through ``ein``.  With ``quant=None`` it
is an f32 einsum; with ``quant="fp8"`` both operands are first rounded to
float8 e4m3 under one per-tensor scale (amax / 448), as an fp8 path of the
program would feed its tensor cores.  That rounding is the benchmark's
control: the nearest precision below the bf16 that the configurations
state.  Its gradient passes straight through, so the control can also be
trained.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
LN_EPS = 1e-6  # flax's LayerNorm epsilon, which the published models use


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale; the gradient passes
    straight through."""
    if t.device.type == "meta":
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def ein(eq: str, a: torch.Tensor, b: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    if quant == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    elif quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return torch.einsum(eq, a, b)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)

"""FourCastNet v1 — Adaptive Fourier Neural Operator (port of
skyrim_tpu/models/afno.py).

26 channels on the 720×1440 grid (south pole excluded), one frame, 6 h
step (Guibas et al. 2022, Pathak et al. 2022, at the JAX package's
widths): an 8×8 patch embedding to width 768 on the (90, 180) token
grid plus a learned position embedding, 12 blocks of {LayerNorm, the
spectral token mixer, residual; LayerNorm, GELU MLP (ratio 4),
residual}, a LayerNorm, a linear head and the pixel shuffle back.

The mixer: ``rfft2`` over the token grid in f32, a block-diagonal
two-layer complex MLP (8 blocks of 96, ReLU on the real and imaginary
parts apart) shared by every mode, soft shrinkage at ``sparsity``, the
optional zeroing of high latitude modes (``hard_keep_fraction``),
``irfft2`` back.  It runs ``torch.fft`` and f32 products (TF32 off),
the JAX package's CPU and reference path; its matmul DFT
(skyrim_tpu/ops/dft.py, there because XLA's FFT is slow on a TPU) is not
ported.  No kernel of the port is on this path.  Names follow the flax
tree (``net/block_3/AFNOMixer_0/w1_r``), Dense kernels are (in, out).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from skyrim_tpu_torch import channels as ch
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.models.base import (
    PrognosticModel,
    denormalize,
    init_flax_params_,
    make_norm_params,
    normalize,
)
from skyrim_tpu_torch.models.pangu import ConvParams, Dense, LayerNorm
from skyrim_tpu_torch.ops.gemm import _layernorm_f32
from skyrim_tpu_torch.ops.sht import full_f32
from skyrim_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AFNOConfig:
    lat: int = 720
    lon: int = 1440
    in_channels: int = 26
    patch: int = 8
    embed_dim: int = 768
    depth: int = 12
    num_blocks: int = 8  # block-diagonal groups of the spectral MLP
    mlp_ratio: float = 4.0
    sparsity: float = 0.01  # soft-shrink threshold λ
    hard_keep_fraction: float = 1.0

    @property
    def tokens(self) -> tuple[int, int]:
        return (self.lat // self.patch, self.lon // self.patch)


def soft_shrink(x, lam):
    return torch.sign(x) * torch.clamp_min(x.abs() - lam, 0.0)


def _layernorm(ln: LayerNorm, x):
    return _layernorm_f32(x, ln.scale, ln.bias).to(x.dtype)


class AFNOMixer(nn.Module):
    """FFT2 → block-diagonal 2-layer complex MLP → soft shrink → IFFT2."""

    def __init__(self, cfg: AFNOConfig):
        super().__init__()
        self.cfg = cfg
        nb, bs = cfg.num_blocks, cfg.embed_dim // cfg.num_blocks
        for layer in ("1", "2"):
            for part in ("r", "i"):
                self.register_parameter(f"w{layer}_{part}", nn.Parameter(torch.empty(nb, bs, bs)))
                self.register_parameter(f"b{layer}_{part}", nn.Parameter(torch.empty(nb, bs)))

    @staticmethod
    def _cmatmul(xr, xi, wr, wi, br, bi):
        yr = torch.einsum("hwnb,nbc->hwnc", xr, wr) - torch.einsum("hwnb,nbc->hwnc", xi, wi)
        yi = torch.einsum("hwnb,nbc->hwnc", xr, wi) + torch.einsum("hwnb,nbc->hwnc", xi, wr)
        return yr + br, yi + bi

    def forward(self, x):  # (Ht, Wt, D) → (Ht, Wt, D) in x's dtype
        cfg = self.cfg
        Ht, Wt = x.shape[:2]
        nb = cfg.num_blocks
        keep_h = int(Ht * cfg.hard_keep_fraction)
        with full_f32():
            X = torch.fft.rfft2(x.float(), dim=(0, 1))  # (Ht, Wf, D)
            Wf = X.shape[1]
            Xr, Xi = X.real.reshape(Ht, Wf, nb, -1), X.imag.reshape(Ht, Wf, nb, -1)
            Yr, Yi = self._cmatmul(Xr, Xi, self.w1_r, self.w1_i, self.b1_r, self.b1_i)
            Yr, Yi = torch.relu(Yr), torch.relu(Yi)
            Yr, Yi = self._cmatmul(Yr, Yi, self.w2_r, self.w2_i, self.b2_r, self.b2_i)
            Yr = soft_shrink(Yr, cfg.sparsity).reshape(Ht, Wf, -1)
            Yi = soft_shrink(Yi, cfg.sparsity).reshape(Ht, Wf, -1)
            if keep_h < Ht:  # zero the high latitude modes
                mask = torch.zeros((Ht, 1, 1), device=x.device)
                mask[: keep_h // 2] = 1
                mask[-(keep_h // 2):] = 1
                Yr, Yi = Yr * mask, Yi * mask
            y = torch.fft.irfft2(torch.complex(Yr, Yi), s=(Ht, Wt), dim=(0, 1))
        return y.to(x.dtype)


class AFNOBlock(nn.Module):
    def __init__(self, cfg: AFNOConfig):
        super().__init__()
        D = cfg.embed_dim
        hidden = int(D * cfg.mlp_ratio)
        self.LayerNorm_0 = LayerNorm(D)
        self.AFNOMixer_0 = AFNOMixer(cfg)
        self.LayerNorm_1 = LayerNorm(D)
        self.Dense_0 = Dense(D, hidden)
        self.Dense_1 = Dense(hidden, D)

    def forward(self, x):
        x = x + self.AFNOMixer_0(_layernorm(self.LayerNorm_0, x))
        h = F.gelu(self.Dense_0(_layernorm(self.LayerNorm_1, x)), approximate="tanh")
        return x + self.Dense_1(h)


class AFNONet(nn.Module):
    def __init__(self, cfg: AFNOConfig):
        super().__init__()
        self.cfg = cfg
        p, D = cfg.patch, cfg.embed_dim
        self.patch_embed = ConvParams((p, p, cfg.in_channels, D))
        self.pos_embed = nn.Parameter(torch.empty(*cfg.tokens, D))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", AFNOBlock(cfg))
        self.LayerNorm_0 = LayerNorm(D)
        self.head = Dense(D, p * p * cfg.in_channels)

    def forward(self, x):  # (C, H, W) in the compute dtype → (C, H, W)
        cfg = self.cfg
        p, C, D = cfg.patch, cfg.in_channels, cfg.embed_dim
        Ht, Wt = cfg.tokens
        dt = x.dtype
        # the stride-p convolution as one GEMM over the patches
        pt = x.permute(1, 2, 0).reshape(Ht, p, Wt, p, C).permute(0, 2, 1, 3, 4).reshape(Ht * Wt, p * p * C)
        k = self.patch_embed.kernel.reshape(p * p * C, D)
        h = (pt @ k.to(dt) + self.patch_embed.bias.to(dt)).view(Ht, Wt, D)
        h = h + self.pos_embed.to(dt)
        for i in range(cfg.depth):
            h = getattr(self, f"block_{i}")(h)
        h = self.head(_layernorm(self.LayerNorm_0, h))
        h = h.view(Ht, Wt, p, p, C).permute(0, 2, 1, 3, 4).reshape(Ht * p, Wt * p, C)
        return h.permute(2, 0, 1)


_NORMAL = {k: 0.02 for k in ("pos_embed", "w1_r", "w1_i", "b1_r", "b1_i", "w2_r", "w2_i", "b2_r", "b2_i")}


class FourCastNetModel(PrognosticModel):
    """FourCastNet v1 (AFNO) on ``device`` (the card by default)."""

    name = "fourcastnet"
    channels = ch.FCN
    n_history = 1

    def __init__(self, cfg: AFNOConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or AFNOConfig()
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon, include_south_pole=False)
        if self.cfg.in_channels != len(self.channels):
            self.channels = tuple(f"c{i:02d}" for i in range(self.cfg.in_channels))

    def new_net(self) -> AFNONet:
        return AFNONet(self.cfg)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default), flax's initialisers (the position embedding and the
        spectral weights normal(0.02))."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        return {
            "net": init_flax_params_(self.new_net(), g, normal=_NORMAL).to(self.device).eval().requires_grad_(False),
            "norm": make_norm_params(self.cfg.in_channels, device=self.device),
        }

    def apply(self, params, x):
        """``denormalize(net(normalize(x[-1])))``, in f32: no residual."""
        xn = normalize(params["norm"], x[-1]).to(self.compute_dtype)
        return denormalize(params["norm"], params["net"](xn).float())[None]

"""FourCastNet v2 — Spherical Fourier Neural Operator, fcnv2_sm (port of
skyrim_tpu/models/sfno.py).

73 channels on 721×1440, one frame of history, 6 h step (Bonev et al.
2023, the published fcnv2_sm widths):

- encoder: Dense 73→256, GELU (tanh), Dense 256→256 without bias; a
  learned position embedding at full resolution (721, 1440, 256) added
  after it;
- 12 blocks: instance norm → the spectral filter (SHT → a complex
  3-layer channel MLP shared across the (l, m) modes, ReLU on the real
  part → inverse SHT) → 1×1 inner skip → instance norm → MLP (ratio 2) →
  identity outer skip; block 0 transforms from the 721×1440 equiangular
  grid into the 120×240 Gauss grid, the last block back, and only the
  blocks between carry the skips;
- big skip: the normalised input concatenated before the decoder
  (Dense 329→256, GELU, Dense 256→73 without bias).

Module and parameter names follow the flax tree of the JAX package
(``block_3/filter/w1``, ``block_3/mlp_fc1/kernel``), Dense kernels are
(in, out).  Activations stay channel-last (H, W, C); the transforms
(ops/sht.py) and the complex MLP run in full f32, the Dense products in
the compute dtype.  No kernel of the port is on this path: the JAX
package computes all of it outside Pallas.
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
from skyrim_tpu_torch.models.pangu import Dense
from skyrim_tpu_torch.ops.sht import full_f32, get_sht
from skyrim_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SFNOConfig:
    """fcnv2_sm defaults; reduced values are used by the tests."""

    lat: int = 721
    lon: int = 1440
    in_channels: int = 73
    embed_dim: int = 256
    num_layers: int = 12
    scale_factor: int = 6  # internal Gauss grid = (lat//s, lon//s)
    spectral_layers: int = 3
    hidden_factor: int = 2  # spectral MLP hidden = factor · embed
    mlp_ratio: float = 2.0
    big_skip: bool = True
    use_pos_embed: bool = True
    hard_thresholding_fraction: float = 1.0

    @property
    def internal_grid(self) -> tuple[int, int]:
        return (self.lat // self.scale_factor, self.lon // self.scale_factor)

    @property
    def modes(self) -> tuple[int, int]:
        hi, wi = self.internal_grid
        f = self.hard_thresholding_fraction
        return (int(hi * f), int((wi // 2 + 1) * f))

    def has_skips(self, i: int) -> bool:
        """Inner/outer skips exist only where the filter preserves
        resolution (blocks 1..num_layers−2)."""
        return 0 < i < self.num_layers - 1


def instance_norm(x, scale, bias, eps: float = 1e-6):
    """Per-channel norm over (H, W) of an (H, W, C) tensor: statistics in
    f32, population variance, eps 1e-6, affine; returns x's dtype."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=(0, 1), correction=0, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class SpectralAttention(nn.Module):
    """The fcnv2_sm "non-linear" filter: SHT → complex channel MLP over the
    modes → inverse SHT.  ``w{l}`` are complex (C_l, C_{l+1}) matrices held
    as (in, out, 2) real/imaginary pairs, ``wout`` (hidden, C, 2)."""

    def __init__(self, cfg: SFNOConfig, in_grid, in_gridtype: str, out_grid, out_gridtype: str):
        super().__init__()
        C = cfg.embed_dim
        hidden = cfg.hidden_factor * C
        dims = [C] + [hidden] * cfg.spectral_layers
        self.n_layers = cfg.spectral_layers
        for l in range(cfg.spectral_layers):
            setattr(self, f"w{l}", nn.Parameter(torch.empty(dims[l], dims[l + 1], 2)))
        self.wout = nn.Parameter(torch.empty(hidden, C, 2))
        self.modes = cfg.modes
        self.in_grid, self.in_gridtype = tuple(in_grid), in_gridtype
        self.out_grid, self.out_gridtype = tuple(out_grid), out_gridtype

    def forward(self, x):  # (H, W, C) → (H', W', C) in x's dtype
        L, M = self.modes
        fwd = get_sht(*self.in_grid, L, M, grid=self.in_gridtype, device=x.device)
        inv = get_sht(*self.out_grid, L, M, grid=self.out_gridtype, device=x.device)
        C = x.shape[-1]
        z = fwd.analysis(x)  # (M, L, 2C) f32
        zr, zi = z[..., :C], z[..., C:]
        with full_f32():
            for l in range(self.n_layers):
                zr, zi = _cmatmul(zr, zi, getattr(self, f"w{l}"))
                zr = F.relu(zr)  # ComplexReLU, mode "real"
            zr, zi = _cmatmul(zr, zi, self.wout)
        return inv.synthesis(torch.cat([zr, zi], -1)).to(x.dtype)


def _cmatmul(zr, zi, w):
    """Complex product over the channel dim, as four real products."""
    wr, wi = w[..., 0], w[..., 1]
    return zr @ wr - zi @ wi, zr @ wi + zi @ wr


class SFNOBlock(nn.Module):
    """norm0 → spectral filter (+ 1×1 inner skip) → norm1 → MLP (+ identity
    outer skip); skips only where the resolution is preserved."""

    def __init__(self, cfg: SFNOConfig, index: int):
        super().__init__()
        C = cfg.embed_dim
        hi, wi = cfg.internal_grid
        first, last = index == 0, index == cfg.num_layers - 1
        self.skips = cfg.has_skips(index)
        self.norm0_scale = nn.Parameter(torch.ones(C))
        self.norm0_bias = nn.Parameter(torch.zeros(C))
        self.filter = SpectralAttention(
            cfg,
            (cfg.lat, cfg.lon) if first else (hi, wi), "equiangular" if first else "legendre-gauss",
            (cfg.lat, cfg.lon) if last else (hi, wi), "equiangular" if last else "legendre-gauss",
        )
        if self.skips:
            self.inner_skip = Dense(C, C)
        self.norm1_scale = nn.Parameter(torch.ones(C))
        self.norm1_bias = nn.Parameter(torch.zeros(C))
        self.mlp_fc1 = Dense(C, int(C * cfg.mlp_ratio))
        self.mlp_fc2 = Dense(int(C * cfg.mlp_ratio), C)

    def forward(self, x):  # (H, W, C)
        h = self.filter(instance_norm(x, self.norm0_scale, self.norm0_bias))
        if self.skips:
            h = h + self.inner_skip(x)
        m = self.mlp_fc2(F.gelu(self.mlp_fc1(instance_norm(h, self.norm1_scale, self.norm1_bias)), approximate="tanh"))
        return m + x if self.skips else m


class SFNONet(nn.Module):
    def __init__(self, cfg: SFNOConfig):
        super().__init__()
        self.cfg = cfg
        C, nc = cfg.embed_dim, cfg.in_channels
        self.encoder_fc1 = Dense(nc, C)
        self.encoder_fc2 = Dense(C, C, use_bias=False)
        if cfg.use_pos_embed:
            self.pos_embed = nn.Parameter(torch.zeros(cfg.lat, cfg.lon, C))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", SFNOBlock(cfg, i))
        self.decoder_fc1 = Dense(C + (nc if cfg.big_skip else 0), C)
        self.decoder_fc2 = Dense(C, nc, use_bias=False)

    def forward(self, x, cache: dict):
        """x (C, H, W) normalised, in the compute dtype → (C, H, W) next
        state.  ``cache["pos_embed"]``: the embedding in bf16."""
        cfg = self.cfg
        skip = x.permute(1, 2, 0).contiguous()  # (H, W, C)
        h = self.encoder_fc2(F.gelu(self.encoder_fc1(skip), approximate="tanh"))
        if cfg.use_pos_embed:
            pe = cache.get("pos_embed")
            h = h + (pe if pe is not None and pe.dtype == h.dtype else self.pos_embed.to(h.dtype))
        for i in range(cfg.num_layers):
            h = getattr(self, f"block_{i}")(h)
        if cfg.big_skip:
            h = torch.cat([h, skip], dim=-1)
        h = self.decoder_fc2(F.gelu(self.decoder_fc1(h), approximate="tanh"))
        return h.permute(2, 0, 1)


class FourCastNetV2Model(PrognosticModel):
    """fcnv2_sm on ``device`` (the card by default)."""

    name = "fourcastnet_v2"
    channels = ch.FCNV2
    n_history = 1

    def __init__(self, cfg: SFNOConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or SFNOConfig()
        if self.cfg.lat // self.cfg.scale_factor < self.cfg.modes[0]:
            raise ValueError(f"SFNO: {self.cfg.modes[0]} degrees on a {self.cfg.internal_grid} grid")
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon)
        if self.cfg.in_channels != len(self.channels):
            # reduced-channel test configurations keep a synthetic channel list
            self.channels = tuple(f"c{i:02d}" for i in range(self.cfg.in_channels))

    def new_net(self) -> SFNONet:
        return SFNONet(self.cfg)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default): flax's initialisers, the spectral weights normal(1/C²)."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        std = 1.0 / self.cfg.embed_dim**2
        normal = {f"w{l}": std for l in range(self.cfg.spectral_layers)} | {"wout": std}
        net = init_flax_params_(self.new_net(), g, normal)
        params = {
            "net": net.to(self.device).eval().requires_grad_(False),
            "norm": make_norm_params(self.cfg.in_channels, device=self.device),
        }
        return self.prepare_params(params)

    @torch.no_grad()
    def prepare_params(self, params):
        """Attach the position embedding in bf16 (the JAX package casts the
        f32 parameter on every call) under ``params["cache"]``."""
        if "cache" in params:
            return params
        params = dict(params)
        net = params["net"]
        params["cache"] = {"pos_embed": net.pos_embed.to(torch.bfloat16)} if self.cfg.use_pos_embed else {}
        return params

    def apply(self, params, x):
        """The network predicts the next normalised state directly (the
        fcnv2_sm contract; the big skip carries the identity path)."""
        xn = normalize(params["norm"], x[-1]).to(self.compute_dtype)
        y = params["net"](xn, params.get("cache", {}))
        return denormalize(params["norm"], y.float())[None]

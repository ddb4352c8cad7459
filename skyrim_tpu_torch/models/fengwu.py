"""FengWu — multi-modal transformer (port of skyrim_tpu/models/fengwu.py).

69 channels on 721×1440, two frames of history, 6 h step (Chen et al.
2023, arXiv:2304.02948, at the JAX package's widths): each variable
group (surface, then z, q, u, v, t over 13 levels) is a modality with its
own 4×4 patch encoder and decoder; a cross-modal fuser of 16 window
blocks at C 1152 (18 heads, window (6, 12), odd blocks shifted by (3, 6))
mixes the concatenated modal features on the (181, 360) token grid,
padded to 186 rows.

As on the JAX package's fused path, the six patch convolutions are one
block-diagonal GEMM over the concatenated channels and the six
transposed convolutions one recovery GEMM (their kernels flipped
spatially, flax ``ConvTranspose`` semantics); both weights are built
once in ``prepare_params``.  Those two products and ``fuse_in`` are
``torch.matmul``; the fuser runs K1 and K2 (models/fuxi.py).  Module and
parameter names follow the flax tree (``enc_0/kernel``,
``fuser_3/qkv/kernel``).
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
from skyrim_tpu_torch.models.fuxi import SwinBlock2D
from skyrim_tpu_torch.models.pangu import ConvParams, Dense
from skyrim_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FengWuConfig:
    """The JAX package's widths (one modal encoder per variable group
    feeding a cross-modal window-attention fuser); reduced values serve
    the tests."""

    lat: int = 721
    lon: int = 1440
    levels: int = 13
    surface_channels: int = 4
    level_vars: int = 5  # z, q, u, v, t
    modal_dim: int = 192
    fuser_dim: int = 1152  # 6 modalities × modal_dim
    depth: int = 16
    num_heads: int = 18  # head_dim 64
    window: tuple[int, int] = (6, 12)
    patch: int = 4

    @property
    def in_channels(self) -> int:
        return self.surface_channels + self.level_vars * self.levels

    @property
    def tokens(self) -> tuple[int, int]:
        return (-(-self.lat // self.patch), self.lon // self.patch)


class FengWuNet(nn.Module):
    def __init__(self, cfg: FengWuConfig, n_history: int = 2):
        super().__init__()
        self.cfg = cfg
        p, md, D = cfg.patch, cfg.modal_dim, cfg.fuser_dim
        self.n_in = [n_history * cfg.surface_channels] + [n_history * cfg.levels] * cfg.level_vars
        self.n_out = [cfg.surface_channels] + [cfg.levels] * cfg.level_vars
        for g, ci in enumerate(self.n_in):
            self.add_module(f"enc_{g}", ConvParams((p, p, ci, md)))
        self.fuse_in = Dense(len(self.n_in) * md, D)
        for i in range(cfg.depth):
            self.add_module(f"fuser_{i}", SwinBlock2D(D, cfg.num_heads, cfg.window, shifted=(i % 2 == 1)))
        for g, nc in enumerate(self.n_out):
            self.add_module(f"dec_{g}", ConvParams((p, p, D, nc)))

    def grand_weights(self) -> dict:
        """The patch convolutions as one block-diagonal GEMM weight
        (p·p·lanes, groups·md) and the transposed ones as one recovery
        weight (D, p·p·Cout), with their biases, in f32; autograd
        differentiates the expansion, as ``apply`` without a cache needs."""
        cfg = self.cfg
        p, md = cfg.patch, cfg.modal_dim
        lanes, cout = sum(self.n_in), sum(self.n_out)
        enc = [getattr(self, f"enc_{g}") for g in range(len(self.n_in))]
        dec = [getattr(self, f"dec_{g}") for g in range(len(self.n_out))]
        Wg = enc[0].kernel.new_zeros((p, p, lanes, len(enc) * md))
        off = 0
        for g, (e, ci) in enumerate(zip(enc, self.n_in)):
            Wg[:, :, off : off + ci, g * md : (g + 1) * md] = e.kernel
            off += ci
        Wr = dec[0].kernel.new_zeros((cfg.fuser_dim, p, p, cout))
        off = 0
        for d, nc in zip(dec, self.n_out):
            # flax ConvTranspose applies its kernel spatially flipped
            Wr[..., off : off + nc] = d.kernel.flip(0, 1).permute(2, 0, 1, 3)
            off += nc
        return {
            "Wg": Wg.reshape(p * p * lanes, len(enc) * md),
            "bias_g": torch.cat([e.bias for e in enc]),
            "Wr": Wr.reshape(cfg.fuser_dim, p * p * cout),
            "bias_r": torch.cat([d.bias for d in dec]),
        }

    def forward(self, groups, gw: dict | None = None):
        """groups: per modality (hist·Ci, H, W), normalised, in the compute
        dtype → (ΣCo, H, W), the groups' outputs concatenated.  ``gw``: the
        cached ``grand_weights()``, or None to build them here."""
        if gw is None:
            gw = self.grand_weights()
        cfg = self.cfg
        p, D, wh = cfg.patch, cfg.fuser_dim, cfg.window[0]
        Hin, Win = groups[0].shape[1:]
        Ht, Wt = -(-Hin // p), Win // p
        dt = groups[0].dtype

        x = torch.cat([g.permute(1, 2, 0) for g in groups], -1)  # (H, W, lanes)
        x = F.pad(x, (0, 0, 0, 0, 0, (-Hin) % p))
        lanes = x.shape[-1]
        pt = x.reshape(Ht, p, Wt, p, lanes).permute(0, 2, 1, 3, 4).reshape(Ht * Wt, p * p * lanes)
        h = (pt @ gw["Wg"].to(dt) + gw["bias_g"].to(dt)).reshape(Ht, Wt, -1)
        h = self.fuse_in(h)

        h = F.pad(h, (0, 0, 0, 0, 0, (-Ht) % wh)).contiguous()
        for i in range(cfg.depth):
            h = getattr(self, f"fuser_{i}")(h, Ht)
        h = h[:Ht]

        cout = sum(self.n_out)
        y = h.reshape(Ht * Wt, D) @ gw["Wr"].to(dt)
        y = y.reshape(Ht, Wt, p, p, cout) + gw["bias_r"].to(dt)
        y = y.permute(0, 2, 1, 3, 4).reshape(Ht * p, Wt * p, cout)
        return y[:Hin].permute(2, 0, 1)


class FengWuModel(PrognosticModel):
    """FengWu on ``device`` (the card by default)."""

    name = "fengwu"
    channels = ch.FENGWU
    n_history = 2
    lon_manual = True  # the lon-sharded step of parallel/fused_shard.py

    @property
    def lon_shard_divisor(self) -> int:
        return self.cfg.tokens[1]

    def __init__(self, cfg: FengWuConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or FengWuConfig()
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon)
        if self.cfg.in_channels != len(self.channels):
            self.channels = tuple(f"c{i:02d}" for i in range(self.cfg.in_channels))

    def new_net(self) -> FengWuNet:
        return FengWuNet(self.cfg, self.n_history)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default), flax's initialisers."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {
            "net": init_flax_params_(self.new_net(), g).to(self.device).eval().requires_grad_(False),
            "norm": make_norm_params(self.cfg.in_channels, device=self.device),
        }
        return self.prepare_params(params)

    @torch.no_grad()
    def prepare_params(self, params):
        """Attach the grand patch and recovery GEMM weights (pure functions
        of the conv params) under ``params["cache"]``."""
        if "cache" in params:
            return params
        params = dict(params)
        params["cache"] = {"gw": params["net"].grand_weights()}
        return params

    def _split_groups(self, x):
        """(hist, C, H, W) → per modality (hist·Ci, H, W), history-major, in
        the FENGWU channel order: the surface channels, then z, q, u, v, t
        over the levels."""
        cfg = self.cfg
        HW = x.shape[-2:]
        sizes = [cfg.surface_channels] + [cfg.levels] * cfg.level_vars
        return [g.reshape(-1, *HW) for g in torch.split(x, sizes, dim=1)]

    def apply(self, params, x):
        """The residual in normalised space, in f32:
        ``denormalize(normalize(x[-1]) + net(normalize(x)))``."""
        xn = normalize(params["norm"], x).to(self.compute_dtype)
        y = params["net"](self._split_groups(xn), params.get("cache", {}).get("gw")).float()
        return denormalize(params["norm"], normalize(params["norm"], x[-1]) + y)[None]

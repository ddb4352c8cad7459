"""Pangu-Weather — 3D Earth-Specific Transformer (port of skyrim_tpu/models/pangu.py).

69 channels = z/q/t/u/v × 13 levels + msl/u10m/v10m/t2m on 721×1440,
hierarchical 6h + 24h model pair (Bi et al., Nature 2023):
- patch embed as one GEMM: surface 4×4, upper-air 2×4×4 → tokens
  (8, 181, 360), C = 192
- encoder/decoder 2-6-6-2 blocks; middle stages at (8, 91, 180), 2C
- 3D window attention, window (2, 6, 12), shifted every other block,
  earth-specific bias (absolute in level/lat, relative in lon)
- skip concat between encoder stage 1 and the decoder output.

Module and parameter names follow the flax tree of the JAX package
(``PanguBlock_3.EarthAttention3D_0.qkv.kernel`` ↔
``PanguBlock_3/EarthAttention3D_0/qkv/kernel``), Dense kernels are
(in, out), so one checkpoint serves both packages (params.py).  Every
block runs through K1 (ops/fused_block.py) between two K2 rolls
(ops/roll.py) when shifted; ``EarthAttention3D.forward``, which no block
calls, runs attention alone through K5 (ops/flash_window_attention.py); DownSample/UpSample run K3/K4
(ops/resample.py).  The patch embed/recover products stay
``torch.matmul``.  Without ``params["cache"]`` (the finetune trainer's
tree) ``apply`` builds the grand weights inline, differentiably, and K3
and K4 prepare their operands themselves, as skyrim_tpu/models/pangu.py:520-521
does.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyrim_tpu_torch import channels as ch
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.models.base import (
    ModelState,
    PrognosticModel,
    denormalize,
    init_flax_params_,
    make_norm_params,
    normalize,
)
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.flash_window_attention import fused_window_attention_4d
from skyrim_tpu_torch.ops.fused_block import fused_swin_block
from skyrim_tpu_torch.ops.resample import fused_downsample, fused_upsample, prepare_downsample, prepare_upsample
from skyrim_tpu_torch.ops.roll import shift_roll
from skyrim_tpu_torch.parallel import fused_shard as FS
from skyrim_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PanguConfig:
    lat: int = 721
    lon: int = 1440
    levels: int = 13
    surface_channels: int = 4  # msl, u10m, v10m, t2m
    level_vars: int = 5  # z, q, t, u, v
    const_masks: int = 3  # land-sea, soil type, topography
    patch: tuple[int, int, int] = (2, 4, 4)  # (level, lat, lon)
    window: tuple[int, int, int] = (2, 6, 12)
    embed_dim: int = 192
    depths: tuple[int, ...] = (2, 6, 6, 2)
    num_heads: tuple[int, ...] = (6, 12, 12, 6)
    mlp_ratio: float = 4.0

    @property
    def z_tokens(self) -> int:
        # 13 levels → ceil(14/2)=7 upper tokens + 1 surface token row
        return -(-(self.levels + 1) // self.patch[0]) + 1

    @property
    def hw_tokens(self) -> tuple[int, int]:
        return (-(-self.lat // self.patch[1]), self.lon // self.patch[2])


# -- parameter holders with flax's names and layouts -------------------------


class Dense(nn.Module):
    """flax ``nn.Dense`` parameters: kernel (in, out), bias (out,) unless
    ``use_bias`` is false."""

    def __init__(self, din: int, dout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(din, dout))
        self.bias = nn.Parameter(torch.zeros(dout)) if use_bias else None

    def wb(self):
        return self.kernel, self.bias

    def forward(self, x):
        """flax's Dense in x's dtype: ``x @ kernel + bias``."""
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` parameters: scale, bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def sb(self):
        return self.scale, self.bias


class ConvParams(nn.Module):
    """Conv-shaped kernel + bias (flax ``nn.Conv`` layout), consumed by the
    grand patch GEMMs."""

    def __init__(self, kernel_shape: tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(kernel_shape[-1]))


class EarthAttention3D(nn.Module):
    """Window attention with the earth-specific bias: one table per (z, lat)
    window position (windows differing only in lon share it), laid out
    (n_types, heads, table) so expansion is a last-axis gather.

    ``PanguBlock`` hands these parameters to K1; ``forward`` is the module's
    own path, attention alone through K5."""

    def __init__(self, dim: int, heads: int, window, n_type_windows: int):
        super().__init__()
        self.heads = heads
        self.window = tuple(window)
        self.earth_bias = nn.Parameter(
            torch.empty(n_type_windows, heads, W.earth_bias_table_size(window))
        )
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        index = torch.from_numpy(W.earth_bias_index(tuple(window)).astype(np.int64))
        self.register_buffer("bias_index", index, persistent=False)

    def expanded_bias(self) -> torch.Tensor:
        return self.earth_bias[:, :, self.bias_index]  # (n_types, heads, wlen, wlen)

    def forward(self, x, mask):
        """x (Z, H, W, C) padded to window multiples, ``mask`` the shift mask
        or None → (Z, H, W, C): qkv Dense → K5 → proj Dense.  The two Dense
        products are plain matmuls, as in the JAX module."""
        dt = x.dtype
        qkv = x @ self.qkv.kernel.to(dt) + self.qkv.bias.to(dt)
        out = fused_window_attention_4d(qkv, self.expanded_bias(), mask, self.window, self.heads)
        return out.to(dt) @ self.proj.kernel.to(dt) + self.proj.bias.to(dt)


class PanguBlock(nn.Module):
    def __init__(self, dim, heads, window, shifted, mlp_ratio, n_type_windows):
        super().__init__()
        self.heads = heads
        self.window = tuple(window)
        self.shifted = shifted
        self.LayerNorm_0 = LayerNorm(dim)
        self.EarthAttention3D_0 = EarthAttention3D(dim, heads, window, n_type_windows)
        self.LayerNorm_1 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)

    def forward(self, x, valid):  # (Z, H, Wd, C) padded to window multiples
        Z, H, Wd, _ = x.shape
        shift = tuple(w // 2 for w in self.window) if self.shifted else (0, 0, 0)
        mask = W.mask_tensor((Z, H, Wd), self.window, shift, valid, x.device)
        attn = self.EarthAttention3D_0
        args = (self.LayerNorm_0.sb(), attn.qkv.wb(), attn.expanded_bias(), mask, attn.proj.wb(),
                self.LayerNorm_1.sb(), (*self.Dense_0.wb(), *self.Dense_1.wb()), self.window, self.heads)
        if FS.current() is not None:
            # lon-sharded: the block runs on the local chunk's window cover,
            # the lon shift folded into the cover's offsets
            return FS.manual_swin_block(x, *args, shift=shift)
        # the block commutes with the shift roll: roll in, run unshifted
        # with the shift mask, roll back
        h = fused_swin_block(shift_roll(x, shift, forward=True), *args)
        return shift_roll(h, shift, forward=False)


class DownSample(nn.Module):
    """2×2 lat-lon patch merging: (Z, H, W, C) → (Z, ⌈H/2⌉, W/2, dim_out)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * dim)
        self.Dense_0 = Dense(4 * dim, dim_out)

    def forward(self, x, prepared=None):
        """x may be the stage's cropped view with an odd H: K3 reads it in
        place, the missing row as zeros.  ``prepared``: ``prepare()``."""
        return fused_downsample(x, self.LayerNorm_0.sb(), self.Dense_0.wb(), prepared)

    def prepare(self):
        return prepare_downsample(self.LayerNorm_0.sb(), self.Dense_0.wb())


class UpSample(nn.Module):
    """Inverse patch merging: (Z, H, W, C) → (Z, out_h, 2W, dim_out)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.Dense_0 = Dense(dim, 4 * dim_out)
        self.LayerNorm_0 = LayerNorm(dim_out)

    def forward(self, x, out_h: int, prepared=None):
        """x may be the stage's cropped view: K4 reads it in place.
        ``prepared``: ``prepare()``."""
        return fused_upsample(x, self.Dense_0.wb(), self.LayerNorm_0.sb(), prepared)[:, :out_h]

    def prepare(self):
        return prepare_upsample(self.Dense_0.wb(), self.LayerNorm_0.sb())


class PanguNet(nn.Module):
    def __init__(self, cfg: PanguConfig):
        super().__init__()
        self.cfg = cfg
        pz, ph, pw = cfg.patch
        C = cfg.embed_dim
        Cs = cfg.surface_channels + cfg.const_masks
        self.embed_surface = ConvParams((ph, pw, Cs, C))
        self.embed_upper = ConvParams((pz, ph, pw, cfg.level_vars, C))
        self.recover_upper = ConvParams((pz, ph, pw, 2 * C, cfg.level_vars))
        self.recover_surface = ConvParams((ph, pw, 2 * C, cfg.surface_channels))

        wz, wh, _ = cfg.window
        Zt = cfg.z_tokens
        Ht, _ = cfg.hw_tokens
        nz = -(-Zt // wz)
        Ht2 = -(-Ht // 2)
        n_types = (nz * -(-Ht // wh), nz * -(-Ht2 // wh))  # full, half resolution
        # flax numbers the blocks in call order across stages, with
        # DownSample_0/UpSample_0 between them
        self.stages: list[list[str]] = []
        i = 0
        for s, depth in enumerate(cfg.depths):
            dim = C if s in (0, 3) else 2 * C
            names = []
            for b in range(depth):
                name = f"PanguBlock_{i}"
                self.add_module(name, PanguBlock(
                    dim, cfg.num_heads[s], cfg.window, shifted=(b % 2 == 1),
                    mlp_ratio=cfg.mlp_ratio, n_type_windows=n_types[0 if s in (0, 3) else 1],
                ))
                names.append(name)
                i += 1
            self.stages.append(names)
        self.DownSample_0 = DownSample(C, 2 * C)
        self.UpSample_0 = UpSample(2 * C, C)

    def grand_weights(self) -> dict:
        """Expand the conv-shaped patch params into the grand embed/recover
        GEMM weights, cast to bf16 (whatever the compute dtype); autograd
        differentiates the expansion, as ``apply`` without a cache needs."""
        cfg = self.cfg
        pz, ph, pw = cfg.patch
        C = cfg.embed_dim
        Zt = cfg.z_tokens
        Zu = Zt - 1
        L, Vl = cfg.levels, cfg.level_vars
        n_up = L * Vl
        Cs = cfg.surface_channels + cfg.const_masks
        lanes = n_up + Cs
        Cout = n_up + cfg.surface_channels

        # patch embedding as ONE GEMM over (ph·pw·lanes): each z-token's
        # 10 input channels (2 levels × 5 vars) are a static lane subset
        ks, bs = self.embed_surface.kernel, self.embed_surface.bias
        ku, bu = self.embed_upper.kernel, self.embed_upper.bias
        Wg = ku.new_zeros((ph, pw, lanes, Zt, C))
        for zt in range(Zu):
            for lz in range(pz):
                level = pz * zt + lz
                if level >= L:
                    continue
                lane_idx = torch.arange(Vl, device=ku.device) * L + level
                Wg[:, :, :, zt][:, :, lane_idx] = ku[lz]
        Wg[:, :, n_up:, Zu] = ks
        bias_g = torch.cat([bu[None].expand(Zu, C), bs[None]], dim=0)

        # patch recovery: flax ConvTranspose(transpose_kernel=False) applies
        # the kernel spatially FLIPPED — flip here so converted checkpoints
        # keep their conv layout
        kur, bur = self.recover_upper.kernel, self.recover_upper.bias
        ksr, bsr = self.recover_surface.kernel, self.recover_surface.bias
        kur_f = kur.flip(0, 1, 2)
        ksr_f = ksr.flip(0, 1)
        Wr = kur.new_zeros((Zt, 2 * C, ph, pw, Cout))
        for zt in range(Zu):
            for lz in range(pz):
                level = pz * zt + lz
                if level >= L:
                    continue
                lane_idx = torch.arange(Vl, device=kur.device) * L + level
                Wr[zt][:, :, :, lane_idx] = kur_f[lz].permute(2, 0, 1, 3)
        Wr[Zu, :, :, :, n_up:] = ksr_f.permute(2, 0, 1, 3)
        bias_out = torch.cat([bur.repeat_interleave(L), bsr])
        dt = torch.bfloat16
        return {
            "Wg": Wg.reshape(ph * pw * lanes, Zt * C).to(dt),
            "bias_g": bias_g.to(dt),
            "Wr": Wr.reshape(Zt * 2 * C, ph * pw * Cout).to(dt),
            "bias_out": bias_out.to(dt),
        }

    def _stage(self, x, s, valid):
        xp = W.pad_to_windows(x, self.cfg.window)[0].contiguous()
        for name in self.stages[s]:
            xp = getattr(self, name)(xp, valid)
        return xp[: valid[0], : valid[1], : valid[2]]

    def forward(self, x72, gw: dict | None = None):
        """x72 (H, W, 65 upper + 4 surface + 3 masks) normalized → (H, W, 69).

        ``gw``: the cached ``grand_weights()`` with K3's and K4's prepared
        operands (``"down"``, ``"up"``), or None to build the grand weights
        here, differentiably, and let K3 and K4 prepare theirs."""
        if gw is None:
            gw = self.grand_weights()
        cfg = self.cfg
        pz, ph, pw = cfg.patch
        C = cfg.embed_dim
        Hin, Win = x72.shape[0], x72.shape[1]
        Ht, Wt = -(-Hin // ph), Win // pw
        Zt = cfg.z_tokens
        n_up = cfg.levels * cfg.level_vars
        lanes = n_up + cfg.surface_channels + cfg.const_masks
        dt = x72.dtype

        xp = F.pad(x72, (0, 0, 0, 0, 0, (-Hin) % ph))
        p = xp.reshape(Ht, ph, Wt, pw, lanes).permute(0, 2, 1, 3, 4)
        p = p.reshape(Ht * Wt, ph * pw * lanes)
        tok = p @ gw["Wg"].to(dt)
        tok = tok.reshape(Ht, Wt, Zt, C) + gw["bias_g"].to(dt)
        x = tok.permute(2, 0, 1, 3)  # (Zt, Ht, Wt, C)

        valid_full = (Zt, Ht, Wt)
        valid_half = (Zt, -(-Ht // 2), Wt // 2)
        x = self._stage(x, 0, valid_full)
        skip = x
        x = self.DownSample_0(x, gw.get("down"))
        x = self._stage(x, 1, valid_half)
        x = self._stage(x, 2, valid_half)
        x = self.UpSample_0(x, Ht, gw.get("up"))
        x = self._stage(x, 3, valid_full)
        x = torch.cat([x, skip], dim=-1)  # (Zt, Ht, Wt, 2C)

        Cout = n_up + cfg.surface_channels
        t = x.permute(1, 2, 0, 3).reshape(Ht * Wt, Zt * 2 * C)
        y = t @ gw["Wr"].to(dt)
        y = y.reshape(Ht, Wt, ph, pw, Cout) + gw["bias_out"].to(dt)
        y = y.permute(0, 2, 1, 3, 4).reshape(Ht * ph, Wt * pw, Cout)
        return y[:Hin]


class PanguModel(PrognosticModel):
    """69-channel Pangu with hierarchical 6h/24h stepping.

    ``variant``: "pangu" (24h net every 4th step, 6h otherwise), "pangu6",
    "pangu24".  Runs on ``device`` (the card by default).
    """

    name = "pangu"
    channels = ch.PANGU
    n_history = 1
    lon_manual = True  # the lon-sharded step of parallel/fused_shard.py

    @property
    def lon_shard_divisor(self) -> int:
        # lon shards must divide the half-resolution token width, so that
        # the 2×2 patch merge (K3) stays local: n | Wt/2 ⟹ n | Wt, (Wt/n)
        # even, and n | cfg.lon
        return self.cfg.hw_tokens[1] // 2

    def __init__(self, variant: str = "pangu", cfg: PanguConfig | None = None, device="cuda"):
        if variant not in ("pangu", "pangu6", "pangu24"):
            raise ValueError(f"unknown Pangu variant {variant!r}")
        self.device = resolve_device(device)
        self.cfg = cfg or PanguConfig()
        self.variant = variant
        if variant == "pangu24":
            self.time_step = datetime.timedelta(hours=24)
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default), so a seed gives the same parameters on every device."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        nc = len(self.channels)
        H, Wd = self.cfg.lat, self.cfg.lon

        def net():
            return init_flax_params_(PanguNet(self.cfg), g).to(self.device).eval().requires_grad_(False)

        params = {
            "net6": net(),
            "norm": make_norm_params(nc, device=self.device),
            "consts": torch.zeros((self.cfg.const_masks, H, Wd), device=self.device),
        }
        if self.variant == "pangu":
            params["net24"] = net()
        return self.prepare_params(params)

    @torch.no_grad()
    def prepare_params(self, params):
        """Attach the grand embed/recover GEMM weights and K3's and K4's
        operands (pure functions of the parameters) under
        ``params["cache"]``; ``apply`` builds them inline without it."""
        if "cache" in params:
            return params
        nets = {key: params[net] for key, net in (("gw6", "net6"), ("gw24", "net24")) if net in params}
        cache = {key: n.grand_weights() | {"down": n.DownSample_0.prepare(), "up": n.UpSample_0.prepare()}
                 for key, n in nets.items()}
        return {**params, "cache": cache}

    def _forward(self, net: PanguNet, params, x, gw):
        """One network evaluation on a (C, H, W) state; ``gw`` the cached
        grand weights or None."""
        xn = normalize(params["norm"], x).to(self.compute_dtype)
        # inside a lon-manual region x is this rank's lon chunk: the constant
        # masks are cut to it
        consts = FS.local_lon_slice(params["consts"], axis=-1).to(self.compute_dtype)
        x72 = torch.cat([xn, consts], dim=0).permute(1, 2, 0)
        y = net(x72, gw)
        y = y.permute(2, 0, 1).float()
        return denormalize(params["norm"], y)

    def apply(self, params, x):
        return self._forward(params["net6"], params, x[-1], params.get("cache", {}).get("gw6"))[None]

    def init_state(self, params, x0, generator=None, start_time=None):
        state = super().init_state(params, x0, generator, start_time=start_time)
        if self.variant == "pangu":
            # anchor: last state at a 24h boundary (input of the 24h net)
            state = state.replace(extra={"anchor": state.x[-1]})
        return state

    @torch.no_grad()
    def advance(self, params, state: ModelState):
        if self.variant != "pangu":
            return super().advance(params, state)
        cache = params.get("cache", {})
        # steps 1, 2, 3: 6h net; step 4 (completing 24h): 24h net from anchor
        if state.step % 4 == 3:
            y = self._forward(params["net24"], params, state.extra["anchor"], cache.get("gw24"))
            anchor = y
        else:
            y = self._forward(params["net6"], params, state.x[-1], cache.get("gw6"))
            anchor = state.extra["anchor"]
        new_state = state.replace(
            x=y[None],
            step=state.step + 1,
            time_days=state.time_days + self._step_days,
            extra={"anchor": anchor},
        )
        return new_state, y[None]

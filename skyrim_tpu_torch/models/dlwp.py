"""DLWP — cubed-sphere CNN (port of skyrim_tpu/models/dlwp.py).

7 channels, two 6-h history frames in, two 6-h frames out a call (12 h),
721×1440 in and out (Weyn et al. 2020, "DLWP-CS"): the fields are
remapped lat-lon → equiangular cubed sphere, a U-Net runs over the 6
faces with cross-face halo padding, and the output is remapped back and
added to the last input frame in normalised space.

The faces are the batch of every convolution.  Activations stay
channels-last, ``(B, 6, F, F, C)`` as in the JAX package: a halo pad is
one ``index_select`` on the flattened ``(B, 6·F·F, C)`` rows, and each
3×3 ``VALID`` convolution takes the ``(6B, F+2, F+2, C)`` rows as an NCHW
view in channels-last memory, the layout cuDNN's bf16 kernels take
directly.  The conv kernels stay in the flax tree's ``(kh, kw, in, out)``
layout in ``params["net"]``; ``prepare_params`` turns them into torch's
``(out, in, kh, kw)`` once, in the compute dtype, under
``params["cache"]``.  The remaps gather and take the bilinear sum in the
compute dtype, in the JAX package's order ``w0·p0 + w1·p1 + w2·p2 +
w3·p3``; pooling and the skip concat stay in it too.  No kernel of the
port is on this path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyrim_tpu_torch import channels as ch
from skyrim_tpu_torch import grid as g
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.models.base import (
    PrognosticModel,
    denormalize,
    init_flax_params_,
    make_norm_params,
    normalize,
)
from skyrim_tpu_torch.models.pangu import ConvParams
from skyrim_tpu_torch.utils.device import resolve_device


def cs_pad(x: torch.Tensor, halo_idx: torch.Tensor) -> torch.Tensor:
    """Cross-face halo pad: (B, 6, F, F, C) → (B, 6, F+2p, F+2p, C), the
    table ``halo_idx`` (6, F+2p, F+2p) of flat cell indices."""
    B, C = x.shape[0], x.shape[-1]
    flat = x.reshape(B, -1, C).index_select(1, halo_idx.reshape(-1))
    return flat.reshape(B, *halo_idx.shape, C)


def conv3x3(x: torch.Tensor, wb: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """3×3 ``VALID`` convolution with the faces as batch: (B, 6, H, W, Cin)
    → (B, 6, H−2, W−2, Cout), ``wb`` torch's (out, in, 3, 3) weight and bias."""
    B, nf, H, W, C = x.shape
    y = F.conv2d(x.reshape(B * nf, H, W, C).permute(0, 3, 1, 2), *wb)
    return y.permute(0, 2, 3, 1).reshape(B, nf, H - 2, W - 2, -1)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 on the faces (``jax.image.resize(..., "nearest")`` at
    ×2): (B, 6, H, W, C) → (B, 6, 2H, 2W, C)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def torch_conv_weights(net: nn.Module, dtype: torch.dtype) -> dict:
    """Every conv of ``net`` as torch's (out, in, kh, kw) weight, in
    channels-last memory, and its bias, both in ``dtype``, keyed by module
    path.  flax's convolution is a cross-correlation like torch's, so the
    kernel is transposed, not flipped."""
    return {
        name: (m.kernel.permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last),
               m.bias.to(dtype))
        for name, m in net.named_modules() if isinstance(m, ConvParams)
    }


class CSConvBlock(nn.Module):
    """Two 3×3 convs with cubed-sphere halo padding + leaky ReLU 0.1."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.Conv_0 = ConvParams((3, 3, in_channels, features))
        self.Conv_1 = ConvParams((3, 3, features, features))

    def forward(self, x, conv_0, conv_1, halo_idx) -> torch.Tensor:
        """x (B, 6, F, F, Cin) → (B, 6, F, F, features); ``conv_0``,
        ``conv_1`` this block's convs from ``torch_conv_weights``."""
        for wb in (conv_0, conv_1):
            x = F.leaky_relu(conv3x3(cs_pad(x, halo_idx), wb), 0.1)
        return x


class CubeUNet(nn.Module):
    """U-Net over cubed-sphere faces, the flax module's parameter tree:
    ``CSConvBlock_{i}`` down the features, then back up, then ``Conv_0``."""

    def __init__(self, in_channels: int, out_channels: int, face_size: int = 64,
                 features: tuple = (64, 128, 256)):
        super().__init__()
        self.face_size, self.features = face_size, tuple(features)
        blocks, cin = [], in_channels
        for feat in self.features:
            blocks.append(CSConvBlock(cin, feat))
            cin = feat
        for feat in reversed(self.features[:-1]):
            blocks.append(CSConvBlock(cin + feat, feat))
            cin = feat
        for i, b in enumerate(blocks):
            self.add_module(f"CSConvBlock_{i}", b)
        self.Conv_0 = ConvParams((3, 3, cin, out_channels))

    def forward(self, x, convs: dict, halo) -> torch.Tensor:
        """x (B, 6, F, F, Cin) in the compute dtype → (B, 6, F, F, Cout);
        ``convs`` from ``torch_conv_weights``, ``halo(F)`` the device halo
        table at face size F."""

        def block(i, x, F_):
            name = f"CSConvBlock_{i}"
            return getattr(self, name)(x, convs[f"{name}.Conv_0"], convs[f"{name}.Conv_1"], halo(F_))

        skips, F_, n = [], self.face_size, len(self.features)
        for i in range(n):
            x = block(i, x, F_)
            if i < n - 1:
                skips.append(x)
                B, nf, H, W, C = x.shape
                x = F.avg_pool2d(x.reshape(B * nf, H, W, C).permute(0, 3, 1, 2), 2, 2)
                x = x.permute(0, 2, 3, 1).reshape(B, nf, H // 2, W // 2, C)
                F_ //= 2
        for i, skip in enumerate(reversed(skips)):
            x = nearest_up2(x)
            F_ *= 2
            x = block(n + i, torch.cat([x, skip], dim=-1), F_)
        return conv3x3(cs_pad(x, halo(F_)), convs["Conv_0"])


class DLWPModel(PrognosticModel):
    """DLWP on ``device`` (the card by default); ``grid`` another lat-lon
    grid than the canonical 721×1440 (small test configurations)."""

    name = "dlwp"
    channels = ch.DLWP
    n_history = 2
    frames_out = 2  # two 6-h frames per call (12 h), DLWP-CS style

    def __init__(self, face_size: int = 64, features: tuple = (64, 128, 256), grid: LatLonGrid | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.face_size, self.features = face_size, tuple(features)
        if grid is not None:
            self.grid = grid
        H, W = self.grid.shape
        F2 = face_size + 2
        self._halo = {}
        # lat-lon → cube: the 4 neighbours of each cube cell as flat lat-lon
        # indices, grouped by neighbour, (4·6F²,), and weights (4, 6F²)
        starts, w = g.latlon_to_cubed_sphere_patch(face_size, H, W)
        i0, j0 = starts[:, 0].astype(np.int64), starts[:, 1].astype(np.int64)
        j1 = (j0 + 1) % W  # longitude wrap
        idx = np.stack([i0 * W + j0, i0 * W + j1, (i0 + 1) * W + j0, (i0 + 1) * W + j1])
        self._remaps = {"cs": (torch.as_tensor(idx.reshape(-1), device=self.device),
                               torch.as_tensor(w.T, device=self.device))}
        # cube → lat-lon: the 2×2 patch of each lat-lon point in the halo-
        # padded (6·F2, F2) face grid as flat indices, grouped by corner
        starts, w = g.cubed_sphere_to_latlon_patch(face_size, H, W)
        r = starts[:, 0].astype(np.int64) * F2 + starts[:, 1]
        idx = np.stack([r, r + 1, r + F2, r + F2 + 1])
        self._remaps["ll"] = (torch.as_tensor(idx.reshape(-1), device=self.device),
                              torch.as_tensor(w.T, device=self.device))
        self._remap_w: dict = {}  # the weights in a compute dtype, by (remap, dtype)

    def halo(self, face_size: int) -> torch.Tensor:
        """The halo table (6, F+2, F+2) of ``grid.cubed_sphere_halo_indices``
        on the device, as int64."""
        if face_size not in self._halo:
            table = g.cubed_sphere_halo_indices(face_size, 1)
            self._halo[face_size] = torch.as_tensor(table.astype(np.int64), device=self.device)
        return self._halo[face_size]

    def new_net(self) -> CubeUNet:
        nc = len(self.channels)
        return CubeUNet(self.n_history * nc, self.frames_out * nc, self.face_size, self.features)

    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters drawn on the CPU from ``generator`` (seed 0 by
        default): flax's initialisers (kernels lecun_normal, biases zero)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = {
            "net": init_flax_params_(self.new_net(), gen).to(self.device).eval().requires_grad_(False),
            "norm": make_norm_params(len(self.channels), device=self.device),
        }
        return self.prepare_params(params)

    @torch.no_grad()
    def prepare_params(self, params):
        """Attach the convs in torch's layout (``torch_conv_weights``), in
        the compute dtype, under ``params["cache"]["convs"]``."""
        if "cache" in params:
            return params
        params = dict(params)
        params["cache"] = {"convs": {self.compute_dtype: torch_conv_weights(params["net"], self.compute_dtype)}}
        return params

    def _bilinear(self, table: torch.Tensor, remap: str) -> torch.Tensor:
        """(D, K) → (D, M): each output point's four neighbours gathered from
        ``table``'s columns and summed with their weights cast to ``table``'s
        dtype, in it, in the order w0·p0 + w1·p1 + w2·p2 + w3·p3."""
        idx, w = self._remaps[remap]
        if (remap, table.dtype) not in self._remap_w:
            self._remap_w[remap, table.dtype] = w.to(table.dtype)
        wf = self._remap_w[remap, table.dtype]
        p = table.index_select(1, idx).view(table.shape[0], 4, -1)
        return wf[0] * p[:, 0] + wf[1] * p[:, 1] + wf[2] * p[:, 2] + wf[3] * p[:, 3]

    def _remap_to_cs(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) → (N, 6, F, F, C)."""
        N, C = x.shape[:2]
        F_ = self.face_size
        out = self._bilinear(x.reshape(N * C, -1), "cs")  # (N·C, 6F²)
        return out.view(N, C, 6, F_, F_).permute(0, 2, 3, 4, 1)

    def _remap_to_ll(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 6, F, F, C) → (N, C, H, W): the halo-padded faces as a
        (N·C, 6·F2²) table, each lat-lon point from its 2×2 patch (patches
        never straddle a face band: a start row has pb0 ≤ F)."""
        N, C = x.shape[0], x.shape[-1]
        padded = cs_pad(x, self.halo(self.face_size))  # (N, 6, F2, F2, C)
        table = padded.permute(0, 4, 1, 2, 3).reshape(N * C, -1)
        return self._bilinear(table, "ll").view(N, C, *self.grid.shape)

    def _convs(self, params, dtype) -> dict:
        """The cached convs in ``dtype`` (added to the cache at first use), or
        without a cache the convs built here, differentiably."""
        if "cache" not in params:
            return torch_conv_weights(params["net"], dtype)
        convs = params["cache"]["convs"]
        if dtype not in convs:
            with torch.no_grad():
                convs[dtype] = torch_conv_weights(params["net"], dtype)
        return convs[dtype]

    def apply(self, params, x):
        """x (2, 7, H, W) → (2, 7, H, W): the two history frames stacked on
        channels (frame 0 first), the U-Net on the cube, the output's frames
        remapped back and added to the last frame in normalised f32."""
        nc, dt = len(self.channels), self.compute_dtype
        xn = normalize(params["norm"], x).to(dt)
        cs = self._remap_to_cs(xn)  # (hist, 6, F, F, C)
        stacked = torch.cat([cs[i] for i in range(self.n_history)], dim=-1)[None]
        y = params["net"](stacked, self._convs(params, dt), self.halo)[0]
        F_ = self.face_size
        y = y.reshape(6, F_, F_, self.frames_out, nc).permute(3, 0, 1, 2, 4)  # (frames_out, 6, F, F, nc)
        ll = self._remap_to_ll(y).float()
        out = normalize(params["norm"], x[-1])[None] + ll
        return denormalize(params["norm"], out)

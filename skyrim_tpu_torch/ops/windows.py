"""3D shifted-window utilities for earth transformers (port of skyrim_tpu/ops/windows.py).

- partition/reverse are reshapes/permutes;
- attention masks and earth-bias gather indices are static numpy
  tables, computed once per geometry;
- longitude is periodic on the globe, so shifted windows along lon need
  no mask — masks only apply along the pressure-level and latitude axes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

Window3 = tuple[int, int, int]


def pad_to_windows(x: torch.Tensor, window: Window3) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Zero-pad (Z, H, W, C) at the end so each spatial dim divides its window.

    Inside a lon-manual region (parallel/fused_shard.py) W is a local chunk
    of a periodic axis whose global width already divides the window:
    padding it would put zeros into the ring, so lon is never padded there
    (the cover gather handles chunks that cut a window)."""
    from skyrim_tpu_torch.parallel import fused_shard

    Z, H, W, _ = x.shape
    wz, wh, ww = window
    pz, ph, pw = (-Z) % wz, (-H) % wh, (-W) % ww
    if fused_shard.current() is not None:
        pw = 0
    if pz or ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pz))
    return x, (pz, ph, pw)


def window_partition(x: torch.Tensor, window: Window3) -> torch.Tensor:
    """(Z, H, W, C) → (nWin, wz*wh*ww, C); dims must divide the window."""
    Z, H, W, C = x.shape
    wz, wh, ww = window
    x = x.reshape(Z // wz, wz, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(-1, wz * wh * ww, C)


def window_reverse(win: torch.Tensor, window: Window3, dims: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of window_partition."""
    Z, H, W = dims
    wz, wh, ww = window
    C = win.shape[-1]
    x = win.reshape(Z // wz, H // wh, W // ww, wz, wh, ww, C)
    x = x.permute(0, 3, 1, 4, 2, 5, 6)
    return x.reshape(Z, H, W, C)


@lru_cache(maxsize=64)
def shift_attention_mask(
    dims: tuple[int, int, int],
    window: Window3,
    shift: Window3,
    valid: tuple[int, int, int] | None = None,
) -> np.ndarray | None:
    """Additive attention mask (nWinZ, nWinH, wlen, wlen), or None.

    Swin region ids along Z (pressure levels) and H (latitude); W is
    periodic, so the mask is independent of the lon window and is
    factored over (z-window, h-window) only.  ``valid`` gives the
    unpadded extents: padded cells are masked as keys.  Tokens inside a
    window are ordered z, then h, then w, as in ``window_partition``.
    """
    Z, H, _ = dims
    wz, wh, ww = window
    sz, sh, _ = shift
    vz, vh, _ = valid if valid is not None else dims
    if sz == 0 and sh == 0 and (vz, vh) == (Z, H):
        return None

    def regions(size, w, s):
        # region ids in SHIFTED coordinates: positions below size-w are
        # contiguous originals; the last window mixes [size-w, size-s)
        # with the wrapped tokens [size-s, size)
        ids = np.zeros(size, dtype=np.int64)
        if s:
            ids[size - w : size - s] = 1
            ids[size - s :] = 2
        return ids

    def valid_axis(size, v, s):
        m = np.zeros(size, dtype=bool)
        m[:v] = True
        return np.roll(m, -s)  # data is padded, then rolled, then partitioned

    rz_w = regions(Z, wz, sz).reshape(-1, wz)
    rh_w = regions(H, wh, sh).reshape(-1, wh)
    vz_w = valid_axis(Z, vz, sz).reshape(-1, wz)
    vh_w = valid_axis(H, vh, sh).reshape(-1, wh)
    nz, nh = rz_w.shape[0], rh_w.shape[0]

    reg = rz_w[:, None, :, None, None] * 16 + rh_w[None, :, None, :, None]
    val = vz_w[:, None, :, None, None] & vh_w[None, :, None, :, None]
    reg = np.broadcast_to(reg, (nz, nh, wz, wh, ww)).reshape(nz, nh, -1)
    val = np.broadcast_to(val, (nz, nh, wz, wh, ww)).reshape(nz, nh, -1)

    blocked = (reg[:, :, :, None] != reg[:, :, None, :]) | (~val[:, :, None, :])
    mask = np.where(blocked, -1e9, 0.0).astype(np.float32)
    if not mask.any():
        return None
    return mask


@lru_cache(maxsize=32)
def earth_bias_index(window: Window3) -> np.ndarray:
    """Static gather index (wlen, wlen) into the earth-specific bias table:
    absolute in level and latitude within the window, relative in
    longitude; table length wz²·wh²·(2·ww−1)."""
    wz, wh, ww = window
    z1, h1, w1 = np.meshgrid(np.arange(wz), np.arange(wh), np.arange(ww), indexing="ij")
    pos = np.stack([z1.ravel(), h1.ravel(), w1.ravel()], axis=-1)  # (wlen, 3)
    dz = pos[:, None, 0] * wz + pos[None, :, 0]
    dh = pos[:, None, 1] * wh + pos[None, :, 1]
    dw = pos[:, None, 2] - pos[None, :, 2] + (ww - 1)
    idx = (dz * (wh * wh) + dh) * (2 * ww - 1) + dw
    return idx.astype(np.int32)


def earth_bias_table_size(window: Window3) -> int:
    wz, wh, ww = window
    return wz * wz * wh * wh * (2 * ww - 1)


@lru_cache(maxsize=32)
def swin_rel_index(window2: tuple[int, int]) -> np.ndarray:
    """Standard Swin 2D relative-position index: (wlen, wlen) rows into the
    ((2wh−1)(2ww−1),) relative table (the Swin-V2 bias of models/fuxi.py)."""
    wh, ww = window2
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"), -1).reshape(-1, 2)
    rel = coords[:, None] - coords[None, :]  # (wlen, wlen, 2)
    return (rel[..., 0] + wh - 1) * (2 * ww - 1) + (rel[..., 1] + ww - 1)


@lru_cache(maxsize=32)
def swin_v2_log_coords(window2: tuple[int, int]) -> np.ndarray:
    """Swin-V2 continuous-position-bias MLP input: ((2wh−1)(2ww−1), 2)
    log-spaced normalised relative coordinates (Liu et al. 2022, eq. 4:
    sign(Δ)·log2(1 + |8·Δ/(w−1)|)/log2(8))."""
    wh, ww = window2
    dh = np.arange(-(wh - 1), wh, dtype=np.float64)
    dw = np.arange(-(ww - 1), ww, dtype=np.float64)
    t = np.stack(np.meshgrid(dh, dw, indexing="ij"), -1)
    t[..., 0] /= max(wh - 1, 1)
    t[..., 1] /= max(ww - 1, 1)
    t *= 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


_MASKS: dict = {}


def mask_tensor(dims, window, shift, valid, device) -> torch.Tensor | None:
    """``shift_attention_mask`` as a tensor on ``device``, made once per
    geometry and device."""
    key = (dims, tuple(window), shift, valid, str(device))
    if key not in _MASKS:
        m = shift_attention_mask(dims, tuple(window), shift, valid)
        _MASKS[key] = None if m is None else torch.from_numpy(m).to(device)
    return _MASKS[key]

"""Plain f32 Pangu-Weather (Bi et al., Nature 619, 2023; the pseudocode of
github.com/198808xc/Pangu-Weather), written from the published description
in the flax parameter layout that checkpoints use.

One step: normalise the 69 channels, append the 3 constant masks, embed
2×4×4 upper-air and 4×4 surface patches into (8, 181, 360) tokens of width
192, run the 2-6-6-2 Earth-specific window blocks (window (2, 6, 12),
shifted every other block, earth bias absolute in level and latitude and
relative in longitude, tokens padded to window multiples and masked as
keys), 2×2 merge and expand between the stages, concatenate the first
stage's output, recover the patches with the kernels flipped (flax's
``ConvTranspose`` without ``transpose_kernel``), denormalise.

Departures from the paper, all as the checkpoints' flax model has them:
the LayerNorm epsilon is 1e-6, GELU is the tanh form, the padded latitude
rows are zeros after normalisation, the last of the 14 padded levels is
empty.  The attention bias table and the shift masks are worked out here
from the window geometry.  Everything runs in float32 with TF32 off
(``common.exact_f32``); ``quant="fp8"`` rounds each product's operands to
float8 e4m3, the benchmark's control.

``weights`` maps each parameter's flax path, with dots (``net6.PanguBlock_3.
EarthAttention3D_0.qkv.kernel``, ``norm.mean``, ``consts``), to a tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from wxbench.reference.common import ein, exact_f32, gelu_tanh, layer_norm

ATTN_CHUNK = 256  # windows per attention chunk, to keep the f32 scores small


def param_shapes(cfg: dict, net: str = "net6") -> dict[str, tuple]:
    """The flax parameter shapes of one net at the configuration's sizes."""
    C, heads, depths = cfg["embed_dim"], cfg["num_heads"], cfg["depths"]
    (pz, ph, pw), (wz, wh, ww) = cfg["patch"], cfg["window"]
    V, S, M = cfg["level_vars"], cfg["surface_channels"], cfg["const_masks"]
    Zt, Ht = -(-(cfg["levels"] + 1) // pz) + 1, -(-cfg["lat"] // ph)
    n_types = (-(-Zt // wz) * -(-Ht // wh), -(-Zt // wz) * -(-(-(-Ht // 2)) // wh))
    table = wz * wz * wh * wh * (2 * ww - 1)
    s = {"embed_surface.kernel": (ph, pw, S + M, C), "embed_surface.bias": (C,),
         "embed_upper.kernel": (pz, ph, pw, V, C), "embed_upper.bias": (C,),
         "recover_upper.kernel": (pz, ph, pw, 2 * C, V), "recover_upper.bias": (V,),
         "recover_surface.kernel": (ph, pw, 2 * C, S), "recover_surface.bias": (S,),
         "DownSample_0.LayerNorm_0.scale": (4 * C,), "DownSample_0.LayerNorm_0.bias": (4 * C,),
         "DownSample_0.Dense_0.kernel": (4 * C, 2 * C), "DownSample_0.Dense_0.bias": (2 * C,),
         "UpSample_0.Dense_0.kernel": (2 * C, 4 * C), "UpSample_0.Dense_0.bias": (4 * C,),
         "UpSample_0.LayerNorm_0.scale": (C,), "UpSample_0.LayerNorm_0.bias": (C,)}
    i = 0
    for st, depth in enumerate(depths):
        d = C if st in (0, 3) else 2 * C
        hid = int(d * cfg["mlp_ratio"])
        for _ in range(depth):
            p = f"PanguBlock_{i}."
            s |= {p + "LayerNorm_0.scale": (d,), p + "LayerNorm_0.bias": (d,),
                  p + "EarthAttention3D_0.earth_bias": (n_types[0 if st in (0, 3) else 1], heads[st], table),
                  p + "EarthAttention3D_0.qkv.kernel": (d, 3 * d), p + "EarthAttention3D_0.qkv.bias": (3 * d,),
                  p + "EarthAttention3D_0.proj.kernel": (d, d), p + "EarthAttention3D_0.proj.bias": (d,),
                  p + "LayerNorm_1.scale": (d,), p + "LayerNorm_1.bias": (d,),
                  p + "Dense_0.kernel": (d, hid), p + "Dense_0.bias": (hid,),
                  p + "Dense_1.kernel": (hid, d), p + "Dense_1.bias": (d,)}
            i += 1
    return {f"{net}.{k}": v for k, v in s.items()}


def earth_bias_index(window) -> np.ndarray:
    """(wlen, wlen) index into a window's bias table of wz²·wh²·(2ww−1):
    the query's and key's level and latitude absolute, longitude relative."""
    wz, wh, ww = window
    z, h, w = (a.ravel() for a in np.meshgrid(np.arange(wz), np.arange(wh), np.arange(ww), indexing="ij"))
    dz = z[:, None] * wz + z[None, :]
    dh = h[:, None] * wh + h[None, :]
    dw = w[:, None] - w[None, :] + ww - 1
    return (dz * wh * wh + dh) * (2 * ww - 1) + dw


def shift_mask(dims, window, shift, valid) -> np.ndarray | None:
    """Additive mask (nz, nh, wlen, wlen) of a window-padded (Z, H, W) grid
    whose data was rolled by −shift: keys in another region of the shifted
    level/latitude axis, or in padding, are blocked; longitude is periodic."""
    (Z, H, _), (wz, wh, ww), (sz, sh, _), (vz, vh, _) = dims, window, shift, valid
    if not sz and not sh and (vz, vh) == (Z, H):
        return None

    def region(n, w, s):
        r = np.zeros(n, np.int64)
        if s:
            r[n - w:n - s], r[n - s:] = 1, 2
        return r.reshape(-1, w)

    def inside(n, w, v, s):
        return np.roll(np.arange(n) < v, -s).reshape(-1, w)

    rz, rh = region(Z, wz, sz), region(H, wh, sh)
    iz, ih = inside(Z, wz, vz, sz), inside(H, wh, vh, sh)
    nz, nh = rz.shape[0], rh.shape[0]
    reg = np.broadcast_to(rz[:, None, :, None, None] * 16 + rh[None, :, None, :, None], (nz, nh, wz, wh, ww))
    ok = np.broadcast_to(iz[:, None, :, None, None] & ih[None, :, None, :, None], (nz, nh, wz, wh, ww))
    reg, ok = reg.reshape(nz, nh, -1), ok.reshape(nz, nh, -1)
    blocked = (reg[..., :, None] != reg[..., None, :]) | ~ok[..., None, :]
    if not blocked.any():
        return None
    return np.where(blocked, -1e9, 0.0).astype(np.float32)


def _partition(x, window):
    Z, H, W, C = x.shape
    wz, wh, ww = window
    x = x.reshape(Z // wz, wz, H // wh, wh, W // ww, ww, C).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(-1, wz * wh * ww, C)


def _reverse(win, window, dims):
    Z, H, W = dims
    wz, wh, ww = window
    x = win.reshape(Z // wz, H // wh, W // ww, wz, wh, ww, -1).permute(0, 3, 1, 4, 2, 5, 6)
    return x.reshape(Z, H, W, -1)


def _attention(qkv, table, mask, window, heads, quant):
    """Window attention of a (Z, H, W, 3C) tensor with the earth bias
    ``table`` (n_types, heads, wlen, wlen) and the additive ``mask``."""
    Z, H, W, C3 = qkv.shape
    C, hd = C3 // 3, C3 // 3 // heads
    wz, wh, ww = window
    nw = W // ww
    win = _partition(qkv, window)
    n_win, wlen = win.shape[:2]
    out = torch.empty(n_win, wlen, C, dtype=qkv.dtype, device=qkv.device)
    for lo in range(0, n_win, ATTN_CHUNK):
        hi = min(lo + ATTN_CHUNK, n_win)
        w = win[lo:hi].reshape(hi - lo, wlen, 3, heads, hd)
        q, k, v = (w[:, :, i].transpose(1, 2) for i in range(3))
        s = ein("nhqd,nhkd->nhqk", q, k, quant) * hd**-0.5
        idx = torch.arange(lo, hi, device=qkv.device)
        s = s + table[idx // nw]
        if mask is not None:
            s = s + mask.reshape(-1, wlen, wlen)[idx // nw][:, None]
        p = torch.softmax(s, dim=-1)
        out[lo:hi] = ein("nhqk,nhkd->nhqd", p, v, quant).transpose(1, 2).reshape(hi - lo, wlen, C)
    return _reverse(out, window, (Z, H, W))


def _dense(x, w, prefix, quant):
    return ein("...i,io->...o", x, w[prefix + ".kernel"], quant) + w[prefix + ".bias"]


def _block(x, w, p, table, mask, window, heads, quant):
    h = layer_norm(x, w[p + "LayerNorm_0.scale"], w[p + "LayerNorm_0.bias"])
    qkv = _dense(h, w, p + "EarthAttention3D_0.qkv", quant)
    a = _attention(qkv, table, mask, window, heads, quant)
    x = x + _dense(a, w, p + "EarthAttention3D_0.proj", quant)
    h = layer_norm(x, w[p + "LayerNorm_1.scale"], w[p + "LayerNorm_1.bias"])
    h = gelu_tanh(_dense(h, w, p + "Dense_0", quant))
    return x + _dense(h, w, p + "Dense_1", quant)


def _stage(x, w, net, cfg, blocks, heads, valid, quant, remat):
    window = tuple(cfg["window"])
    pads = [(-n) % m for n, m in zip(x.shape[:3], window)]
    x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = tuple(x.shape[:3])
    idx = torch.as_tensor(earth_bias_index(window), device=x.device)
    for b, i in enumerate(blocks):
        p = f"{net}.PanguBlock_{i}."
        shift = tuple(s // 2 for s in window) if b % 2 else (0, 0, 0)
        m = shift_mask(dims, window, shift, valid)
        m = None if m is None else torch.as_tensor(m, device=x.device)
        table = w[p + "EarthAttention3D_0.earth_bias"][:, :, idx]
        x = torch.roll(x, tuple(-s for s in shift), (0, 1, 2))
        args = (x, w, p, table, m, window, heads, quant)
        x = checkpoint(_block, *args, use_reentrant=False) if remat else _block(*args)
        x = torch.roll(x, shift, (0, 1, 2))
    return x[: valid[0], : valid[1], : valid[2]]


def _embed(x72, w, net, cfg, quant):
    """Patch embedding of (H, W, 65 upper + 4 surface + 3 masks) normalised
    lanes → (Zt, Ht, Wt, C); upper lanes are var-major (var·levels + level)."""
    pz, ph, pw = cfg["patch"]
    L, V = cfg["levels"], cfg["level_vars"]
    H, Wd, lanes = x72.shape
    Ht, Wt = -(-H // ph), Wd // pw
    x = F.pad(x72, (0, 0, 0, 0, 0, Ht * ph - H)).reshape(Ht, ph, Wt, pw, lanes)
    up = x[..., : V * L].reshape(Ht, ph, Wt, pw, V, L)
    Lp = -(-L // pz) * pz
    up = F.pad(up, (0, Lp - L)).reshape(Ht, ph, Wt, pw, V, Lp // pz, pz)
    tok_up = ein("hiwjvzl,lijvc->zhwc", up, w[f"{net}.embed_upper.kernel"], quant) + w[f"{net}.embed_upper.bias"]
    tok_sf = ein("hiwjk,ijkc->hwc", x[..., V * L:], w[f"{net}.embed_surface.kernel"], quant)
    tok_sf = tok_sf + w[f"{net}.embed_surface.bias"]
    return torch.cat([tok_up, tok_sf[None]], dim=0)


def _recover(x, w, net, cfg, H, quant):
    """(Zt, Ht, Wt, 2C) → (H, W, 65 + 4), the transposed convolutions with
    their kernels flipped in space."""
    pz, ph, pw = cfg["patch"]
    L, V, S = cfg["levels"], cfg["level_vars"], cfg["surface_channels"]
    Zt, Ht, Wt, _ = x.shape
    ku = w[f"{net}.recover_upper.kernel"].flip(0, 1, 2)  # (pz, ph, pw, 2C, V)
    ks = w[f"{net}.recover_surface.kernel"].flip(0, 1)  # (ph, pw, 2C, S)
    up = ein("zhwc,lijcv->hiwjvzl", x[: Zt - 1], ku, quant)  # level = pz·z + l
    up = up.reshape(Ht, ph, Wt, pw, V, (Zt - 1) * pz)[..., :L] + w[f"{net}.recover_upper.bias"][:, None]
    sf = ein("hwc,ijcs->hiwjs", x[Zt - 1], ks, quant) + w[f"{net}.recover_surface.bias"]
    y = torch.cat([up.reshape(Ht, ph, Wt, pw, V * L), sf], dim=-1)
    return y.reshape(Ht * ph, Wt * pw, V * L + S)[:H]


def net_forward(w, cfg, net: str, x: torch.Tensor, quant: str | None = None, remat: bool = False) -> torch.Tensor:
    """One evaluation of ``net`` ("net6" or "net24") on a (69, H, W) state in
    physical units → (69, H, W)."""
    C = cfg["embed_dim"]
    depths, heads = cfg["depths"], cfg["num_heads"]
    mean, std = w["norm.mean"], w["norm.std"]
    H = x.shape[1]
    x72 = torch.cat([(x - mean) / std, w["consts"]], dim=0).permute(1, 2, 0)
    t = _embed(x72, w, net, cfg, quant)
    Zt, Ht, Wt, _ = t.shape
    full, half = (Zt, Ht, Wt), (Zt, -(-Ht // 2), Wt // 2)
    first = list(range(depths[0]))
    t = _stage(t, w, net, cfg, first, heads[0], full, quant, remat)
    skip = t
    # 2×2 merge: (Z, H, W, C) → (Z, H/2, W/2, [h parity, w parity, C]) → LN → Dense
    t = F.pad(t, (0, 0, 0, 0, 0, t.shape[1] % 2))
    Z, Hh, Wd, _ = t.shape
    t = t.reshape(Z, Hh // 2, 2, Wd // 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(Z, Hh // 2, Wd // 2, 4 * C)
    t = layer_norm(t, w[f"{net}.DownSample_0.LayerNorm_0.scale"], w[f"{net}.DownSample_0.LayerNorm_0.bias"])
    t = _dense(t, w, f"{net}.DownSample_0.Dense_0", quant)
    start = depths[0]
    for s in (1, 2):
        blocks = list(range(start, start + depths[s]))
        t = _stage(t, w, net, cfg, blocks, heads[s], half, quant, remat)
        start += depths[s]
    # expand: Dense(4C') → (Z, 2H, 2W, C') → LN, cropped to the full grid's rows
    t = _dense(t, w, f"{net}.UpSample_0.Dense_0", quant)
    Z, Hh, Wd, _ = t.shape
    t = t.reshape(Z, Hh, Wd, 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(Z, 2 * Hh, 2 * Wd, C)
    t = layer_norm(t, w[f"{net}.UpSample_0.LayerNorm_0.scale"], w[f"{net}.UpSample_0.LayerNorm_0.bias"])[:, :Ht]
    t = _stage(t, w, net, cfg, list(range(start, start + depths[3])), heads[3], full, quant, remat)
    t = torch.cat([t, skip], dim=-1)
    y = _recover(t, w, net, cfg, H, quant).permute(2, 0, 1)
    return y * std + mean


def step_net(step: int) -> str:
    """The net that makes 0-based step ``step`` of a forecast: the 24-h net
    from the last 24-h state at every fourth step, the 6-h net otherwise."""
    return "net24" if step % 4 == 3 else "net6"


def step_input(step: int) -> int:
    """The 0-based step whose output is ``step``'s input (−1: the IC)."""
    return step - 4 if step % 4 == 3 else step - 1


@torch.no_grad()
def forecast_step(w, cfg, step: int, x_in: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    with exact_f32():
        return net_forward(w, cfg, step_net(step), x_in, quant)

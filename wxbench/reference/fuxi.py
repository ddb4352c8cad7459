"""Plain f32 FuXi (Chen et al. 2023, "FuXi: a cascade machine learning
forecasting system for 15-day global weather forecast", arXiv:2306.12873),
written from the paper's description in the flax parameter layout of the
FuXi checkpoints' conversion (stacked pairs of blocks).

One step of a stage: normalise the two 70-channel frames and stack them
(140 channels), embed 4×4 patches into (181, 360) tokens of width 768 (the
cube embedding), merge 2×2 tokens (LayerNorm, then a product to width
1536) into (91, 180), pad to whole (6, 12) windows, run 48 Swin-V2 blocks
(every second one shifted by (3, 6), the padded rows masked as keys),
expand 2×2 back to width 768 (a product, then LayerNorm), concatenate the
embedding's tokens, ``fuse`` to 768, recover the 4×4 patches of 70
channels with the head's kernel flipped in space (flax's
``ConvTranspose``), and add the result to the last frame in normalised
units.  The cascade takes stage ``min(step // stage_steps, n_stages − 1)``
for the 0-based step: short, medium and long, 20 six-hour steps each.

A Swin-V2 block (Liu et al. 2022) on x: cosine attention in windows,
``softmax(q̂ k̂ᵀ · exp(min(logit_scale, log 100)) + 16·sigmoid(cpb) + mask) v``
with q̂, k̂ the rows of q and k over their L2 norms (``rsqrt`` of the sum of
squares plus 1e-12), the continuous position bias ``cpb`` an MLP (2 → 512,
ReLU, → heads, no bias at the end) over log-spaced relative coordinates
``sign(d)·log2(1 + 8|d|/(w − 1))/log2(8)``; then residual-post-norm,
``x + LN(proj(attn))`` and ``x + LN(mlp(x))``, the MLP 4× wide with
tanh-GELU.

Departures from the paper, all as the port's published-width model has
them:

- the 2×2 patch merge and expand are products on the merged 4·768 lanes
  (merge: LayerNorm, then the product; expand: the product, then
  LayerNorm), which equal the paper's 2×2 stride-2 convolution and its
  transpose exactly for kernel = stride = 2 (ARCH_FIDELITY.md, deviation 2);
- 24 heads of 64 and windows of (6, 12) tokens, for which the paper gives no
  value;
- the LayerNorm epsilon is 1e-6 (flax's), GELU the tanh form, the token
  rows padded to whole windows are zeros and masked as keys, the padded
  latitude rows of the input are zeros after normalisation.

Everything runs in float32 with TF32 off (``common.exact_f32``), one stage's
weights read leaf by leaf (each cast to f32 where it is used);
``quant="fp8"`` rounds each product's operands to float8 e4m3, the
benchmark's control.  ``weights`` maps each parameter's path, with dots
(``stage2.pairs.b.qkv.kernel``, ``norm.mean``), to a tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from wxbench.reference.common import ein, exact_f32, gelu_tanh, layer_norm
from wxbench.reference.pangu import shift_mask

ATTN_CHUNK = 120  # windows per attention chunk (FuXi's trunk has 240): f32 scores of 60 MB
CPB_SCALE = 16.0
LOGIT_MAX = math.log(100.0)


def param_shapes(cfg: dict, n_history: int = 2) -> dict[str, tuple]:
    """The parameter shapes of one stage at the configuration's sizes."""
    p, D, P, heads, nc = cfg["patch"], cfg["embed_dim"], cfg["depth"] // 2, cfg["num_heads"], cfg["in_channels"]
    Dc = D // 2
    s = {"cube_embed.kernel": (p, p, n_history * nc, Dc), "cube_embed.bias": (Dc,),
         "down_norm.scale": (4 * Dc,), "down_norm.bias": (4 * Dc,), "down.kernel": (4 * Dc, D),
         "up.kernel": (D, 4 * Dc), "up_norm.scale": (Dc,), "up_norm.bias": (Dc,),
         "fuse.kernel": (D, Dc), "fuse.bias": (Dc,), "head.kernel": (p, p, Dc, nc), "head.bias": (nc,)}
    for half in ("a", "b"):
        b = f"pairs.{half}."
        s |= {b + "qkv.kernel": (P, D, 3 * D), b + "qkv.bias": (P, 3 * D), b + "proj.kernel": (P, D, D),
              b + "proj.bias": (P, D), b + "Dense_0.kernel": (P, D, 4 * D), b + "Dense_0.bias": (P, 4 * D),
              b + "Dense_1.kernel": (P, 4 * D, D), b + "Dense_1.bias": (P, D),
              b + "norm1.scale": (P, D), b + "norm1.bias": (P, D), b + "norm2.scale": (P, D),
              b + "norm2.bias": (P, D), b + "cpb_fc1.kernel": (P, 2, 512), b + "cpb_fc1.bias": (P, 512),
              b + "cpb_fc2.kernel": (P, 512, heads), b + "logit_scale": (P, heads, 1, 1)}
    return s


def log_coords(window) -> np.ndarray:
    """((2wh − 1)(2ww − 1), 2) log-spaced relative coordinates of a window."""
    wh, ww = window
    d = [np.arange(-(n - 1), n, dtype=np.float64) / max(n - 1, 1) * 8.0 for n in (wh, ww)]
    t = np.stack(np.meshgrid(*d, indexing="ij"), -1)
    return (np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)).reshape(-1, 2).astype(np.float32)


def rel_index(window) -> np.ndarray:
    """(wlen, wlen) index of each (query, key) offset into the coordinates."""
    wh, ww = window
    c = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"), -1).reshape(-1, 2)
    d = c[:, None] - c[None, :]
    return (d[..., 0] + wh - 1) * (2 * ww - 1) + d[..., 1] + ww - 1


def _f(t):
    return t.float()


def _partition(x, window):
    H, W, C = x.shape
    wh, ww = window
    return x.reshape(H // wh, wh, W // ww, ww, C).permute(0, 2, 1, 3, 4).reshape(-1, wh * ww, C)


def _reverse(win, window, H, W):
    wh, ww = window
    return win.reshape(H // wh, W // ww, wh, ww, -1).permute(0, 2, 1, 3, 4).reshape(H, W, -1)


def _dense(x, w, prefix, i, quant):
    return ein("...i,io->...o", x, _f(w[prefix + ".kernel"][i]), quant) + _f(w[prefix + ".bias"][i])


def _attention(qkv, w, b, i, mask, window, heads, quant):
    """Cosine window attention of the (H, W, 3C) qkv in the block's frame."""
    H, W, C3 = qkv.shape
    C = C3 // 3
    hd, wlen = C // heads, window[0] * window[1]
    t = torch.as_tensor(log_coords(window), device=qkv.device)
    h = torch.relu(ein("ti,io->to", t, _f(w[b + "cpb_fc1.kernel"][i]), quant) + _f(w[b + "cpb_fc1.bias"][i]))
    cpb = ein("to,oh->th", h, _f(w[b + "cpb_fc2.kernel"][i]), quant)
    idx = torch.as_tensor(rel_index(window), device=qkv.device)
    bias = (CPB_SCALE * torch.sigmoid(cpb))[idx].permute(2, 0, 1)  # (heads, wlen, wlen)
    scale = torch.exp(torch.clamp(_f(w[b + "logit_scale"][i]), max=LOGIT_MAX))  # (heads, 1, 1)
    win = _partition(qkv, window)
    n_win = win.shape[0]
    m = None if mask is None else mask.reshape(-1, wlen, wlen)
    out = torch.empty(n_win, wlen, C, dtype=qkv.dtype, device=qkv.device)
    for lo in range(0, n_win, ATTN_CHUNK):
        hi = min(lo + ATTN_CHUNK, n_win)
        q, k, v = win[lo:hi].reshape(hi - lo, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
        k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
        s = ein("nhqd,nhkd->nhqk", q, k, quant) * scale + bias
        if m is not None:  # window t takes table t // (W / ww): the row of windows it lies in
            s = s + m[torch.arange(lo, hi, device=qkv.device) // (W // window[1])][:, None]
        p = torch.softmax(s, dim=-1)
        out[lo:hi] = ein("nhqk,nhkd->nhqd", p, v, quant).transpose(1, 2).reshape(hi - lo, wlen, C)
    return _reverse(out, window, H, W)


def swin_v2_block(x, w, b: str, i: int, window, heads: int, shifted: bool, valid_h: int, quant=None):
    """Block i of the half whose leaves start with ``b`` (``stage0.pairs.a.``)
    on x (H, W, C), H padded to the window, rows from ``valid_h`` padding."""
    H, W, _ = x.shape
    sh = (window[0] // 2, window[1] // 2) if shifted else (0, 0)
    m = shift_mask((1, H, W), (1, *window), (0, *sh), (1, valid_h, W))
    m = None if m is None else torch.as_tensor(m, device=x.device)
    xs = torch.roll(x, (-sh[0], -sh[1]), (0, 1))
    a = _attention(_dense(xs, w, b + "qkv", i, quant), w, b, i, m, window, heads, quant)
    a = torch.roll(_dense(a, w, b + "proj", i, quant), sh, (0, 1))
    x = x + layer_norm(a, _f(w[b + "norm1.scale"][i]), _f(w[b + "norm1.bias"][i]))
    h = _dense(gelu_tanh(_dense(x, w, b + "Dense_0", i, quant)), w, b + "Dense_1", i, quant)
    return x + layer_norm(h, _f(w[b + "norm2.scale"][i]), _f(w[b + "norm2.bias"][i]))


def stage_forward(w, cfg: dict, stage: int, x: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """Stage ``stage`` of the cascade on the two frames x (2, C, H, W) in
    physical units → the next frame (C, H, W)."""
    p, D, heads, window = cfg["patch"], cfg["embed_dim"], cfg["num_heads"], tuple(cfg["window"])
    Dc = D // 2
    s = f"stage{stage}."
    mean, std = w["norm.mean"], w["norm.std"]
    xn = (x - mean) / std
    _, C, H, W = x.shape
    Ht, Wt = -(-H // p), W // p
    # cube embedding: 4 × 4 patches of the 2·C stacked channels (frame-major)
    t = F.pad(xn.reshape(-1, H, W).permute(1, 2, 0), (0, 0, 0, 0, 0, Ht * p - H))
    t = t.reshape(Ht, p, Wt, p, -1)
    skip = ein("hiwjc,ijcd->hwd", t, _f(w[s + "cube_embed.kernel"]), quant) + _f(w[s + "cube_embed.bias"])
    # 2 × 2 merge to the trunk's width
    He = Ht + Ht % 2
    Hd, Wd = He // 2, Wt // 2
    m = F.pad(skip, (0, 0, 0, 0, 0, He - Ht)).reshape(Hd, 2, Wd, 2, Dc).permute(0, 2, 1, 3, 4).reshape(Hd, Wd, 4 * Dc)
    m = layer_norm(m, _f(w[s + "down_norm.scale"]), _f(w[s + "down_norm.bias"]))
    h = F.pad(ein("hwi,io->hwo", m, _f(w[s + "down.kernel"]), quant), (0, 0, 0, 0, 0, (-Hd) % window[0]))
    for i in range(cfg["depth"] // 2):
        h = swin_v2_block(h, w, s + "pairs.a.", i, window, heads, False, Hd, quant)
        h = swin_v2_block(h, w, s + "pairs.b.", i, window, heads, True, Hd, quant)
    # 2 × 2 expand, LayerNorm, the skip, fuse
    u = ein("hwi,io->hwo", h[:Hd], _f(w[s + "up.kernel"]), quant)
    u = u.reshape(Hd, Wd, 2, 2, Dc).permute(0, 2, 1, 3, 4).reshape(He, Wt, Dc)[:Ht]
    u = layer_norm(u, _f(w[s + "up_norm.scale"]), _f(w[s + "up_norm.bias"]))
    f = ein("hwi,io->hwo", torch.cat([u, skip], dim=-1), _f(w[s + "fuse.kernel"]), quant) + _f(w[s + "fuse.bias"])
    # the head: a transposed 4 × 4 convolution of stride 4, its kernel flipped in space
    k = _f(w[s + "head.kernel"]).flip(0, 1)
    y = ein("hwd,ijdc->hiwjc", f, k, quant) + _f(w[s + "head.bias"])
    y = y.reshape(Ht * p, Wt * p, C)[:H].permute(2, 0, 1)
    return (xn[-1] + y) * std + mean


def stage_of(cfg: dict, step: int) -> int:
    """The cascade stage of the 0-based ``step``."""
    return min(step // cfg["stage_steps"], cfg["n_stages"] - 1)


@torch.no_grad()
def forecast_step(w, cfg: dict, step: int, x: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    with exact_f32():
        return stage_forward(w, cfg, stage_of(cfg, step), x, quant)

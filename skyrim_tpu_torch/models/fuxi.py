"""FuXi — U-Transformer cascade (port of skyrim_tpu/models/fuxi.py).

70 channels on 721×1440, two frames of history, 6 h step, and three
cascade stages (short, medium, long; 20 steps each) chosen by the step
(Chen et al. 2023, arXiv:2306.12873, at the JAX package's widths): a cube
embedding (patch 4, width 768) of the two stacked frames, a 2×2 patch
merge to width 1536 on the (91, 180) token grid padded to 96 rows for the
window, 48 window blocks (24 heads, window (6, 12), every second block
shifted by (3, 6)), a 2×2 patch expand, the skip concatenated, ``fuse``,
and a transposed-convolution head.

Two block flavours (``FuXiConfig.attn_v2``):

- Swin-V2, the published one and the default (``swin_v2_block``): cosine
  attention with a learned logit scale clamped at log 100, a
  continuous-position-bias MLP over log-spaced relative coordinates, and
  residual-post-norm.  It is a PyTorch composition, as the JAX package
  computes it outside Pallas; the shifted-window rolls run on K2
  (ops/roll.py).
- V1 (``swin_v1_block``, FengWu's fuser block ``SwinBlock2D`` too): K2 →
  K1 → K2 (ops/fused_block.py; at C 1536 K1's seven-launch chain).

A stage's trunk parameters are stacked as JAX's ``nn.scan`` lays them out
(``pairs/a/qkv/kernel`` (24, 1536, 4608): the unshifted blocks under
``a``, the shifted ones under ``b``); the loop over the pairs takes the
slice ``[p]``.  Stage parameters are bf16 at rest, the norm stats f32.
With the ``int8`` collection of ``quantize.split_dense_int8`` a block's
qkv, proj and MLP products run ``quantize.int8_dot``.  Names follow the
flax tree (``stages/0/pairs/a/norm1/scale``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyrim_tpu_torch import channels as ch
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.models.base import (
    ModelState,
    PrognosticModel,
    _truncated_normal,
    denormalize,
    make_norm_params,
    normalize,
)
from skyrim_tpu_torch.models.pangu import Dense, LayerNorm
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.fused_block import fused_swin_block
from skyrim_tpu_torch.ops.gemm import _layernorm_f32
from skyrim_tpu_torch.ops.roll import shift_roll
from skyrim_tpu_torch.parallel import fused_shard as FS
from skyrim_tpu_torch.quantize import QuantizedTensor, int8_dot, maybe_dequantize, quantize_tree, split_dense_int8
from skyrim_tpu_torch.utils.device import resolve_device
from skyrim_tpu_torch.utils.tree import flatten, unflatten

CPB_HIDDEN = 512  # the continuous-position-bias MLP's width


@dataclasses.dataclass(frozen=True)
class FuXiConfig:
    """The JAX package's widths (≈ 1.37 B parameters a stage); reduced
    values serve the tests."""

    lat: int = 721
    lon: int = 1440
    in_channels: int = 70
    embed_dim: int = 1536  # trunk width
    depth: int = 48
    num_heads: int = 24  # head_dim 64
    window: tuple[int, int] = (6, 12)
    patch: int = 4  # cube-embed spatial downsample
    n_stages: int = 3  # short / medium / long
    stage_steps: int = 20  # 5 days of 6 h steps a stage
    attn_v2: bool = True  # Swin-V2 blocks (published); False: V1 on K1

    @property
    def cube_dim(self) -> int:
        """Width at cube-embed resolution (the U skip level)."""
        return self.embed_dim // 2

    @property
    def tokens(self) -> tuple[int, int]:
        return (-(-self.lat // self.patch), self.lon // self.patch)


# --- tables, cached per geometry and device -----------------------------------

_TABLES: dict = {}


def _table(name: str, window: tuple, device) -> torch.Tensor:
    """``swin_v2_log_coords`` (f32), ``swin_rel_index`` or
    ``earth_bias_index`` (int64) of ``window`` on ``device``."""
    key = (name, window, str(device))
    if key not in _TABLES:
        arr = {"log_coords": W.swin_v2_log_coords, "rel_index": W.swin_rel_index,
               "earth_index": W.earth_bias_index}[name](window)
        _TABLES[key] = torch.from_numpy(arr if arr.dtype == np.float32 else arr.astype(np.int64)).to(device)
    return _TABLES[key]


# --- the blocks, on the leaves of one block (``prm``: flax path → tensor) --------


def _layernorm(x, prm, name):
    """flax LayerNorm in x's dtype: f32 statistics, eps 1e-6."""
    return _layernorm_f32(x, prm[f"{name}/scale"], prm[f"{name}/bias"]).to(x.dtype)


def _dense(x, prm, name, int8=None):
    """flax Dense in x's dtype, or with ``int8`` holding ``{name}_q`` the int8
    product plus the exact bias added in x's dtype."""
    if int8 is not None and f"{name}_q" in int8:
        y = int8_dot(x, QuantizedTensor(int8[f"{name}_q"], int8[f"{name}_scale"], x.dtype))
        return y + int8[f"{name}_bias"].to(x.dtype)
    y = x @ prm[f"{name}/kernel"].to(x.dtype)
    bias = prm.get(f"{name}/bias")
    return y if bias is None else y + bias.to(x.dtype)


def _shift(window, shifted):
    wh, ww = window
    return (0, wh // 2, ww // 2) if shifted else (0, 0, 0)


def swin_v2_terms(prm, window: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """The Swin-V2 attention terms of one block's leaves, or of P stacked
    blocks' at once: the bias ``16·sigmoid(cpb)[rel_index]`` (…, heads,
    wlen, wlen) f32 from the CPB MLP computed in f32, and the logit scale
    ``exp(min(logit_scale, log 100))`` (…, heads, 1, 1) computed in the
    leaf's dtype (bf16 at rest), then f32."""
    dev = prm["cpb_fc1/kernel"].device
    t = _table("log_coords", window, dev)  # (T, 2)
    h = torch.relu(t @ prm["cpb_fc1/kernel"].float() + prm["cpb_fc1/bias"].float().unsqueeze(-2))
    cpb = h @ prm["cpb_fc2/kernel"].float()  # (…, T, heads)
    bias = (16.0 * torch.sigmoid(cpb))[..., _table("rel_index", window, dev), :].movedim(-1, -3)
    ls = prm["logit_scale"]
    scale = torch.exp(torch.minimum(ls, ls.new_tensor(math.log(100.0))))
    return bias, scale.float()


def swin_v2_block(x, prm, bias, scale, heads: int, window: tuple[int, int], shifted: bool, valid_h: int,
                  int8=None):
    """One Swin-V2 block on x (H, W, C), H padded to the window, rows from
    ``valid_h`` on padding (masked as keys); ``bias``/``scale`` from
    ``swin_v2_terms``.  Numerics as the JAX block: q and k normalised with
    their squares in x's dtype summed in f32, f32 scores and softmax, the
    probabilities in x's dtype, f32 accumulation of AV, residual-post-norm."""
    H, Wd, C = x.shape
    win3 = (1, *window)
    shift = _shift(window, shifted)
    mask = W.mask_tensor((1, H, Wd), win3, shift, (1, valid_h, Wd), x.device)
    dt, hd = x.dtype, C // heads

    parts = W.window_partition(shift_roll(x[None], shift, forward=True), win3)
    n_win, wlen, _ = parts.shape
    q, k, v = _dense(parts, prm, "qkv", int8).view(n_win, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    qn = q * torch.rsqrt((q * q).float().sum(-1, keepdim=True) + 1e-12).to(dt)
    kn = k * torch.rsqrt((k * k).float().sum(-1, keepdim=True) + 1e-12).to(dt)
    attn = (qn.float() @ kn.float().transpose(-1, -2)) * scale + bias
    if mask is not None:
        nz, nh = mask.shape[:2]
        attn = (attn.view(nz, nh, -1, heads, wlen, wlen) + mask[:, :, None, None]).view(n_win, heads, wlen, wlen)
    probs = torch.softmax(attn, dim=-1).to(dt)
    out = (probs.float() @ v.float()).to(dt).transpose(1, 2).reshape(n_win, wlen, C)
    out = _dense(W.window_reverse(out, win3, (1, H, Wd)), prm, "proj", int8)
    out = shift_roll(out, shift, forward=False)
    x = x + _layernorm(out[0], prm, "norm1")
    m = _dense(F.gelu(_dense(x, prm, "Dense_0", int8), approximate="tanh"), prm, "Dense_1", int8)
    return x + _layernorm(m, prm, "norm2")


def swin_v1_block(x, prm, heads: int, window: tuple[int, int], shifted: bool, valid_h: int):
    """One V1 block on x (H, W, C) (padded as for ``swin_v2_block``): K2 rolls
    into the shifted frame, K1 runs the pre-norm block with the
    lat-absolute, lon-relative bias table and the shift mask, K2 rolls back."""
    H, Wd, _ = x.shape
    win3 = (1, *window)
    shift = _shift(window, shifted)
    mask = W.mask_tensor((1, H, Wd), win3, shift, (1, valid_h, Wd), x.device)
    bias = prm["rel_bias"][_table("earth_index", win3, x.device)].permute(2, 0, 1)  # (heads, wlen, wlen)
    args = ((prm["LayerNorm_0/scale"], prm["LayerNorm_0/bias"]), (prm["qkv/kernel"], prm["qkv/bias"]), bias, mask,
            (prm["proj/kernel"], prm["proj/bias"]), (prm["LayerNorm_1/scale"], prm["LayerNorm_1/bias"]),
            (prm["Dense_0/kernel"], prm["Dense_0/bias"], prm["Dense_1/kernel"], prm["Dense_1/bias"]), win3, heads)
    if FS.current() is not None:
        # lon-sharded: the block on the local chunk's window cover
        return FS.manual_swin_block(x[None], *args, shift=shift)[0]
    h = fused_swin_block(shift_roll(x[None], shift, forward=True), *args)
    return shift_roll(h, shift, forward=False)[0]


def _leaves(module: nn.Module) -> dict[str, torch.Tensor]:
    return {n.replace(".", "/"): p for n, p in module.named_parameters()}


class SwinBlock2D(nn.Module):
    """One V1 block with its own parameters (FengWu's fuser): window (wh, ww)
    as (1, wh, ww) of the 3D tools, a lat-absolute, lon-relative bias table
    shared by every window, MLP ratio 4; flax names."""

    def __init__(self, dim: int, heads: int, window: tuple[int, int], shifted: bool):
        super().__init__()
        self.heads = heads
        self.window = (1, *window)
        self.shifted = shifted
        self.LayerNorm_0 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.rel_bias = nn.Parameter(torch.empty(W.earth_bias_table_size(self.window), heads))

    def forward(self, x, valid_h: int):
        """x (H, W, C), H padded to a window multiple, rows from ``valid_h``
        on padding (masked as keys) → (H, W, C)."""
        return swin_v1_block(x, _leaves(self), self.heads, self.window[1:], self.shifted, valid_h)


# --- parameter holders: flax leaves, the trunk's stacked over the pairs --------


class Leaves(nn.Module):
    """flax leaves by name and shape (bf16), e.g. a Dense's ``kernel`` and
    ``bias``; stacked leaves carry the pairs' axis first."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=torch.bfloat16), requires_grad=False))


class BlockStack(nn.Module):
    """One half of the trunk's P pairs (``a``: unshifted, ``b``: shifted), its
    blocks' leaves stacked: Swin-V2's (``norm1``, ``norm2``, ``cpb_fc1``,
    ``cpb_fc2``, ``logit_scale``) or V1's (``LayerNorm_0``, ``LayerNorm_1``,
    ``rel_bias``), and both flavours' ``qkv``, ``proj``, ``Dense_0``,
    ``Dense_1``."""

    def __init__(self, P: int, dim: int, heads: int, window: tuple[int, int], v2: bool):
        super().__init__()
        C = dim
        self.qkv = Leaves(kernel=(P, C, 3 * C), bias=(P, 3 * C))
        self.proj = Leaves(kernel=(P, C, C), bias=(P, C))
        self.Dense_0 = Leaves(kernel=(P, C, 4 * C), bias=(P, 4 * C))
        self.Dense_1 = Leaves(kernel=(P, 4 * C, C), bias=(P, C))
        if v2:
            self.norm1 = Leaves(scale=(P, C), bias=(P, C))
            self.norm2 = Leaves(scale=(P, C), bias=(P, C))
            self.cpb_fc1 = Leaves(kernel=(P, 2, CPB_HIDDEN), bias=(P, CPB_HIDDEN))
            self.cpb_fc2 = Leaves(kernel=(P, CPB_HIDDEN, heads))
            self.register_parameter("logit_scale", nn.Parameter(torch.empty(P, heads, 1, 1, dtype=torch.bfloat16),
                                                                requires_grad=False))
        else:
            self.LayerNorm_0 = Leaves(scale=(P, C), bias=(P, C))
            self.LayerNorm_1 = Leaves(scale=(P, C), bias=(P, C))
            table = W.earth_bias_table_size((1, *window))
            self.register_parameter("rel_bias", nn.Parameter(torch.empty(P, table, heads, dtype=torch.bfloat16),
                                                             requires_grad=False))


class FuXiNet(nn.Module):
    """One cascade stage's parameters (flax names and layouts), which
    ``fuxi_forward`` runs."""

    def __init__(self, cfg: FuXiConfig, n_history: int = 2):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError("FuXi trunk depth must be even (shift pairs)")
        self.cfg = cfg
        p, D, Dc, P, nc = cfg.patch, cfg.embed_dim, cfg.cube_dim, cfg.depth // 2, cfg.in_channels
        self.cube_embed = Leaves(kernel=(p, p, n_history * nc, Dc), bias=(Dc,))
        self.down_norm = Leaves(scale=(4 * Dc,), bias=(4 * Dc,))
        self.down = Leaves(kernel=(4 * Dc, D))
        self.pairs = nn.ModuleDict({
            h: BlockStack(P, D, cfg.num_heads, cfg.window, cfg.attn_v2) for h in ("a", "b")
        })
        self.up = Leaves(kernel=(D, 4 * Dc))
        self.up_norm = Leaves(scale=(Dc,), bias=(Dc,))
        self.fuse = Leaves(kernel=(D, Dc), bias=(Dc,))
        self.head = Leaves(kernel=(p, p, Dc, nc), bias=(nc,))


def fuxi_forward(cfg: FuXiConfig, prm: dict, x: torch.Tensor, int8: dict | None = None) -> torch.Tensor:
    """One stage on x (hist·C, H, W) in the compute dtype → (C, H, W).

    ``prm``: the stage's leaves by flax path; ``int8``: the stage's int8
    collection (``{"pairs": {"a": {"qkv_q": …}, …}}``) or None.  The cube
    embedding and the head are one GEMM each (the head's kernel flipped
    spatially, flax ``ConvTranspose``), as the JAX package's fused path."""
    p, Dc, wh = cfg.patch, cfg.cube_dim, cfg.window[0]
    Cin, Hin, Win = x.shape
    Ht, Wt = -(-Hin // p), Win // p
    dt = x.dtype

    h = F.pad(x.permute(1, 2, 0), (0, 0, 0, 0, 0, (-Hin) % p))
    pt = h.reshape(Ht, p, Wt, p, Cin).permute(0, 2, 1, 3, 4).reshape(Ht * Wt, p * p * Cin)
    k = prm["cube_embed/kernel"]
    skip = (pt @ k.reshape(p * p * Cin, Dc).to(dt) + prm["cube_embed/bias"].to(dt)).view(Ht, Wt, Dc)

    # down: 2×2 patch merge to the trunk width
    He = Ht + Ht % 2
    Hd, Wd = He // 2, Wt // 2
    hd = F.pad(skip, (0, 0, 0, 0, 0, He - Ht)).reshape(Hd, 2, Wd, 2, Dc).permute(0, 2, 1, 3, 4)
    hd = _dense(_layernorm(hd.reshape(Hd, Wd, 4 * Dc), prm, "down_norm"), prm, "down")

    h = F.pad(hd, (0, 0, 0, 0, 0, (-Hd) % wh)).contiguous()
    halves = {s: {key[len(f"pairs/{s}/"):]: t for key, t in prm.items() if key.startswith(f"pairs/{s}/")}
              for s in ("a", "b")}
    q8 = {s: (int8 or {}).get("pairs", {}).get(s) for s in ("a", "b")}
    terms = {s: swin_v2_terms(halves[s], cfg.window) for s in ("a", "b")} if cfg.attn_v2 else None
    for i in range(cfg.depth // 2):
        for s, shifted in (("a", False), ("b", True)):
            blk = {key: t[i] for key, t in halves[s].items()}
            if cfg.attn_v2:
                blk8 = None if q8[s] is None else {key: t[i] for key, t in q8[s].items()}
                h = swin_v2_block(h, blk, terms[s][0][i], terms[s][1][i], cfg.num_heads, cfg.window, shifted, Hd,
                                  blk8)
            else:
                h = swin_v1_block(h, blk, cfg.num_heads, cfg.window, shifted, Hd)
    hd = h[:Hd]

    # up: 2×2 patch expand, the skip concatenated, fuse
    hu = _dense(hd, prm, "up").reshape(Hd, Wd, 2, 2, Dc).permute(0, 2, 1, 3, 4).reshape(He, Wt, Dc)[:Ht]
    h = _dense(torch.cat([_layernorm(hu, prm, "up_norm"), skip], dim=-1), prm, "fuse")

    kr = prm["head/kernel"]
    cout = kr.shape[-1]
    wr = kr.flip(0, 1).permute(2, 0, 1, 3).reshape(Dc, p * p * cout)
    y = (h.reshape(Ht * Wt, Dc) @ wr.to(dt)).view(Ht, Wt, p, p, cout) + prm["head/bias"].to(dt)
    y = y.permute(0, 2, 1, 3, 4).reshape(Ht * p, Wt * p, cout)
    return y[:Hin].permute(2, 0, 1)


def stage_tree(stage: FuXiNet) -> dict:
    """A stage's parameters as a nested flax-layout dict (the same tensors)."""
    return unflatten(_leaves(stage))


class FuXiModel(PrognosticModel):
    """FuXi on ``device`` (the card by default).

    ``params``: ``{"stages": [stage, …], "norm": {"mean", "std"}}``, a stage
    a ``FuXiNet``, or after ``quantize_params`` a tree with int8 leaves
    (at rest) or ``{"params": tree, "int8": collection}`` (serving)."""

    name = "fuxi"
    channels = ch.FUXI
    n_history = 2

    @property
    def lon_manual(self) -> bool:
        # the lon-sharded step (parallel/fused_shard.py) drives the V1
        # blocks' K1; Swin-V2 blocks step in the sharding layer's gather mode
        return not self.cfg.attn_v2

    @property
    def lon_shard_divisor(self) -> int:
        # lon shards must divide the half-resolution token width, so that
        # the trunk's 2×2 patch merge and expand stay local
        return self.cfg.tokens[1] // 2

    def __init__(self, cfg: FuXiConfig | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or FuXiConfig()
        self.grid = LatLonGrid(self.cfg.lat, self.cfg.lon)
        if self.cfg.in_channels != len(self.channels):
            self.channels = tuple(f"c{i:02d}" for i in range(self.cfg.in_channels))

    def new_net(self) -> FuXiNet:
        """A stage's parameter holders on the meta device (no storage):
        ``init_params`` and ``params.from_jax`` assign each leaf."""
        with torch.device("meta"):
            return FuXiNet(self.cfg, self.n_history)

    def _initial(self, path: str, shape, generator) -> torch.Tensor:
        """flax's initialiser of one leaf, drawn on the generator's device in
        f32: kernels lecun_normal (truncated; a stacked trunk kernel's fan-in
        counts one layer, ``nn.scan`` initialises each alone), ``rel_bias``
        truncated_normal(0.02), ``logit_scale`` log 10, LayerNorm scales
        ones, the rest zeros."""
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(shape[1:-1] if path.startswith("pairs/") else shape[:-1])
            return _truncated_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
        if leaf == "rel_bias":
            return _truncated_normal(shape, 0.02, generator)
        if leaf == "logit_scale":
            return torch.full(shape, math.log(10.0), device=generator.device)
        if leaf == "scale":
            return torch.ones(shape, device=generator.device)
        return torch.zeros(shape, device=generator.device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator | None = None):
        """Random parameters from ``generator`` (seed 0 on the CPU by
        default), drawn on its device leaf by leaf in sorted flax-path
        order, each cast to bf16 and moved to the model's device at once:
        no stage is ever held in f32."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        stages = []
        for _ in range(self.cfg.n_stages):
            net = self.new_net()
            state = {name: self._initial(name.replace(".", "/"), tuple(p.shape), g).to(torch.bfloat16).to(self.device)
                     for name, p in sorted(net.named_parameters())}
            net.load_state_dict(state, strict=True, assign=True)
            stages.append(net.eval())
        return {"stages": stages, "norm": make_norm_params(self.cfg.in_channels, device=self.device)}

    def floor_params(self, params):
        """The parameters one step reads: one stage and the norm stats."""
        return {"stages": list(params["stages"][:1]), "norm": params["norm"]}

    def trim_stages(self, params, n_steps: int):
        """Drop the cascade stages a rollout of ``n_steps`` never reaches."""
        k = max(1, min(-(-n_steps // self.cfg.stage_steps), self.cfg.n_stages))
        return {**params, "stages": list(params["stages"][:k])}

    def quantize_params(self, params, min_size: int = 65536, serve_int8: bool = False):
        """Weight-only int8 at rest for the stages (the norm stats stay
        exact); ``_forward`` dequantizes only the stage a step takes.
        ``serve_int8`` also moves the trunk's qkv, proj and MLP kernels into
        the ``int8`` collection, which the Swin-V2 blocks run through
        ``int8_dot``: those kernels never exist in bf16 again."""
        if serve_int8 and not self.cfg.attn_v2:
            raise ValueError(
                "serve_int8 requires attn_v2=True (the Swin-V2 block is the int8-collection consumer); "
                "use the at-rest tier (serve_int8=False) for V1-style configs"
            )
        trees = [stage_tree(s) if isinstance(s, nn.Module) else s for s in params["stages"]]
        if not serve_int8:
            return {**params, "stages": [quantize_tree(t, min_size) for t in trees]}
        stages = []
        for t in trees:
            rest, int8 = split_dense_int8(t, min_size=min_size)
            stages.append({"params": quantize_tree(rest, min_size), "int8": int8 or {}})
        return {**params, "stages": stages}

    def _forward(self, stage, params, x):
        """One stage on the 2-frame state x (2, C, H, W): the residual in
        normalised space, in f32."""
        if isinstance(stage, nn.Module):
            prm, int8 = _leaves(stage), None
        elif "int8" in stage:
            prm, int8 = flatten(maybe_dequantize(stage["params"])), stage["int8"]
        else:
            prm, int8 = flatten(maybe_dequantize(stage)), None
        norm = params["norm"]
        xn = normalize(norm, x).to(self.compute_dtype)
        y = fuxi_forward(self.cfg, prm, xn.reshape(-1, *x.shape[-2:]), int8).float()
        return denormalize(norm, normalize(norm, x[-1]) + y)

    def apply(self, params, x):
        return self._forward(params["stages"][0], params, x)[None]

    @torch.no_grad()
    def advance(self, params, state: ModelState):
        """The cascade: stage ``min(step // stage_steps, resident − 1)`` by the
        Python int step (one resident stage needs no choice)."""
        stages = params["stages"]
        k = 0 if len(stages) == 1 else min(state.step // self.cfg.stage_steps, len(stages) - 1)
        y = self._forward(stages[k], params, state.x)
        new_x = torch.cat([state.x, y[None]], dim=0)[-self.n_history:]
        return state.replace(x=new_x, step=state.step + 1, time_days=state.time_days + self._step_days), y[None]

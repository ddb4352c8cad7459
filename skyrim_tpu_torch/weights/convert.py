"""Checkpoint → flax-layout tree, for every model (a numpy copy of
skyrim_tpu/weights/convert.py).

The mapping is explicit per architecture, so a converted tree lines up
with the tree ``params.from_jax`` reads: Dense kernels (in, out), flax
convolution layouts, Pangu's earth-bias tables in the
``ops.windows.earth_bias_index`` bijection.  The inputs: a torch state
dict, an ONNX artifact (Pangu, FuXi and FengWu are published so; read by
weights/onnx_io.py, a traced export's names recovered from its topology
by weights/onnx_rename.py), and for GraphCast the official Haiku
parameter dict.

Network egress is unavailable in this build environment, so these run
only when a user stages files locally; every converter is exercised in
tests against synthetic state dicts.
"""

from __future__ import annotations

import difflib
import itertools
import re
from pathlib import Path
from typing import Mapping

import numpy as np

from skyrim_tpu_torch.ops.windows import earth_bias_index, earth_bias_table_size
from skyrim_tpu_torch.utils.logging import logger


def _t(x) -> np.ndarray:
    """torch tensor (cpu) → numpy."""
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def convert_linear(sd: Mapping, prefix: str) -> dict:
    """torch nn.Linear → flax Dense: weight is transposed."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def convert_layernorm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def convert_conv2d(sd: Mapping, prefix: str) -> dict:
    """torch Conv2d (O, I, kh, kw) → flax Conv (kh, kw, I, O)."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def convert_conv3d(sd: Mapping, prefix: str) -> dict:
    """torch Conv3d (O, I, kd, kh, kw) → flax Conv (kd, kh, kw, I, O)."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 4, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def convert_convtranspose2d(sd: Mapping, prefix: str) -> dict:
    """torch ConvTranspose2d (I, O, kh, kw) → flax ConvTranspose (kh, kw, I, O)."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 0, 1)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def convert_convtranspose3d(sd: Mapping, prefix: str) -> dict:
    """torch ConvTranspose3d (I, O, kd, kh, kw) → flax (kd, kh, kw, I, O)."""
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 3, 4, 0, 1)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _zeros_bias(d: dict, features: int) -> dict:
    d.setdefault("bias", np.zeros((features,), np.float32))
    return d


def _linear_zb(sd: Mapping, p: str) -> dict:
    """Linear with a zero bias filled in when the source has none
    (Swin qkv / PatchMerging reduction are often bias-free)."""
    d = convert_linear(sd, p)
    return _zeros_bias(d, d["kernel"].shape[1])


def expand_swin_rel_bias(table: np.ndarray, window: tuple[int, int]) -> np.ndarray:
    """Standard Swin 2D relative table ((2wh−1)(2ww−1), heads) → the
    lat-absolute, lon-relative table (wh²(2ww−1), heads) of
    ``earth_bias_index((1, wh, ww))``."""
    wh, ww = window
    hq, hk = np.meshgrid(np.arange(wh), np.arange(wh), indexing="ij")
    rel_h = (hq - hk + wh - 1).ravel()  # (wh²,) indexed by hq·wh + hk
    rows = rel_h[:, None] * (2 * ww - 1) + np.arange(2 * ww - 1)[None, :]
    return table[rows.ravel()]  # (wh²·(2ww−1), heads)


def _swin_block(sd: Mapping, p: str, window: tuple[int, int]) -> dict:
    """One ``SwinBlock2D`` (models/fuxi.py) from torch Swin naming:
    norm1/norm2, attn.{qkv,proj,relative_position_bias_table}, mlp.{fc1,fc2}."""
    return {
        "LayerNorm_0": convert_layernorm(sd, f"{p}.norm1"),
        "LayerNorm_1": convert_layernorm(sd, f"{p}.norm2"),
        "qkv": _linear_zb(sd, f"{p}.attn.qkv"),
        "proj": _linear_zb(sd, f"{p}.attn.proj"),
        "rel_bias": expand_swin_rel_bias(_t(sd[f"{p}.attn.relative_position_bias_table"]), window),
        "Dense_0": convert_linear(sd, f"{p}.mlp.fc1"),
        "Dense_1": convert_linear(sd, f"{p}.mlp.fc2"),
    }


def pangu_bias_permutation(window: tuple[int, int, int]) -> np.ndarray:
    """perm such that ``ours_table = official_table[..., perm]``.

    Official Pangu (Bi et al. 2023 pseudocode) encodes the (query, key)
    pair along z as ``z_q + wz·z_k`` and along lat as ``h_q + wh·h_k``;
    ops/windows.earth_bias_index uses ``z_q·wz + z_k`` / ``h_q·wh + h_k``.
    Both are bijections onto the same table size wz²·wh²·(2ww−1).
    """
    wz, wh, ww = window
    z1, h1, w1 = np.meshgrid(np.arange(wz), np.arange(wh), np.arange(ww), indexing="ij")
    pos = np.stack([z1.ravel(), h1.ravel(), w1.ravel()], -1)  # (wlen, 3)
    dz = pos[:, None, 0] + wz * pos[None, :, 0]
    dh = pos[:, None, 1] + wh * pos[None, :, 1]
    dw = pos[:, None, 2] - pos[None, :, 2] + (ww - 1)
    official = (dz * (wh * wh) + dh) * (2 * ww - 1) + dw
    perm = np.zeros((earth_bias_table_size(window),), np.int64)
    perm[earth_bias_index(window).ravel()] = official.ravel()
    return perm


class _TrackedSD(Mapping):
    """Mapping wrapper that records consumed keys and fails loudly: a
    missing key raises with the nearest available names, and ``report``
    lists every tensor the converter never consumed, so a renamed or
    folded export surfaces at once instead of as a silent garbage
    forecast."""

    def __init__(self, sd: Mapping):
        self._sd = sd
        self.consumed: set[str] = set()

    def __getitem__(self, k):
        if k not in self._sd:
            near = difflib.get_close_matches(k, list(self._sd), n=3, cutoff=0.4)
            raise KeyError(f"checkpoint has no tensor {k!r}; nearest available: {near} ({len(self._sd)} tensors total)")
        self.consumed.add(k)
        return self._sd[k]

    def __contains__(self, k):
        present = k in self._sd
        if present:
            self.consumed.add(k)
        return present

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)

    def report(self, model_name: str):
        unconsumed = sorted(set(self._sd) - self.consumed)
        if unconsumed:
            shown = ", ".join(unconsumed[:12])
            more = f" (+{len(unconsumed) - 12} more)" if len(unconsumed) > 12 else ""
            logger.warning(
                "%s converter left %d/%d checkpoint tensors unconsumed: %s%s",
                model_name, len(unconsumed), len(self._sd), shown, more,
            )


def convert_torch_file(model, path: str | Path) -> dict:
    """Convert a torch-loadable state dict OR an ONNX artifact (``.onnx``,
    its initializers read straight from the protobuf by weights/onnx_io.py)
    staged at ``path`` for ``model`` (dispatch by model name).  A traced
    export's exporter-named initializers are renamed from the graph's
    topology for FengWu; FuXi's cascade (one file a stage) goes through
    ``convert_fuxi_onnx_cascade``.  Every key the converter touches is
    tracked: missing keys raise with nearest-name suggestions, unconsumed
    tensors are reported after conversion."""
    path = Path(path)
    if path.suffix.lower() == ".onnx":
        from skyrim_tpu_torch.weights.onnx_io import read_onnx_graph, read_onnx_initializers
        from skyrim_tpu_torch.weights.onnx_rename import looks_exporter_named, rename_fengwu_graph

        sd = read_onnx_initializers(path)
        if looks_exporter_named(sd):
            # traced export: recover state-dict names from the topology
            graph = read_onnx_graph(path)
            if model.name == "fengwu":
                sd = rename_fengwu_graph(graph, model.cfg, model.n_history)
            elif model.name == "fuxi":
                raise ValueError(
                    "FuXi ships one traced ONNX per cascade stage (short/medium/long); pass all of them to "
                    "convert_fuxi_onnx_cascade(model, [paths...]) instead of convert_torch_file with a single file"
                )
            else:
                logger.warning(
                    "%s: exporter-named ONNX initializers and no rename pass for this family — conversion will "
                    "likely fail with missing keys", model.name,
                )
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    logger.info("converting %d tensors for %s", len(sd), model.name)
    converter = CONVERTERS.get(model.name)
    if converter is None:
        raise NotImplementedError(f"no converter for {model.name!r}")
    tracked = _TrackedSD(sd)
    out = converter(model, tracked)
    tracked.report(model.name)
    return out


def _norm_params(n_channels: int, mean=None, std=None) -> dict:
    """Per-channel normalization stats (C, 1, 1), numpy."""
    mean = np.zeros((n_channels,), np.float32) if mean is None else np.asarray(mean, np.float32)
    std = np.ones((n_channels,), np.float32) if std is None else np.asarray(std, np.float32)
    return {"mean": mean[:, None, None], "std": std[:, None, None]}


def _convert_norm_stats(sd: Mapping, n_channels: int, prefix: str = "") -> dict | None:
    """Pull per-channel normalization stats if the checkpoint carries them."""
    for mk, sk in (("means", "stds"), ("center", "scale"), ("mean", "std")):
        mk, sk = prefix + mk, prefix + sk
        if mk in sd and sk in sd:
            mean = _t(sd[mk]).reshape(-1)[:n_channels]
            std = _t(sd[sk]).reshape(-1)[:n_channels]
            return _norm_params(n_channels, mean, std)
    return None


def sd_get(sd: Mapping, *keys: str):
    for k in keys:
        if k in sd:
            return sd[k]
    raise KeyError(keys[0])


def convert_dlwp(model, sd: Mapping) -> dict:
    """DLWP cubed-sphere U-Net (modulus-style naming ``blocks.{i}.conv1/2``,
    ``head``) → the CubeUNet tree."""
    n_blocks = sum(1 for k in sd if k.startswith("blocks.") and k.endswith(".conv1.weight"))
    net = {
        f"CSConvBlock_{i}": {
            "Conv_0": convert_conv2d(sd, f"blocks.{i}.conv1"),
            "Conv_1": convert_conv2d(sd, f"blocks.{i}.conv2"),
        }
        for i in range(n_blocks)
    }
    net["Conv_0"] = convert_conv2d(sd, "head")
    nc = len(model.channels)
    return {"net": net, "norm": _convert_norm_stats(sd, nc) or _norm_params(nc)}


def convert_pangu(model, sd: Mapping) -> dict:
    """Pangu-Weather state dict (official-pseudocode naming:
    input_layer.conv_surface / conv_upper, layers.{s}.blocks.{b}.*,
    downsample/upsample, output_layer.conv_*) → the flax-layout tree.

    Keys prefixed ``net6.`` / ``net24.`` select the 6 h / 24 h networks;
    unprefixed keys convert a single network into ``net6``.
    """
    cfg = model.cfg
    nets = {}
    for net_key in ("net6", "net24"):
        pre = f"{net_key}."
        sub = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        if sub:
            nets[net_key] = sub
    if not nets:
        nets["net6"] = dict(sd)

    perm = pangu_bias_permutation(cfg.window)

    def one_net(s: Mapping) -> dict:
        net = {
            "embed_surface": convert_conv2d(s, "input_layer.conv_surface"),
            "embed_upper": convert_conv3d(s, "input_layer.conv_upper"),
            "recover_surface": convert_convtranspose2d(s, "output_layer.conv_surface"),
            "recover_upper": convert_convtranspose3d(s, "output_layer.conv_upper"),
        }
        blk = 0
        for stage, depth in enumerate(cfg.depths):
            for b in range(depth):
                p = f"layers.{stage}.blocks.{b}"
                # official bias layout (table, n_types, heads) → ours
                # (n_types, heads, table) in the windows.py bijection
                eb = _t(sd_get(s, f"{p}.attn.earth_bias", f"{p}.attn.earth_specific_bias"))
                net[f"PanguBlock_{blk}"] = {
                    "LayerNorm_0": convert_layernorm(s, f"{p}.norm1"),
                    "LayerNorm_1": convert_layernorm(s, f"{p}.norm2"),
                    "Dense_0": convert_linear(s, f"{p}.mlp.fc1"),
                    "Dense_1": convert_linear(s, f"{p}.mlp.fc2"),
                    "EarthAttention3D_0": {
                        "qkv": _linear_zb(s, f"{p}.attn.qkv"),
                        "proj": _linear_zb(s, f"{p}.attn.proj"),
                        "earth_bias": eb.transpose(1, 2, 0)[..., perm],
                    },
                }
                blk += 1
        # PatchMerging: torch concat order (h0w0, h1w0, h0w1, h1w1) →
        # our reshape order (h0w0, h0w1, h1w0, h1w1): permute row blocks
        red = _linear_zb(s, "downsample.reduction")
        k = red["kernel"]
        c = k.shape[0] // 4
        red["kernel"] = k.reshape(4, c, -1)[[0, 2, 1, 3]].reshape(k.shape)
        net["DownSample_0"] = {"Dense_0": red, "LayerNorm_0": convert_layernorm(s, "downsample.norm")}
        net["UpSample_0"] = {
            "Dense_0": _linear_zb(s, "upsample.expand"),
            "LayerNorm_0": convert_layernorm(s, "upsample.norm"),
        }
        return net

    nc = len(model.channels)
    params = {k: one_net(s) for k, s in nets.items()}
    params["norm"] = _convert_norm_stats(sd, nc) or _norm_params(nc)
    H, W = model.grid.shape
    params["consts"] = _t(sd["consts"]) if "consts" in sd else np.zeros((cfg.const_masks, H, W), np.float32)
    if model.variant == "pangu" and "net24" not in params:
        logger.warning("no net24.* keys — reusing the 6h network for 24h steps")
        params["net24"] = params["net6"]
    return params


def convert_graphcast_haiku(model, hk: Mapping) -> dict:
    """GraphCast from the OFFICIAL haiku parameter naming → the flax-layout
    tree.

    The released DeepMind checkpoints are haiku param dicts whose module
    paths come from ``deep_typed_graph_net._networks_builder``: three GNNs
    (``grid2mesh_gnn``, ``mesh_gnn``, ``mesh2grid_gnn``), each building
    MLPs named ``{encoder|processor|decoder}_{edges|nodes}…`` with the
    edge/node-set name and (for processors) a step index embedded, each
    MLP exposing ``linear_0``/``linear_1`` (+ ``layer_norm``) leaves
    with haiku ``w``/``b``/``scale``/``offset`` params — already in
    (in, out) orientation, so NO transpose (unlike torch).

    Accepted input shapes: the nested haiku dict
    ``{module_path: {param: array}}`` or its flat npz form
    ``{f"{module_path}/{param}": array}``.  Module paths are classified
    STRUCTURALLY (gnn name + role + edges/nodes + set-name + step-index
    tokens), tolerating separator/suffix drift (``~``,
    ``~_networks_builder``, ``_mlp``) between exporter versions; every
    source module must classify and every target slot must fill, or the
    converter raises listing the leftovers.

    Concat-order assumptions (documented, asserted by shape): edge MLPs
    take concat([edge, src, dst]); node MLPs take concat([node, agg]) —
    the order models/graphcast.py factors.
    """
    cfg = model.cfg

    # -- normalize to nested {path: {param: arr}} -------------------------
    nested: dict[str, dict] = {}
    norm_extra = {}
    for k, v in hk.items():
        if isinstance(v, Mapping):
            nested[k] = dict(v)
        elif k in ("norm_mean", "norm_std", "mean", "std", "means", "stds"):
            norm_extra[k] = v
        else:
            path, _, param = k.rpartition("/")
            nested.setdefault(path, {})[param] = v

    # -- classify every module path --------------------------------------
    def classify(path: str):
        p = path.lower()
        if "grid2mesh_gnn" in p:
            gnn = "g2m"
        elif "mesh2grid_gnn" in p:
            gnn = "m2g"
        elif "mesh_gnn" in p:
            gnn = "mesh"
        else:
            return None
        role = ("encoder" if "encoder" in p else
                "decoder" if "decoder" in p else
                "processor" if "processor" in p else None)
        kind = "edges" if "edges" in p else "nodes" if "nodes" in p else None
        # which node set (strip the gnn module token first so the
        # 'mesh'/'grid' in e.g. 'grid2mesh_gnn' doesn't match)
        tail = re.sub(r"\w*gnn", "", p)
        nset = ("grid_nodes" if "grid_nodes" in tail else
                "mesh_nodes" if "mesh_nodes" in tail else None)
        layer = None
        m = re.search(r"linear_(\d+)", p)
        if m:
            layer = f"linear_{m.group(1)}"
        elif "layer_norm" in p or "layernorm" in p:
            layer = "layer_norm"
        step = None
        ms = re.findall(r"_(\d+)(?:_|/|$)", re.sub(r"linear_\d+", "", p))
        if ms:
            step = int(ms[0])
        if role is None or kind is None:
            return None
        return gnn, role, kind, nset, step, layer

    def target_for(gnn, role, kind, nset, step):
        if gnn == "g2m":
            if role == "encoder" and kind == "nodes":
                return ("embed_grid",) if nset == "grid_nodes" else ("embed_mesh",)
            if role == "encoder" and kind == "edges":
                return ("g2m", "edge_embed")
            if role == "processor" and kind == "edges":
                return ("g2m", "message")
            if role == "processor" and kind == "nodes":
                return ("g2m", "MLP_0") if nset == "mesh_nodes" else ("grid_update",)
        if gnn == "mesh":
            if role == "encoder" and kind == "edges":
                return ("embed_mm",)
            if role == "processor" and kind == "edges":
                return (f"round_{step}", "MLP_0")
            if role == "processor" and kind == "nodes":
                return (f"round_{step}", "MLP_1")
        if gnn == "m2g":
            if role == "encoder" and kind == "edges":
                return ("m2g", "edge_embed")
            if role == "processor" and kind == "edges":
                return ("m2g", "message")
            if role == "processor" and kind == "nodes":
                return ("m2g", "MLP_0")
            if role == "decoder" and kind == "nodes":
                return ("head",)
        return None

    net: dict = {}
    unmatched = []
    for path, leaves in nested.items():
        c = classify(path)
        if c is None:
            unmatched.append(path)
            continue
        gnn, role, kind, nset, step, layer = c
        tgt = target_for(gnn, role, kind, nset, step)
        if tgt is None or layer is None:
            unmatched.append(path)
            continue
        d = net
        for part in tgt:
            d = d.setdefault(part, {})
        if layer == "layer_norm":
            d["LayerNorm_0"] = {"scale": _t(leaves["scale"]), "bias": _t(leaves["offset"])}
        else:
            idx = layer.split("_")[1]
            d[f"Dense_{idx}"] = {
                "kernel": _t(leaves["w"]),  # haiku: already (in, out)
                **({"bias": _t(leaves["b"])} if "b" in leaves else
                   {"bias": np.zeros((np.asarray(leaves["w"]).shape[1],), np.float32)}),
            }
    if unmatched:
        raise ValueError(f"convert_graphcast_haiku: {len(unmatched)} module paths did not classify: {unmatched[:8]}")
    expected = (
        {"embed_grid", "embed_mesh", "embed_mm", "g2m", "m2g", "grid_update", "head"}
        | {f"round_{i}" for i in range(cfg.processor_rounds)}
    )
    missing = expected - set(net)
    if missing:
        raise ValueError(f"convert_graphcast_haiku: checkpoint lacks modules for {sorted(missing)}")
    nc = cfg.in_channels
    return {"net": net, "norm": _convert_norm_stats({**norm_extra}, nc) or _norm_params(nc)}


def convert_graphcast(model, sd: Mapping) -> dict:
    """GraphCast → the flax-layout tree.  Dispatches on the input's shape:
    official haiku module paths (nested dicts or '/'-joined flat keys — see
    :func:`convert_graphcast_haiku`) convert directly; otherwise the
    torch-Linear-orientation flat naming ({grid,mesh,mm}_embed, g2m/m2g
    {edge_embed,message,update}, processor.{i}.{edge,node}, grid_update,
    head — each an MLP with fc1/fc2[/ln]) is used.  The message MLP's fc1
    must be packed over concat([edge, src, dst], axis=-1), the order the
    model factors."""
    # peek at the underlying mapping so the dispatch probe does not mark
    # tensors consumed (would weaken the unconsumed-tensor report)
    raw = getattr(sd, "_sd", sd)
    if any(isinstance(v, Mapping) or "gnn" in str(k) for k, v in itertools.islice(raw.items(), 50)):
        return convert_graphcast_haiku(model, sd)
    cfg = model.cfg

    def mlp(p: str, final_norm: bool = True) -> dict:
        d = {"Dense_0": convert_linear(sd, f"{p}.fc1"), "Dense_1": convert_linear(sd, f"{p}.fc2")}
        if final_norm:
            d["LayerNorm_0"] = convert_layernorm(sd, f"{p}.ln")
        return d

    def bipartite(p: str) -> dict:
        return {"edge_embed": mlp(f"{p}.edge_embed"), "message": mlp(f"{p}.message"), "MLP_0": mlp(f"{p}.update")}

    net = {
        "embed_grid": mlp("grid_embed"),
        "embed_mesh": mlp("mesh_embed"),
        "embed_mm": mlp("mm_embed"),
        "g2m": bipartite("g2m"),
        "m2g": bipartite("m2g"),
        "grid_update": mlp("grid_update"),
        "head": mlp("head", final_norm=False),
    }
    for i in range(cfg.processor_rounds):
        net[f"round_{i}"] = {"MLP_0": mlp(f"processor.{i}.edge"), "MLP_1": mlp(f"processor.{i}.node")}
    nc = cfg.in_channels
    return {"net": net, "norm": _convert_norm_stats(sd, nc) or _norm_params(nc)}


def _conv1x1_as_dense(sd: Mapping, prefix: str) -> dict:
    """torch 1×1 Conv2d (O, I, 1, 1) → flax Dense (I, O)."""
    out = {"kernel": _t(sd[f"{prefix}.weight"])[:, :, 0, 0].T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def convert_sfno(model, sd: Mapping) -> dict:
    """FourCastNet v2 (fcnv2_sm) state dict in the official sfnonet naming,
    a DDP ``module.`` prefix allowed: ``pos_embed`` (1, C, H, W);
    ``encoder.{0,2}``/``decoder.{0,2}`` 1×1 convs; ``blocks.{i}.norm0``,
    ``norm1`` instance-norm affines; ``blocks.{i}.filter.filter.w.{l}``
    (C_l, C_{l+1}, 2) and ``.wout`` (hidden, C, 2); ``blocks.{i}.inner_skip``
    only on the resolution-preserving blocks (a mismatch raises);
    ``blocks.{i}.mlp.fwd.{0,2}`` → the flax-layout tree."""
    cfg = model.cfg
    raw = getattr(sd, "_sd", sd)  # probe the prefix without marking tensors consumed
    pre = "module." if any(str(k).startswith("module.") for k in raw) else ""
    net = {
        "encoder_fc1": _conv1x1_as_dense(sd, f"{pre}encoder.0"),
        "encoder_fc2": _conv1x1_as_dense(sd, f"{pre}encoder.2"),
        "decoder_fc1": _conv1x1_as_dense(sd, f"{pre}decoder.0"),
        "decoder_fc2": _conv1x1_as_dense(sd, f"{pre}decoder.2"),
    }
    if cfg.use_pos_embed:
        net["pos_embed"] = _t(sd[f"{pre}pos_embed"])[0].transpose(1, 2, 0)
    for i in range(cfg.num_layers):
        p = f"{pre}blocks.{i}"
        filt = {f"w{l}": _t(sd[f"{p}.filter.filter.w.{l}"]) for l in range(cfg.spectral_layers)}
        filt["wout"] = _t(sd[f"{p}.filter.filter.wout"])
        blk = {
            "norm0_scale": _t(sd[f"{p}.norm0.weight"]),
            "norm0_bias": _t(sd[f"{p}.norm0.bias"]),
            "norm1_scale": _t(sd[f"{p}.norm1.weight"]),
            "norm1_bias": _t(sd[f"{p}.norm1.bias"]),
            "filter": filt,
            "mlp_fc1": _conv1x1_as_dense(sd, f"{p}.mlp.fwd.0"),
            "mlp_fc2": _conv1x1_as_dense(sd, f"{p}.mlp.fwd.2"),
        }
        has_skip = f"{p}.inner_skip.weight" in sd
        if has_skip != cfg.has_skips(i):
            raise ValueError(
                f"fcnv2 block {i}: checkpoint {'has' if has_skip else 'lacks'} inner_skip but the "
                "architecture expects the opposite — config/checkpoint mismatch"
            )
        if has_skip:
            blk["inner_skip"] = _conv1x1_as_dense(sd, f"{p}.inner_skip")
        net[f"block_{i}"] = blk
    nc = cfg.in_channels
    return {"net": net, "norm": _convert_norm_stats(sd, nc, pre) or _norm_params(nc)}


def convert_fengwu(model, sd: Mapping) -> dict:
    """FengWu state dict (``encoders.{g}`` Conv2d and ``decoders.{g}``
    ConvTranspose2d per variable group, g = 0 the surface, then one per
    upper-air variable; ``fuse_in`` Linear; ``fuser.{i}`` Swin blocks, see
    ``_swin_block``; optional ``means``/``stds``) → the flax-layout tree."""
    cfg = model.cfg
    net = {"fuse_in": convert_linear(sd, "fuse_in")}
    for g in range(1 + cfg.level_vars):
        net[f"enc_{g}"] = convert_conv2d(sd, f"encoders.{g}")
        net[f"dec_{g}"] = convert_convtranspose2d(sd, f"decoders.{g}")
    for i in range(cfg.depth):
        net[f"fuser_{i}"] = _swin_block(sd, f"fuser.{i}", cfg.window)
    nc = cfg.in_channels
    return {"net": net, "norm": _convert_norm_stats(sd, nc) or _norm_params(nc)}


def fengwu_config_from_sd(sd: Mapping, lat: int = 721, lon: int = 1440, n_history: int = 2):
    """FengWuConfig's widths read from a torch-named FengWu state dict's
    tensor shapes rather than assumed."""
    from skyrim_tpu_torch.models.fengwu import FengWuConfig

    md, hs, p, _ = np.shape(sd["encoders.0.weight"])  # (md, hist·surface, p, p)
    D, n_modal = np.shape(sd["fuse_in.weight"])  # (D, groups·md)
    n_groups = n_modal // md
    levels = np.shape(sd["encoders.1.weight"])[1] // n_history if n_groups > 1 else 13
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("fuser."))
    n_rel, heads = np.shape(sd["fuser.0.attn.relative_position_bias_table"])
    window = next(
        (w for w in ((6, 12), (4, 8), (8, 16), (2, 4), (3, 6), (7, 14), (2, 2))
         if earth_bias_table_size((1, *w)) == n_rel),
        None,
    )
    if window is None:
        raise ValueError(f"cannot infer fuser window from bias table rows {n_rel}")
    return FengWuConfig(
        lat=lat, lon=lon, levels=int(levels), surface_channels=int(hs // n_history),
        level_vars=int(n_groups - 1), modal_dim=int(md), fuser_dim=int(D), depth=int(depth),
        num_heads=int(heads), window=window, patch=int(p),
    )


def load_fengwu_from_artifact(path: str | Path, lat: int = 721, lon: int = 1440, device="cuda"):
    """(model, flax-layout tree) for a FengWu artifact staged at ``path``:
    the released ONNX (a traced export's names recovered from its
    topology, its configuration from the graph's shapes) or a torch state
    dict (its configuration read from its tensor shapes)."""
    from skyrim_tpu_torch.models.fengwu import FengWuModel

    path = Path(path)
    if path.suffix.lower() == ".onnx":
        from skyrim_tpu_torch.weights.onnx_io import read_onnx_graph
        from skyrim_tpu_torch.weights.onnx_rename import (
            fengwu_config_from_graph,
            looks_exporter_named,
            rename_fengwu_graph,
        )

        graph = read_onnx_graph(path)
        if looks_exporter_named(graph["initializers"]):
            cfg = fengwu_config_from_graph(graph, lat=lat, lon=lon)
            sd = rename_fengwu_graph(graph, cfg, n_history=2)
        else:
            sd = graph["initializers"]
            cfg = fengwu_config_from_sd(sd, lat=lat, lon=lon)
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
        cfg = fengwu_config_from_sd(sd, lat=lat, lon=lon)
    model = FengWuModel(cfg, device=device)
    tracked = _TrackedSD(sd)
    tree = convert_fengwu(model, tracked)
    tracked.report(model.name)
    return model, tree


def convert_afno(model, sd: Mapping) -> dict:
    """FourCastNet AFNO state dict (modulus layout: ``patch_embed.proj``,
    ``pos_embed`` (1, Ht·Wt, D), ``blocks.{i}.{norm1,norm2,mlp.fc1,mlp.fc2}``,
    ``blocks.{i}.filter.{w1,b1,w2,b2}`` with the real and imaginary parts
    stacked first, ``norm``, ``head``) → the flax-layout tree."""
    cfg = model.cfg
    nb, bs = cfg.num_blocks, cfg.embed_dim // cfg.num_blocks
    net = {
        "patch_embed": convert_conv2d(sd, "patch_embed.proj"),
        "pos_embed": _t(sd["pos_embed"]).reshape(*cfg.tokens, cfg.embed_dim),
        "head": convert_linear(sd, "head"),
        "LayerNorm_0": convert_layernorm(sd, "norm"),
    }
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        mixer = {}
        for w, shape in (("w1", (nb, bs, bs)), ("b1", (nb, bs)), ("w2", (nb, bs, bs)), ("b2", (nb, bs))):
            t = _t(sd[f"{p}.filter.{w}"])
            mixer[f"{w}_r"], mixer[f"{w}_i"] = t[0].reshape(shape), t[1].reshape(shape)
        net[f"block_{i}"] = {
            "LayerNorm_0": convert_layernorm(sd, f"{p}.norm1"),
            "LayerNorm_1": convert_layernorm(sd, f"{p}.norm2"),
            "Dense_0": convert_linear(sd, f"{p}.mlp.fc1"),
            "Dense_1": convert_linear(sd, f"{p}.mlp.fc2"),
            "AFNOMixer_0": dict(sorted(mixer.items())),
        }
    nc = cfg.in_channels
    return {"net": net, "norm": _convert_norm_stats(sd, nc) or _norm_params(nc)}


def _stack(trees: list[dict]) -> dict:
    """Identical trees stacked leaf by leaf (leading axis the block): the
    layout of a scanned trunk."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict) else np.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _swin_v2_block(sd: Mapping, p: str) -> dict:
    """One Swin-V2 block (models/fuxi.py ``swin_v2_block``) from torch Swin-V2
    naming: norm1/norm2 (the post-norms), attn.{qkv,proj,logit_scale},
    attn.cpb_mlp.{0,2} (the continuous-position-bias MLP), mlp.{fc1,fc2}.
    The qkv bias as one ``attn.qkv.bias``, or split as the official
    ``q_bias``/``v_bias`` with a zero k bias, or absent (zeros)."""
    qkv = {"kernel": _t(sd[f"{p}.attn.qkv.weight"]).T}
    C = qkv["kernel"].shape[0]
    if f"{p}.attn.qkv.bias" in sd:
        qkv["bias"] = _t(sd[f"{p}.attn.qkv.bias"])
    elif f"{p}.attn.q_bias" in sd:
        qkv["bias"] = np.concatenate(
            [_t(sd[f"{p}.attn.q_bias"]), np.zeros((C,), np.float32), _t(sd[f"{p}.attn.v_bias"])]
        )
    else:
        qkv["bias"] = np.zeros((3 * C,), np.float32)
    return {
        "norm1": convert_layernorm(sd, f"{p}.norm1"),
        "norm2": convert_layernorm(sd, f"{p}.norm2"),
        "qkv": qkv,
        "proj": _linear_zb(sd, f"{p}.attn.proj"),
        "logit_scale": _t(sd[f"{p}.attn.logit_scale"]).reshape(-1, 1, 1),
        "cpb_fc1": convert_linear(sd, f"{p}.attn.cpb_mlp.0"),
        "cpb_fc2": {"kernel": _t(sd[f"{p}.attn.cpb_mlp.2.weight"]).T},
        "Dense_0": convert_linear(sd, f"{p}.mlp.fc1"),
        "Dense_1": convert_linear(sd, f"{p}.mlp.fc2"),
    }


def _fuxi_updown(sd: Mapping, p: str, transpose_conv: bool) -> dict:
    """FuXi's down/up weights in the patch-merge GEMM layout (torch Linear)
    or as k=2/s=2 convolutions, which are exactly that GEMM: Conv2d (D, Dc,
    2, 2) → the (4·Dc, D) merge kernel with rows in (ki, kj, c) order,
    ConvTranspose2d (D, Dc, 2, 2) → the (D, 4·Dc) expand kernel.  Any other
    kernel (a 3×3 stride-2 convolution is another function) raises."""
    w = _t(sd[f"{p}.weight"])
    if w.ndim == 2:
        return convert_linear(sd, p)
    if w.ndim != 4 or w.shape[2] != 2 or w.shape[3] != 2:
        raise ValueError(
            f"{p}.weight has shape {w.shape}: only k=2/s=2 conv down/up weights map losslessly onto the "
            "patch-merge GEMM (a 3x3 stride-2 conv is a different function)"
        )
    D_, Dc_ = w.shape[0], w.shape[1]
    if transpose_conv:  # ConvTranspose2d (D, Dc, 2, 2) → (D, 4Dc)
        kern = w.transpose(0, 2, 3, 1).reshape(D_, 4 * Dc_)
    else:  # Conv2d (D, Dc, 2, 2) → (4Dc, D)
        kern = w.transpose(2, 3, 1, 0).reshape(4 * Dc_, D_)
    out = {"kernel": np.ascontiguousarray(kern)}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def convert_fuxi(model, sd: Mapping) -> dict:
    """FuXi cascade state dict (``stages.{s}.{cube_embed, down_norm, down,
    blocks.{i}, up, up_norm, fuse, head}``, one stage per short/medium/long
    regime) → the flax-layout tree.  Blocks convert by the configured
    flavour (Swin-V2 with ``cfg.attn_v2``, else V1 as ``_swin_block``) and
    stack pairwise (even blocks → ``pairs/a``, odd → ``pairs/b``), the
    layout of the scanned trunk.  The stages' f32 leaves become bf16 CPU
    tensors (bf16 at rest, as ``init_params``; numpy has no bf16), the
    others stay as they came."""
    import torch

    cfg = model.cfg

    def block(p):
        return _swin_v2_block(sd, p) if cfg.attn_v2 else _swin_block(sd, p, cfg.window)

    def bf16(tree):
        return {k: bf16(v) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16) if np.asarray(v).dtype == np.float32
                else np.asarray(v) for k, v in tree.items()}

    def one_stage(pre: str) -> dict:
        blocks = [block(f"{pre}.blocks.{i}") for i in range(cfg.depth)]
        return bf16({
            "cube_embed": convert_conv2d(sd, f"{pre}.cube_embed"),
            "head": convert_convtranspose2d(sd, f"{pre}.head"),
            "down_norm": convert_layernorm(sd, f"{pre}.down_norm"),
            "down": _fuxi_updown(sd, f"{pre}.down", transpose_conv=False),
            "up": _fuxi_updown(sd, f"{pre}.up", transpose_conv=True),
            "up_norm": convert_layernorm(sd, f"{pre}.up_norm"),
            "fuse": convert_linear(sd, f"{pre}.fuse"),
            "pairs": {"a": _stack(blocks[0::2]), "b": _stack(blocks[1::2])},
        })

    nc = cfg.in_channels
    return {
        "stages": [one_stage(f"stages.{s}") for s in range(cfg.n_stages)],
        "norm": _convert_norm_stats(sd, nc) or _norm_params(nc),
    }


def convert_fuxi_onnx_cascade(model, paths) -> dict:
    """The released FuXi cascade: one traced ONNX per stage
    (short/medium/long).  Each file's exporter-named initializers are
    renamed to ``stages.{s}.*`` by the topology pass
    (weights/onnx_rename.py), then the merged dict converts through
    :func:`convert_fuxi`."""
    from skyrim_tpu_torch.weights.onnx_io import read_onnx_graph
    from skyrim_tpu_torch.weights.onnx_rename import rename_fuxi_graph

    paths = list(paths)
    if len(paths) != model.cfg.n_stages:
        raise ValueError(
            f"FuXi cascade needs {model.cfg.n_stages} stage artifacts (short/medium/long), got {len(paths)}"
        )
    sd: dict = {}
    for s, path in enumerate(paths):
        sd.update(rename_fuxi_graph(read_onnx_graph(path), model.cfg, stage=s, n_history=model.n_history))
    tracked = _TrackedSD(sd)
    out = convert_fuxi(model, tracked)
    tracked.report(model.name)
    return out


CONVERTERS = {"pangu": convert_pangu, "graphcast": convert_graphcast, "fourcastnet_v2": convert_sfno,
              "fengwu": convert_fengwu, "fuxi": convert_fuxi, "fourcastnet": convert_afno, "dlwp": convert_dlwp}

"""Rename pass: exporter graph names → the converters' state-dict names
(port of skyrim_tpu/weights/onnx_rename.py, numpy only).

The released FuXi / FengWu artifacts are traced ONNX exports.  Tracing destroys module names: Linear weights become
``onnx::MatMul_123`` initializers stored (in, out) — the TRANSPOSE of
the torch state-dict layout — biases fold into bare-numbered ``Add``
constants, and LayerNorms keep only scale/bias tensors.  The per-model
converters (weights/convert.py) expect torch-style dotted names; this
module recovers them from the graph TOPOLOGY instead of the names:

1. ``ordered_param_events`` walks the node list in serialized order
   (exporters emit topological = forward-execution order) and records
   each float initializer at its first consumption, tagged with the
   consuming op.
2. A per-family "program" lists the expected roles in forward order
   with exact shapes derived from the model config (fuxi_stage_program /
   fengwu_program — mirroring the FuXi and FengWu networks' forwards).
3. ``match_events`` zips the two with a small look-ahead window (local
   op reorderings between exporters are tolerated; global structure is
   not), verifying shapes at every step and transposing MatMul-folded
   Linear weights back to (out, in).  Folded constants that are not
   parameters (attention masks, CPB coordinate tables, rel-index
   gathers) match no role and are skipped; any UNMATCHED ROLE is a hard
   error naming the position, so a layout drift cannot load silently.

The output feeds ``convert_fuxi`` / ``convert_fengwu`` unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Role:
    name: str  # torch-style state-dict key
    shape: tuple[int, ...]
    kind: str  # "linear" | "param" (as-stored) — linear transposes MatMul form


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    array: np.ndarray
    op: str
    pos: int  # operand position in the consuming node


def ordered_param_events(graph: dict) -> list[Event]:
    """Float initializers in first-consumption (forward) order."""
    inits = graph["initializers"]
    seen: set[str] = set()
    events: list[Event] = []
    for node in graph["nodes"]:
        for pos, inp in enumerate(node["inputs"]):
            if inp in seen or inp not in inits:
                continue
            seen.add(inp)
            arr = np.asarray(inits[inp])
            if arr.dtype.kind not in "fc" or arr.ndim == 0:
                continue  # shape/index constants, scalars (eps, clamps)
            events.append(Event(inp, arr, node["op_type"], pos))
    return events


def _fits(ev: Event, role: Role) -> np.ndarray | None:
    """The role's tensor in torch layout, or None if the event can't be it."""
    a = ev.array
    if role.kind == "linear":
        # torch Linear stores (out, in); a traced export folds it into a
        # MatMul initializer stored (in, out).  Square weights are
        # disambiguated by the consuming op, not the shape.
        out_d, in_d = role.shape
        if ev.op in ("MatMul", "Gemm"):
            if a.shape == (in_d, out_d):
                return np.ascontiguousarray(a.T)
            return None
        if a.shape == (out_d, in_d):
            return a
        return None
    if a.shape == tuple(role.shape):
        return a
    # 1-D params sometimes carry broadcast dims in traced graphs
    if len(role.shape) == 1 and a.size == role.shape[0]:
        return a.reshape(role.shape)
    return None


def match_events(
    events: list[Event], program: list[Role], lookahead: int = 8
) -> dict[str, np.ndarray]:
    """Assign events to roles in order with shape verification.

    Raises with the exact position and expectation when any role stays
    unmatched — a wrong-architecture artifact fails loudly, never loads
    garbage.
    """
    pending = list(program)
    out: dict[str, np.ndarray] = {}
    skipped: list[str] = []
    for ev in events:
        for j in range(min(lookahead, len(pending))):
            got = _fits(ev, pending[j])
            if got is not None:
                out[pending[j].name] = got
                pending.pop(j)
                break
        else:
            skipped.append(f"{ev.name}{list(ev.array.shape)}@{ev.op}")
    if pending:
        missing = ", ".join(
            f"{r.name}{list(r.shape)}" for r in pending[:8]
        )
        more = f" (+{len(pending) - 8} more)" if len(pending) > 8 else ""
        raise ValueError(
            f"onnx rename: {len(pending)} expected parameters not found in "
            f"the graph: {missing}{more}; unconsumed float constants: "
            f"{skipped[:6]} — architecture/config mismatch with the artifact"
        )
    return out


# ---------------------------------------------------------------------------
# role programs (mirror the forward order of the networks)
# ---------------------------------------------------------------------------


def _linear(p: str, o: int, i: int, bias: bool = True) -> list[Role]:
    r = [Role(f"{p}.weight", (o, i), "linear")]
    if bias:
        r.append(Role(f"{p}.bias", (o,), "param"))
    return r


def _ln(p: str, d: int) -> list[Role]:
    return [Role(f"{p}.weight", (d,), "param"), Role(f"{p}.bias", (d,), "param")]


def _conv(p: str, o: int, i: int, k: int) -> list[Role]:
    return [Role(f"{p}.weight", (o, i, k, k), "param"),
            Role(f"{p}.bias", (o,), "param")]


def _convT(p: str, i: int, o: int, k: int) -> list[Role]:
    return [Role(f"{p}.weight", (i, o, k, k), "param"),
            Role(f"{p}.bias", (o,), "param")]


def _swin_v1_block(p: str, C: int, heads: int, n_rel: int) -> list[Role]:
    """V1 (pre-norm, bias-table) block in forward order: norm1 → qkv →
    table → proj → norm2 → mlp."""
    return (
        _ln(f"{p}.norm1", C)
        + _linear(f"{p}.attn.qkv", 3 * C, C)
        + [Role(f"{p}.attn.relative_position_bias_table", (n_rel, heads), "param")]
        + _linear(f"{p}.attn.proj", C, C)
        + _ln(f"{p}.norm2", C)
        + _linear(f"{p}.mlp.fc1", 4 * C, C)
        + _linear(f"{p}.mlp.fc2", C, 4 * C)
    )


def _swin_v2_block(p: str, C: int, heads: int) -> list[Role]:
    """Swin-V2 block (models/fuxi.py _v2_block forward order): CPB MLP →
    logit_scale → qkv → proj → post-norm1 → mlp → post-norm2.  The
    look-ahead window in match_events absorbs exporters that emit
    logit_scale before the CPB weights (torch order)."""
    return (
        _linear(f"{p}.attn.cpb_mlp.0", 512, 2)
        + [Role(f"{p}.attn.cpb_mlp.2.weight", (heads, 512), "linear")]
        + [Role(f"{p}.attn.logit_scale", (heads, 1, 1), "param")]
        + _linear(f"{p}.attn.qkv", 3 * C, C)
        + _linear(f"{p}.attn.proj", C, C)
        + _ln(f"{p}.norm1", C)
        + _linear(f"{p}.mlp.fc1", 4 * C, C)
        + _linear(f"{p}.mlp.fc2", C, 4 * C)
        + _ln(f"{p}.norm2", C)
    )


def fuxi_stage_program(cfg, n_history: int = 2, prefix: str = "stages.0",
                       conv_updown: bool = False) -> list[Role]:
    """One FuXi cascade stage (the released artifacts ship one ONNX per
    short/medium/long stage) — mirrors the FuXi stage's forward.

    ``conv_updown`` matches artifacts whose down/up are k=2/s=2 strided
    (transposed-)convs instead of patch-merge GEMMs; the shapes map
    losslessly either way (convert_fuxi's ``updown`` adapter)."""
    from skyrim_tpu_torch.ops.windows import earth_bias_table_size

    cin = n_history * cfg.in_channels
    Dc, D, p = cfg.cube_dim, cfg.embed_dim, cfg.patch
    wh, ww = cfg.window
    n_rel = earth_bias_table_size((1, wh, ww))
    roles = _conv(f"{prefix}.cube_embed", Dc, cin, p)
    roles += _ln(f"{prefix}.down_norm", 4 * Dc)
    if conv_updown:
        roles += [Role(f"{prefix}.down.weight", (D, Dc, 2, 2), "param")]
    else:
        roles += [Role(f"{prefix}.down.weight", (D, 4 * Dc), "linear")]
    for i in range(cfg.depth):
        bp = f"{prefix}.blocks.{i}"
        if cfg.attn_v2:
            roles += _swin_v2_block(bp, D, cfg.num_heads)
        else:
            roles += _swin_v1_block(bp, D, cfg.num_heads, n_rel)
    if conv_updown:
        roles += [Role(f"{prefix}.up.weight", (D, Dc, 2, 2), "param")]
    else:
        roles += [Role(f"{prefix}.up.weight", (4 * Dc, D), "linear")]
    roles += _ln(f"{prefix}.up_norm", Dc)
    roles += _linear(f"{prefix}.fuse", Dc, D)
    roles += _convT(f"{prefix}.head", Dc, cfg.in_channels, p)
    return roles


def fengwu_program(cfg, n_history: int = 2) -> list[Role]:
    """FengWu — mirrors the FengWu network's forward: modal encoders → fuse_in →
    fuser blocks (V1 cores) → modal decoders."""
    from skyrim_tpu_torch.ops.windows import earth_bias_table_size

    md, D, p = cfg.modal_dim, cfg.fuser_dim, cfg.patch
    wh, ww = cfg.window
    n_rel = earth_bias_table_size((1, wh, ww))
    group_ch = [cfg.surface_channels] + [cfg.levels] * cfg.level_vars
    roles: list[Role] = []
    for g, ci in enumerate(group_ch):
        roles += _conv(f"encoders.{g}", md, n_history * ci, p)
    roles += _linear("fuse_in", D, md * len(group_ch))
    for i in range(cfg.depth):
        roles += _swin_v1_block(f"fuser.{i}", D, cfg.num_heads, n_rel)
    for g, co in enumerate(group_ch):
        roles += _convT(f"decoders.{g}", D, co, p)
    return roles


def rename_fuxi_graph(graph: dict, cfg, stage: int = 0,
                      n_history: int = 2) -> dict[str, np.ndarray]:
    events = ordered_param_events(graph)
    try:
        prog = fuxi_stage_program(cfg, n_history, prefix=f"stages.{stage}")
        return match_events(events, prog)
    except ValueError:
        # released-artifact variant: strided-conv down/up blocks
        prog = fuxi_stage_program(cfg, n_history, prefix=f"stages.{stage}",
                                  conv_updown=True)
        return match_events(events, prog)


def rename_fengwu_graph(graph: dict, cfg,
                        n_history: int = 2) -> dict[str, np.ndarray]:
    return match_events(ordered_param_events(graph), fengwu_program(cfg, n_history))


def fengwu_config_from_graph(graph: dict, lat: int = 721, lon: int = 1440,
                             n_history: int = 2):
    """Derive FengWuConfig from an exporter-named traced graph: widths
    come from raw event shapes (no names needed) — modal encoders are
    the leading Conv events, ``fuse_in`` the first MatMul, depth the
    count of qkv-shaped MatMuls, heads/window the bias-table shape."""
    from skyrim_tpu_torch.models.fengwu import FengWuConfig
    from skyrim_tpu_torch.ops.windows import earth_bias_table_size

    events = ordered_param_events(graph)
    convs = [e for e in events if e.op == "Conv" and e.array.ndim == 4]
    if not convs:
        raise ValueError("no Conv events — not a FengWu traced export?")
    md, hs, p, _ = convs[0].array.shape
    surface = hs // n_history
    mats = [e for e in events
            if e.op in ("MatMul", "Gemm") and e.array.ndim == 2]
    fuse = next(e for e in mats if e.array.shape[0] % md == 0
                and e.array.shape[0] // md > 1)
    # traced MatMul stores (in, out): fuse_in is (groups·md, D)
    n_groups = fuse.array.shape[0] // md
    D = fuse.array.shape[1]
    levels = (convs[1].array.shape[1] // n_history
              if len(convs) > 1 else 13)
    depth = sum(1 for e in mats if e.array.shape == (D, 3 * D))
    table = next(
        e for e in events
        if e.array.ndim == 2 and e.op not in ("MatMul", "Gemm")
        and e.array.shape[0] > e.array.shape[1]
    )
    n_rel, heads = table.array.shape
    window = None
    for wh, ww in ((6, 12), (4, 8), (8, 16), (2, 4), (3, 6), (7, 14), (2, 2)):
        if earth_bias_table_size((1, wh, ww)) == n_rel:
            window = (wh, ww)
            break
    if window is None:
        raise ValueError(
            f"cannot infer fuser window from bias table rows {n_rel}")
    return FengWuConfig(
        lat=lat, lon=lon, levels=int(levels), surface_channels=int(surface),
        level_vars=int(n_groups - 1), modal_dim=int(md), fuser_dim=int(D),
        depth=int(depth), num_heads=int(heads), window=window, patch=int(p),
    )


def looks_exporter_named(names) -> bool:
    """True when a tensor-name set smells like a traced export (numeric
    names, ``onnx::`` prefixes) rather than a torch state dict."""
    names = list(names)
    if not names:
        return False
    ugly = sum(
        1 for n in names
        if n.split(".")[-1].isdigit() and n.count(".") == 0
        or n.startswith("onnx::") or n.startswith("/")
    )
    return ugly >= len(names) / 2

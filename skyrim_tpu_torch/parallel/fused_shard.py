"""The port's kernels under longitude domain decomposition (port of
skyrim_tpu/parallel/fused_shard.py).

Inside a lon-manual region (``lon_manual``) the whole model step runs on
each rank's longitude chunk: every kernel (K1 on window blocks, K2 on the
z/lat part of each shift, K3/K4 on the stage changes) launches on local
tensors, and the only communication is a ring **cover gather** around each
window block.  Attention windows are independent, so a rank whose
boundary cuts a window computes the covering whole windows — at most one
window of overlap, fetched from its ring neighbours — and drops the
overlap.  The shifted-window roll along lon folds into the cover's
offsets; the level/latitude parts of the roll stay local (those dims are
not sharded here).  When the local width divides the window and the lon
shift is window-aligned, the block is local up to a plain ring roll.

Models opt in with ``lon_manual = True`` and a ``lon_shard_divisor``
(Pangu, FengWu, FuXi's V1 flavour); every other model steps in
``parallel/sharding.py``'s ``gather`` mode.

The rank's lon index is a Python int here, so the JAX module's
``dynamic_slice_in_dim`` is ``narrow``; exchanges are
``mesh.ring_exchange``'s posted sends and receives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from skyrim_tpu_torch.parallel.mesh import AXES, Mesh, ring_exchange


@dataclasses.dataclass(frozen=True)
class LonManualCtx:
    """Active while a model step runs on this rank's lon chunk."""

    mesh: Mesh
    axis: str  # mesh axis name ("lon")
    n: int  # number of lon shards

    @property
    def index(self) -> int:
        return self.mesh.coords[self.axis]


_state = threading.local()


def current() -> LonManualCtx | None:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def lon_manual(mesh: Mesh, axis: str = AXES.lon):
    """Run the block inside a lon-manual region over ``mesh``'s ``axis``
    (no region where the axis has one rank)."""
    prev = current()
    n = mesh.shape[axis]
    _state.ctx = LonManualCtx(mesh, axis, n) if n > 1 else None
    try:
        yield
    finally:
        _state.ctx = prev


def supports_lon_manual(model, mesh: Mesh) -> bool:
    """True when the whole-step manual path applies: the model opted in,
    spatial sharding is lon-only, and every internal width divides."""
    if not getattr(model, "lon_manual", False):
        return False
    if mesh.shape.get(AXES.lat, 1) != 1:
        return False
    n = mesh.shape.get(AXES.lon, 1)
    if n == 1:
        return True
    div = getattr(model, "lon_shard_divisor", None)
    return div is not None and div % n == 0


# --------------------------------------------------------------------------
# ring primitives (only valid inside the manual region)
# --------------------------------------------------------------------------


def ring_extend(x: torch.Tensor, left: int, right: int, axis: int) -> torch.Tensor:
    """Extend the local lon chunk with ``left``/``right`` neighbour tokens
    over the periodic ring.  Extents may exceed the local width; the
    exchange then walks several hops."""
    ctx = current()
    assert ctx is not None, "ring_extend outside a lon-manual region"
    Wl = x.shape[axis]
    sends = []
    for hop in range(-(-left // Wl) if left else 0, 0, -1):  # outermost (furthest) first
        take = min(Wl, left - (hop - 1) * Wl)
        sends.append((x.narrow(axis, Wl - take, take), hop))  # the left halo comes from rank − hop
    n_left = len(sends)
    for hop in range(1, (-(-right // Wl) if right else 0) + 1):
        take = min(Wl, right - (hop - 1) * Wl)
        sends.append((x.narrow(axis, 0, take), -hop))  # the right halo from rank + hop
    if not sends:
        return x
    got = ring_exchange(ctx.mesh, ctx.axis, sends)
    return torch.cat([*got[:n_left], x, *got[n_left:]], dim=axis)


def ring_roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Global periodic roll of a lon-sharded axis (|shift| ≤ local width)."""
    ctx = current()
    assert ctx is not None, "ring_roll outside a lon-manual region"
    Wl = x.shape[axis]
    s = shift % (Wl * ctx.n)
    if s == 0:
        return x
    if s <= Wl:
        return ring_extend(x, s, 0, axis).narrow(axis, 0, Wl)
    # large rolls: extend the right side instead (equivalent, fewer hops)
    back = Wl * ctx.n - s
    assert back <= Wl, f"roll {shift} too large for local width {Wl}"
    return ring_extend(x, 0, back, axis).narrow(axis, back, Wl)


def local_lon_slice(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Cut a replicated global array down to this rank's lon chunk (Pangu's
    constant masks); the array itself outside a manual region."""
    ctx = current()
    if ctx is None:
        return x
    Wl = x.shape[axis] // ctx.n
    return x.narrow(axis, ctx.index * Wl, Wl)


def cover_offset(start: int, s2: int, ww: int) -> int:
    """Where this rank's first token sits in its cover: ``(start − s2) mod
    ww`` for the rank's first global lon token ``start`` and lon shift
    ``s2``."""
    return (start - s2) % ww


# --------------------------------------------------------------------------
# the sharded window block
# --------------------------------------------------------------------------


def manual_swin_block(
    x: torch.Tensor,  # (Z, H, Wl, C) LOCAL lon chunk, z/lat window-padded
    ln1,
    qkv_wb,
    bias,
    mask,
    proj_wb,
    ln2,
    mlp_wb,
    window: tuple[int, int, int],
    heads: int,
    shift: tuple[int, int, int] = (0, 0, 0),
) -> torch.Tensor:
    """Whole (optionally shifted) window block on a lon-sharded activation:
    roll(shift) → K1 → roll(−shift) on the global array.

    Index algebra (rolled coords v map to x coords v + s2; start = d·Wl;
    a = start − s2; mis = a mod ww):

    - the rolled range this rank must produce is [a, a + Wl);
    - its window-aligned cover is [a − mis, a − mis + Wc), Wc = (⌈Wl/ww⌉ + 1)·ww;
    - in x coordinates that cover starts at start − mis, so a left ring
      extension of ww − 1 tokens and a right one of Wc − Wl always contain
      it, for any shift: the shifted roll costs nothing extra;
    - the rank's own tokens sit at offset mis inside the cover's output.

    The cover goes to K1 contiguous; z/lat roll components are K2 launches
    on it.  Must be called inside a lon-manual region."""
    from skyrim_tpu_torch.ops.fused_block import fused_swin_block
    from skyrim_tpu_torch.ops.roll import shift_roll

    ctx = current()
    assert ctx is not None, "manual_swin_block outside a lon-manual region"
    Z, H, Wl, C = x.shape
    ww = window[2]
    s0, s1, s2 = shift
    n = ctx.n
    Wg = Wl * n
    if Wg % ww:
        raise ValueError(f"global lon tokens {Wg} not a multiple of the window {ww}")
    args = (ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads)
    local = (s0, s1, 0)

    if Wl % ww == 0 and s2 % ww == 0:
        # window-aligned chunks with an aligned (or no) lon shift: the block
        # is local up to a plain ring roll
        if s2:
            x = ring_roll(x, -s2, axis=2).contiguous()
        h = fused_swin_block(shift_roll(x, local, forward=True), *args)
        h = shift_roll(h, local, forward=False)
        return ring_roll(h, s2, axis=2).contiguous() if s2 else h

    Wc = min((-(-Wl // ww) + 1) * ww, Wg)
    left_ext = ww - 1
    ext = ring_extend(x, left_ext, Wc - Wl, axis=2)
    mis = cover_offset(ctx.index * Wl, s2, ww)
    cover = ext.narrow(2, left_ext - mis, Wc).contiguous()
    h = fused_swin_block(shift_roll(cover, local, forward=True), *args)
    h = shift_roll(h, local, forward=False)
    return h.narrow(2, mis, Wl).contiguous()


def reference_manual_swin_block(
    x_global, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads, shift=(0, 0, 0),
):
    """Single-device semantics the manual block must match: the plain
    block between two ``torch.roll``s of the global array."""
    from skyrim_tpu_torch.ops.fused_block import reference_swin_block

    h = x_global
    if any(shift):
        h = torch.roll(h, tuple(-s for s in shift), dims=(0, 1, 2))
    h = reference_swin_block(h, ln1, qkv_wb, bias, mask, proj_wb, ln2, mlp_wb, window, heads)
    if any(shift):
        h = torch.roll(h, tuple(shift), dims=(0, 1, 2))
    return h

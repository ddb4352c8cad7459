"""SPMD over the mesh: sharded state, replicated params, sharded steps and
rollouts, members over ``dp`` (port of skyrim_tpu/parallel/sharding.py).

The (..., C, H, W) state is domain-decomposed over the mesh's ``lat`` and
``lon`` axes; parameters are replicated; ``dp`` carries ensemble members.
One process runs each rank and holds its shard.  A step runs in one of
three modes (``_step_mode``):

- ``local``: a mesh of one rank, the model's own step;
- ``manual``: models that opt in (``parallel/fused_shard.py``) step on the
  local lon chunk, every kernel on local tensors, window covers fetched
  from ring neighbours;
- ``gather``: every other model, and any mesh the model's divisor does not
  divide.  No compiler partitions the step here (the JAX package's
  ``gspmd`` mode), so each rank all-gathers the state, runs the model's
  ordinary step with its kernels — replicated compute — and keeps its
  shard.

A spec is a tuple with one mesh axis name or None per dim, as a
``PartitionSpec``'s entries.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
from torch import nn

from skyrim_tpu_torch.models.base import ModelState, PrognosticModel
from skyrim_tpu_torch.parallel import fused_shard as FS
from skyrim_tpu_torch.parallel.mesh import AXES, Mesh, all_gather, broadcast_


def _step_mode(model: PrognosticModel, mesh: Mesh) -> str:
    """'local' (one rank), 'manual' (the lon-sharded step, kernels on local
    chunks) or 'gather' (replicated compute on the gathered state)."""
    if mesh.size == 1:
        return "local"
    if FS.supports_lon_manual(model, mesh):
        return "manual"
    return "gather"


def state_spec(n_spatial_dims: int = 4) -> tuple:
    """(..., C, H, W) → H over 'lat', W over 'lon'.

    At 0.25° the grid is 721×1440; 721 = 7·103 barely divides, so meshes
    put the spatial shards on the periodic, highly divisible longitude axis
    (``make_mesh(dp, 1, n)``).  Dims the mesh does not divide degrade to
    replicated (``compatible_spec``)."""
    return (None,) * (n_spatial_dims - 2) + (AXES.lat, AXES.lon)


def compatible_spec(shape: tuple[int, ...], mesh: Mesh, spec: tuple) -> tuple:
    """Drop sharding on dims the mesh cannot divide evenly."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, axis in zip(shape, parts):
        if axis is None:
            out.append(None)
            continue
        n = mesh.shape[axis] if isinstance(axis, str) else 1
        out.append(axis if n > 0 and size % n == 0 else None)
    return tuple(out)


def leaf_spec(mesh: Mesh, shape: tuple[int, ...]) -> tuple:
    """A state leaf's spec from its global shape: trailing (lat, lon) where
    the leaf has two dims or more, where they divide."""
    if len(shape) < 2:
        return (None,) * len(shape)
    return compatible_spec(tuple(shape), mesh, state_spec(len(shape)))


def shard(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's shard of the global ``x`` (the same on every rank)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape[axis] > 1:
            k = x.shape[dim] // mesh.shape[axis]
            x = x.narrow(dim, mesh.coords[axis] * k, k)
    return x.contiguous()


def gather(mesh: Mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The global array of this rank's shard ``x`` laid out by ``spec``, on
    every rank: the counterpart of ``np.asarray`` on a sharded array."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(mesh, axis, x, dim)
    return x


def _map_state(state: ModelState, fn) -> ModelState:
    """``fn`` over the state's tensors (x and the model's extra leaves)."""
    extra = {k: fn(v) if torch.is_tensor(v) else v for k, v in state.extra.items()}
    return state.replace(x=fn(state.x), extra=extra)


def shard_state(mesh: Mesh, state: ModelState) -> ModelState:
    """The full state (the same on every rank) → this rank's shard: leaves
    of two dims or more split on their trailing (lat, lon), scalars kept."""
    return _map_state(state, lambda t: shard(mesh, t, leaf_spec(mesh, tuple(t.shape))))


def gather_state(mesh: Mesh, state: ModelState, grid_shape: tuple[int, int]) -> ModelState:
    """Inverse of ``shard_state`` for a model on a ``grid_shape`` grid."""

    def full(t):
        if t.ndim < 2:
            return t
        return gather(mesh, t, leaf_spec(mesh, (*t.shape[:-2], *grid_shape)))

    return _map_state(state, full)


def _tensors(tree):
    """Every tensor leaf of a parameter tree: dicts, lists, tuples and
    modules (their parameters and buffers)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Make every rank's parameters rank 0's: each tensor leaf broadcast
    in place over the mesh.  Returns the tree."""
    for t in _tensors(tree):
        broadcast_(mesh, t)
    return tree


def sharded_advance(model: PrognosticModel, mesh: Mesh):
    """``advance(params, state) → (state, y)`` on this rank's shard of the
    state (``shard_state``), y this rank's shard of the output.  The mode
    is on the function as ``advance.mode``."""
    mode = _step_mode(model, mesh)
    grid = tuple(model.grid.shape)

    @torch.no_grad()
    def advance(params, state: ModelState):
        if mode == "local":
            return model.advance(params, state)
        if mode == "manual":
            with FS.lon_manual(mesh):
                return model.advance(params, state)
        new_state, y = model.advance(params, gather_state(mesh, state, grid))
        return shard_state(mesh, new_state), shard(mesh, y, leaf_spec(mesh, tuple(y.shape)))

    advance.mode = mode
    return advance


def sharded_scan_rollout(model: PrognosticModel, mesh: Mesh, n_steps: int):
    """``run(params, state) → (final state, outputs)`` over a sharded state:
    the outputs this rank's shards, (≥ n_steps, C, H, W) stacked."""
    n_calls = -(-n_steps // model.frames_out)
    advance = sharded_advance(model, mesh)

    def run(params, state: ModelState):
        ys = []
        for _ in range(n_calls):
            state, y = advance(params, state)
            ys.append(y)
        return state, torch.cat(ys, dim=0)

    run.mode = advance.mode
    return run


def dp_ensemble_rollout(model: PrognosticModel, mesh: Mesh | None, n_steps: int):
    """``run(params, x0_batch, start_time=None)``: ICs (B, hist, C, H, W) →
    outputs (B, n_steps, C, H, W) as numpy, on every rank.

    ``mesh=None``: the members in turn on the model's device against the
    one ``params``, each member's frames copied to the host before the
    next starts.  A mesh: the members split over ``dp`` when B divides by
    it (else every dp rank runs all of them, as ``compatible_spec``
    degrades), each member's state sharded over (lat, lon) within its dp
    slice and stepped by ``sharded_advance``; the outputs gathered."""
    from skyrim_tpu_torch.rollout import scan_rollout

    if mesh is None:

        def run_in_turn(params, x0_batch, start_time: datetime.datetime | None = None) -> np.ndarray:
            outs = []
            for x0 in x0_batch:
                state = model.init_state(params, x0, start_time=start_time)
                _, ys = scan_rollout(model, params, state, n_steps)
                outs.append(ys[:n_steps].cpu().numpy())
            return np.stack(outs)

        return run_in_turn
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a skyrim_tpu_torch.parallel.mesh.Mesh or None, got {type(mesh).__name__}")
    rollout = sharded_scan_rollout(model, mesh, n_steps)

    def run(params, x0_batch, start_time: datetime.datetime | None = None) -> np.ndarray:
        B, dp = len(x0_batch), mesh.shape[AXES.dp]
        split = B % dp == 0
        mine = range(mesh.coords[AXES.dp] * (B // dp), (mesh.coords[AXES.dp] + 1) * (B // dp)) if split else range(B)
        outs = []
        for b in mine:
            state = shard_state(mesh, model.init_state(params, x0_batch[b], start_time=start_time))
            _, ys = rollout(params, state)
            ys = ys[:n_steps].cpu()  # the outputs go to the host anyway
            outs.append(gather(mesh, ys, leaf_spec(mesh, (*ys.shape[:-2], *model.grid.shape))))
        local = torch.stack(outs)
        if split:
            local = all_gather(mesh, AXES.dp, local.contiguous(), 0)
        return local.cpu().numpy()

    run.mode = rollout.mode
    return run

"""Device mesh over ``torch.distributed`` ranks (port of skyrim_tpu/parallel/mesh.py).

One process per rank, SPMD: every rank runs the same program on its own
shard.  Axis names, outermost first:

- ``dp``   — data parallel: ensemble members / init times / batch
- ``lat``  — spatial domain decomposition over latitude rows
- ``lon``  — spatial domain decomposition over longitude columns

The ranks are laid out row-major over ``(dp, lat, lon)``, as the JAX
package's ``mesh_utils.create_device_mesh`` lays out CPU devices, and each
axis has one process group per line of ranks along it.  Every rank creates
every group, in one fixed order: ``dist.new_group`` is collective, and
ranks that call it in different orders hang.

Backend: NCCL where each rank of a host has a card of its own; otherwise
gloo.  Under gloo a CUDA tensor is never handed to a send, a receive or a
collective: ``Mesh.to_wire`` stages it through host memory (under NCCL a
host tensor goes to the card), and what arrives is moved back to the
device of the tensor it stands for.  The backend in use is logged, never
picked silently.

``count_exchanges()`` records, while it is open, each exchange this rank
makes through ``ring_exchange``, ``all_gather``, ``all_reduce_`` and
``broadcast_`` (``parallel/collective_analysis.py`` reads the records).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from skyrim_tpu_torch.utils.device import resolve_device
from skyrim_tpu_torch.utils.logging import logger

#: how long a collective or the rendezvous waits before it fails the rank
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: str = "dp"
    lat: str = "lat"
    lon: str = "lon"


AXES = MeshAxes()
_ORDER = (AXES.dp, AXES.lat, AXES.lon)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(dp, lat, lon)`` mesh over the world's ranks, as this rank sees it.

    ``shape``: axis name → size.  ``coords``: this rank's index on each
    axis.  ``groups``: axis name → the process group of this rank's line
    along that axis (None where the axis has one rank).  ``members``: the
    global ranks of that line in axis order.  ``device``: this rank's
    device; ``backend``: the process group's backend (None without one)."""

    shape: dict
    rank: int
    coords: dict
    groups: dict
    members: dict
    device: torch.device
    backend: str | None

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def wire_device(self, t: torch.Tensor) -> torch.device:
        """Where ``t`` travels: the host under gloo, this rank's card under
        NCCL, where it lies without a backend."""
        return {"gloo": torch.device("cpu"), "nccl": self.device}.get(self.backend, t.device)

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: contiguous, on ``wire_device``."""
        return t.contiguous().to(self.wire_device(t))

    def wire_empty(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for a tensor like ``like``."""
        return torch.empty(like.shape, dtype=like.dtype, device=self.wire_device(like))


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: the card ``process_index() % device_count()``
    for ``"cuda"`` (one host; ranks share cards when there are more ranks
    than cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, world: int) -> str:
    """NCCL where each of the ``world`` ranks (one host) has a card of its
    own, else gloo."""
    if device.type == "cuda" and dist.is_nccl_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(device: str | torch.device = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group when launched as one rank of several:
    ``SKYRIM_COORDINATOR`` (``host:port``, or an init URL such as
    ``file:///…``), ``SKYRIM_NUM_PROCESSES`` and ``SKYRIM_PROCESS_ID``, as
    the JAX package reads them.  Returns whether a group is up."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("SKYRIM_COORDINATOR")
    if not coord:
        return False
    world = int(os.environ.get("SKYRIM_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("SKYRIM_PROCESS_ID", "0"))
    backend = choose_backend(resolve_device(device), world)
    dist.init_process_group(
        backend, init_method=coord if "://" in coord else f"tcp://{coord}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    dev = rank_device(device)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    logger.info("rank %d of %d: backend %s on %s%s", rank, world, backend, dev,
                "; exchanged CUDA tensors staged through host memory"
                if backend == "gloo" and dev.type == "cuda" else "")
    return True


def make_mesh(dp: int = 1, lat: int = 1, lon: int = 1, device: str | torch.device | None = None) -> Mesh:
    """Build a ``(dp, lat, lon)`` mesh over all ranks of the process group
    (one rank without one).  Any axis may be -1 to absorb the remaining
    ranks (at most one).  ``device``: this rank's device (its card by
    default, ``rank_device``)."""
    n = process_count()
    sizes = [dp, lat, lon]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    fixed = int(np.prod([s for s in sizes if s != -1]))
    if wild:
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        sizes[wild[0]] = n // fixed
        fixed = int(np.prod(sizes))
    if fixed != n:
        raise ValueError(f"mesh {tuple(sizes)} does not cover {n} devices")
    rank = process_index()
    grid = np.arange(n).reshape(sizes)
    coords = dict(zip(_ORDER, (int(c) for c in np.unravel_index(rank, sizes))))
    groups, members = {}, {}
    for ax, axis in enumerate(_ORDER):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:  # every rank creates every group, in this order
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks) if sizes[ax] > 1 else None
            if rank in ranks:
                groups[axis], members[axis] = group, ranks
    dev = rank_device("cuda" if device is None else device)
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(dict(zip(_ORDER, sizes)), rank, coords, groups, members, dev, backend)


def single_device_mesh(device: str | torch.device | None = None) -> Mesh:
    """A 1×1×1 mesh of this rank alone: no group, no collective."""
    dev = rank_device("cuda" if device is None else device)
    return Mesh({a: 1 for a in _ORDER}, process_index(), {a: 0 for a in _ORDER}, {a: None for a in _ORDER},
                {a: [process_index()] for a in _ORDER}, dev, None)


# --------------------------------------------------------------------------
# exchanges along one mesh axis (every rank of the line calls them alike)
# --------------------------------------------------------------------------

_COUNTS: list[list] = []


@contextlib.contextmanager
def count_exchanges():
    """Yields a list that collects one record per exchange this rank makes in
    the block: ``kind`` (the JAX package's HLO names: ``collective-permute``,
    ``all-gather``, ``all-reduce``; and ``broadcast``), ``bytes`` (the
    payload: a permute's sent tensor, an all-gather's result, an all-reduce's
    or a broadcast's tensor), ``ici_bytes`` (what this rank pushes over its
    links under the ring model: a permute's payload × hops, an all-gather's
    (n − 1)/n of its result, an all-reduce's 2(n − 1)/n, a pipelined
    broadcast's payload), ``group_size`` and ``op_name``."""
    records: list = []
    _COUNTS.append(records)
    try:
        yield records
    finally:
        _COUNTS.remove(records)


def _record(kind: str, nbytes: int, ici: int, n: int) -> None:
    for records in _COUNTS:
        records.append({"kind": kind, "bytes": int(nbytes), "ici_bytes": int(ici), "group_size": n, "op_name": ""})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ring_exchange(mesh: Mesh, axis: str, sends: list) -> list:
    """Periodic point-to-point exchange along ``axis``.  ``sends``: a list of
    ``(tensor, hop)``; for each, this rank sends its tensor to the rank
    ``hop`` places on and receives the same-shaped tensor from the rank
    ``hop`` places back.  Returns the received tensors, in order.  All
    sends and receives are posted at once (``batch_isend_irecv``), so a
    ring cannot deadlock; a hop that comes round to this rank is a copy."""
    n, d, ranks = mesh.shape[axis], mesh.coords[axis], mesh.members[axis]
    out, ops, bufs = [None] * len(sends), [], []
    for i, (t, hop) in enumerate(sends):
        if hop % n == 0:
            out[i] = t.clone()
            continue
        buf = mesh.wire_empty(t)
        _record("collective-permute", _nbytes(t), _nbytes(t) * min(hop % n, n - hop % n), n)
        ops.append(dist.P2POp(dist.isend, mesh.to_wire(t), ranks[(d + hop) % n], mesh.groups[axis], tag=i))
        ops.append(dist.P2POp(dist.irecv, buf, ranks[(d - hop) % n], mesh.groups[axis], tag=i))
        bufs.append((i, buf, t.device))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, buf, device in bufs:
        out[i] = buf.to(device)
    return out


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The shards of ``t`` along ``axis`` concatenated on ``dim``, on every
    rank of the line, in axis order."""
    if mesh.shape[axis] == 1:
        return t
    n = mesh.shape[axis]
    _record("all-gather", n * _nbytes(t), (n - 1) * _nbytes(t), n)
    wire = mesh.to_wire(t)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=mesh.groups[axis])
    return torch.cat(parts, dim).to(t.device)


def all_reduce_(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """Overwrite ``t`` in place with the sum of ``t`` over the ranks of this
    rank's line along ``axis``; every rank of the line gets the same bits."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    _record("all-reduce", _nbytes(t), 2 * (n - 1) * _nbytes(t) // n, n)
    wire = mesh.to_wire(t)
    dist.all_reduce(wire, group=mesh.groups[axis])
    if wire.data_ptr() != t.data_ptr():
        t.copy_(wire)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank 0's ``t`` (the whole world)."""
    if mesh.size == 1:
        return t
    _record("broadcast", _nbytes(t), _nbytes(t), mesh.size)
    wire = mesh.to_wire(t)
    dist.broadcast(wire, src=0)
    if wire.data_ptr() != t.data_ptr():
        t.copy_(wire)
    return t

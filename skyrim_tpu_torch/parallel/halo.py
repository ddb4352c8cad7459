"""Explicit halo exchange over the mesh (port of skyrim_tpu/parallel/halo.py).

Conventions: H (latitude) is sharded on the ``lat`` axis, and its edges
are NOT periodic (poles: zero halos); W (longitude) on ``lon``, with a
periodic wrap, which is physically real on the globe.  An axis of one
rank is handled locally, with no exchange.
"""

from __future__ import annotations

import torch

from skyrim_tpu_torch.parallel.mesh import AXES, Mesh, ring_exchange


def _neighbor_slices(mesh: Mesh, x, halo: int, dim: int, axis: str, periodic: bool):
    """(from_prev, from_next): ``halo`` rows of both neighbours along a mesh
    axis, zero-filled at non-periodic edges."""
    n, idx = mesh.shape[axis], mesh.coords[axis]
    # my high edge → the next rank's from_prev; my low edge → the previous rank's from_next
    from_prev, from_next = ring_exchange(mesh, axis, [
        (x.narrow(dim, x.shape[dim] - halo, halo), 1),
        (x.narrow(dim, 0, halo), -1),
    ])
    if not periodic:
        if idx == 0:
            from_prev = torch.zeros_like(from_prev)
        if idx == n - 1:
            from_next = torch.zeros_like(from_next)
    return from_prev, from_next


def halo_pad(x: torch.Tensor, mesh: Mesh, halo_lat: int = 0, halo_lon: int = 0) -> torch.Tensor:
    """Pad this rank's (..., H, W) shard with its neighbours' halos: the
    local shape grows by 2·halo along each exchanged dim.  Latitude edges
    (poles) are zero-filled; longitude wraps periodically."""
    h_dim, w_dim = x.ndim - 2, x.ndim - 1
    if halo_lat:
        if mesh.shape[AXES.lat] > 1:
            prev, nxt = _neighbor_slices(mesh, x, halo_lat, h_dim, AXES.lat, False)
        else:
            prev = nxt = torch.zeros_like(x.narrow(h_dim, 0, halo_lat))
        x = torch.cat([prev, x, nxt], dim=h_dim)
    if halo_lon:
        if mesh.shape[AXES.lon] > 1:
            prev, nxt = _neighbor_slices(mesh, x, halo_lon, w_dim, AXES.lon, True)
        else:
            prev = x.narrow(w_dim, x.shape[w_dim] - halo_lon, halo_lon)
            nxt = x.narrow(w_dim, 0, halo_lon)
        x = torch.cat([prev, x, nxt], dim=w_dim)
    return x

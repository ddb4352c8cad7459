"""Grids (the port's copy of skyrim_tpu/grid.py:23-76 and 358-450).

The canonical contract grid is the 0.25° equiangular lat-lon grid,
lat 90 → −90 inclusive (721 points), lon 0 → 359.75 (1440 points).
FourCastNet v1 uses the same grid without the south-pole row (720 lats).
GraphCast's icosahedral multimesh is here too; the cubed-sphere grid is
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np


@dataclass(frozen=True)
class LatLonGrid:
    """Equiangular lat-lon grid, latitude descending (north first)."""

    nlat: int = 721
    nlon: int = 1440
    include_south_pole: bool = True

    @cached_property
    def lat(self) -> np.ndarray:
        # 90 .. -90 inclusive for 721; FCN drops the last (south pole) row.
        full = np.linspace(90.0, -90.0, 721, dtype=np.float64)
        if self.nlat == 721:
            return full
        if self.nlat == 720:
            return full[:720]
        return np.linspace(90.0, -90.0, self.nlat, dtype=np.float64)

    @cached_property
    def lon(self) -> np.ndarray:
        return np.arange(self.nlon, dtype=np.float64) * (360.0 / self.nlon)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nlat, self.nlon)

    @property
    def resolution_deg(self) -> float:
        return 360.0 / self.nlon

    def nearest_index(self, lat: float, lon: float) -> tuple[int, int]:
        lon = lon % 360.0
        i = int(np.abs(self.lat - lat).argmin())
        j = int(np.abs(self.lon - lon).argmin())
        return i, j

    @cached_property
    def cell_area_weights(self) -> np.ndarray:
        """Normalized cos(lat) quadrature weights, shape (nlat,).

        Pole rows get half-cells; weights sum to 1.
        """
        lat_r = np.deg2rad(self.lat)
        d = np.deg2rad(self.resolution_deg)
        # cell edges clamped to the poles
        upper = np.clip(lat_r + d / 2, -np.pi / 2, np.pi / 2)
        lower = np.clip(lat_r - d / 2, -np.pi / 2, np.pi / 2)
        w = np.sin(upper) - np.sin(lower)
        return w / w.sum()


GRID_721x1440 = LatLonGrid(721, 1440)
GRID_720x1440 = LatLonGrid(720, 1440, include_south_pole=False)


# ---------------------------------------------------------------------------
# Icosahedral multimesh (GraphCast). Refined icosahedron, meshes M0..M6.
# ---------------------------------------------------------------------------


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron: (12, 3) vertices and (20, 3) faces."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )  # fmt: skip
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )  # fmt: skip
    return verts, faces


def _refine(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One step of edge-midpoint refinement, reprojected to the sphere.

    New vertices are appended after the old ones, so the vertex indices of
    mesh level k are a prefix of level k+1: edges of every level share one
    node set.
    """
    edge_mid: dict[tuple[int, int], int] = {}
    new_verts = [verts]
    next_idx = len(verts)

    def midpoint(i: int, j: int) -> int:
        nonlocal next_idx
        key = (min(i, j), max(i, j))
        if key not in edge_mid:
            m = verts[i] + verts[j]
            m = m / np.linalg.norm(m)
            new_verts.append(m[None])
            edge_mid[key] = next_idx
            next_idx += 1
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])
    return np.concatenate(new_verts), np.array(new_faces, dtype=np.int64)


@lru_cache(maxsize=4)
def icosahedral_multimesh(n_refinements: int = 6):
    """The GraphCast multimesh: a dict with ``verts`` (V, 3) unit vectors of
    the finest mesh, ``latlon`` (V, 2) degrees, ``faces`` (F, 3) finest-mesh
    faces, ``edges`` (E, 2) int32, the union of the bidirectional edges of
    every refinement level 0..n, and ``per_level_edge_counts``."""
    verts, faces = _icosahedron()
    all_edges = set()
    counts = []

    def add_edges(faces_arr):
        before = len(all_edges)
        for a, b, c in faces_arr:
            for i, j in ((a, b), (b, c), (c, a)):
                all_edges.add((int(i), int(j)))
                all_edges.add((int(j), int(i)))
        counts.append(len(all_edges) - before)

    add_edges(faces)
    for _ in range(n_refinements):
        verts, faces = _refine(verts, faces)
        add_edges(faces)

    edges = np.array(sorted(all_edges), dtype=np.int32)
    lat = np.rad2deg(np.arcsin(np.clip(verts[:, 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(verts[:, 1], verts[:, 0])) % 360.0
    return {
        "verts": verts,
        "latlon": np.stack([lat, lon], axis=-1),
        "faces": faces,
        "edges": edges,
        "per_level_edge_counts": counts,
    }

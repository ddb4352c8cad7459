"""Grids (the port's copy of skyrim_tpu/grid.py).

The canonical contract grid is the 0.25° equiangular lat-lon grid,
lat 90 → −90 inclusive (721 points), lon 0 → 359.75 (1440 points).
FourCastNet v1 uses the same grid without the south-pole row (720 lats).
DLWP's equiangular cubed sphere (its remap and halo tables, static numpy
built once and ``lru_cache``d) and GraphCast's icosahedral multimesh are
here too.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np

EARTH_RADIUS_M = 6_371_000.0


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
# Cubed sphere (DLWP). Equiangular gnomonic cubed sphere with face size F.
# ---------------------------------------------------------------------------

# Face layout follows the standard equiangular gnomonic convention:
# faces 0-3 equatorial (centered at lon 0/90/180/270), 4 = north, 5 = south.


def _face_xyz(face: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unit-sphere xyz for equiangular face coords a,b ∈ (−π/4, π/4)."""
    x = np.tan(a)
    y = np.tan(b)
    ones = np.ones_like(x)
    if face == 0:
        v = np.stack([ones, x, y], -1)
    elif face == 1:
        v = np.stack([-x, ones, y], -1)
    elif face == 2:
        v = np.stack([-ones, -x, y], -1)
    elif face == 3:
        v = np.stack([x, -ones, y], -1)
    elif face == 4:  # north pole cap
        v = np.stack([-y, x, ones], -1)
    else:  # south pole cap
        v = np.stack([y, x, -ones], -1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@dataclass(frozen=True)
class CubedSphereGrid:
    """Equiangular gnomonic cubed sphere with 6 faces of size F×F."""

    face_size: int = 64

    @cached_property
    def latlon(self) -> tuple[np.ndarray, np.ndarray]:
        """(lat, lon) degrees of every cell center, shape (6, F, F)."""
        F = self.face_size
        c = (np.arange(F) + 0.5) / F * (np.pi / 2) - np.pi / 4
        b, a = np.meshgrid(c, c, indexing="ij")
        lats, lons = [], []
        for face in range(6):
            v = _face_xyz(face, a, b)
            lats.append(np.rad2deg(np.arcsin(np.clip(v[..., 2], -1, 1))))
            lons.append(np.rad2deg(np.arctan2(v[..., 1], v[..., 0])) % 360.0)
        return np.stack(lats), np.stack(lons)


@lru_cache(maxsize=8)
def latlon_to_cubed_sphere_indices(
    face_size: int = 64, nlat: int = 721, nlon: int = 1440
) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear interpolation tables lat-lon → cubed sphere.

    Returns ``(idx, w)`` with ``idx`` int32 (6, F, F, 4) flat indices into
    the (nlat*nlon) lat-lon grid and ``w`` float32 (6, F, F, 4) weights.
    Remap is then ``x.reshape(..., nlat*nlon)[..., idx] @ w``, a static
    gather.
    """
    grid = LatLonGrid(nlat, nlon)
    cs = CubedSphereGrid(face_size)
    lat_q, lon_q = cs.latlon  # (6, F, F)

    # fractional row position: lat descending 90→-90
    fi = (90.0 - lat_q) / (180.0 / (nlat - 1))
    fj = (lon_q % 360.0) / grid.resolution_deg
    i0 = np.clip(np.floor(fi).astype(np.int64), 0, nlat - 2)
    j0 = np.floor(fj).astype(np.int64) % nlon
    di = (fi - i0).astype(np.float32)
    dj = (fj - j0).astype(np.float32)
    i1 = i0 + 1
    j1 = (j0 + 1) % nlon

    idx = np.stack(
        [i0 * nlon + j0, i0 * nlon + j1, i1 * nlon + j0, i1 * nlon + j1], axis=-1
    ).astype(np.int32)
    w = np.stack(
        [(1 - di) * (1 - dj), (1 - di) * dj, di * (1 - dj), di * dj], axis=-1
    ).astype(np.float32)
    return idx, w


def _inverse_gnomonic(q: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`_face_xyz`: unit vectors → (face, a, b).

    ``q`` is (..., 3); returns int face ids and equiangular face coords
    a, b ∈ [−π/4·(1+ε), π/4·(1+ε)] (points assigned to a face by the
    max-|component| rule sit within the face up to roundoff).
    """
    X, Y, Z = q[..., 0], q[..., 1], q[..., 2]
    ax, ay, az = np.abs(X), np.abs(Y), np.abs(Z)
    face = np.where(
        (ax >= ay) & (ax >= az),
        np.where(X > 0, 0, 2),
        np.where(ay >= az, np.where(Y > 0, 1, 3), np.where(Z > 0, 4, 5)),
    )
    # tan(a), tan(b) per face (derived from _face_xyz's stacking order)
    with np.errstate(divide="ignore", invalid="ignore"):
        ta = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4, face == 5],
            [Y / X, -X / Y, Y / X, -X / Y, Y / Z, -Y / Z],
        )
        tb = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4, face == 5],
            [Z / X, Z / Y, -Z / X, -Z / Y, -X / Z, -X / Z],
        )
    return face, np.arctan(ta), np.arctan(tb)


@lru_cache(maxsize=8)
def cubed_sphere_to_latlon_patch(
    face_size: int = 64, nlat: int = 721, nlon: int = 1440
) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear 2×2-patch tables cubed sphere → lat-lon.

    For every lat-lon point, locates the enclosing 2×2 patch of
    cubed-sphere cell centers in equiangular face coordinates and
    returns ``(starts, w)``:

    - ``starts`` int32 (nlat·nlon, 2): gather start ``(row, col)`` into a
      halo-padded channel-minor table of shape ``(6·(F+2), (F+2)·D)``
      (row = face·(F+2) + pb0, col = pa0; the caller scales col by its
      channel count D): the 2×2 neighborhood starts there.
    - ``w`` float32 (nlat·nlon, 4): bilinear weights ordered
      (b0a0, b0a1, b1a0, b1a1), matching the slice layout
      ``patch[:, db, da·D:(da+1)·D]``.

    Halo cells (pad 1) come from :func:`cubed_sphere_halo_indices`, so
    interpolation across face boundaries uses the nearest neighbor-face
    cell — O(h) in the 1-cell boundary band, linear-exact elsewhere
    (the 4-NN inverse-distance map this replaces was O(h) everywhere).
    """
    grid = LatLonGrid(nlat, nlon)
    F = face_size
    glat = np.deg2rad(grid.lat)[:, None] * np.ones((1, nlon))
    glon = np.deg2rad(grid.lon)[None, :] * np.ones((nlat, 1))
    q = np.stack(
        [np.cos(glat) * np.cos(glon), np.cos(glat) * np.sin(glon), np.sin(glat)],
        axis=-1,
    ).reshape(-1, 3)
    face, a, b = _inverse_gnomonic(q)

    # fractional cell coords: centers at (i+0.5)/F·(π/2) − π/4 ⇒ f(a)=i
    fa = a / (np.pi / 2) * F + F / 2 - 0.5
    fb = b / (np.pi / 2) * F + F / 2 - 0.5
    a0 = np.floor(fa).astype(np.int64)
    b0 = np.floor(fb).astype(np.int64)
    da = (fa - a0).astype(np.float32)
    db = (fb - b0).astype(np.float32)
    # padded-face indices (halo pad 1): valid starts 0..F (slice of 2)
    pa0 = np.clip(a0 + 1, 0, F)
    pb0 = np.clip(b0 + 1, 0, F)

    starts = np.stack([face * (F + 2) + pb0, pa0], axis=-1).astype(np.int32)
    w = np.stack(
        [(1 - db) * (1 - da), (1 - db) * da, db * (1 - da), db * da], axis=-1
    ).astype(np.float32)
    return starts, w


@lru_cache(maxsize=8)
def latlon_to_cubed_sphere_patch(
    face_size: int = 64, nlat: int = 721, nlon: int = 1440
) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear 2×2-patch tables lat-lon → cubed sphere.

    Same contract as :func:`cubed_sphere_to_latlon_patch` but the gather
    operand is the lat-lon field as a channel-minor table
    ``(nlat, (nlon+1)·D)`` with one wrap-padded longitude column
    (col = j0, row = i0; caller scales col by D; slice sizes (2, 2·D)).
    """
    grid = LatLonGrid(nlat, nlon)
    cs = CubedSphereGrid(face_size)
    lat_q, lon_q = cs.latlon  # (6, F, F)

    fi = (90.0 - lat_q) / (180.0 / (nlat - 1))
    fj = (lon_q % 360.0) / grid.resolution_deg
    i0 = np.clip(np.floor(fi).astype(np.int64), 0, nlat - 2)
    j0 = np.floor(fj).astype(np.int64) % nlon
    di = (fi - i0).astype(np.float32)
    dj = (fj - j0).astype(np.float32)

    starts = np.stack([i0, j0], axis=-1).reshape(-1, 2).astype(np.int32)
    w = np.stack(
        [(1 - di) * (1 - dj), (1 - di) * dj, di * (1 - dj), di * dj], axis=-1
    ).reshape(-1, 4).astype(np.float32)
    return starts, w


@lru_cache(maxsize=8)
def cubed_sphere_to_latlon_indices(
    face_size: int = 64, nlat: int = 721, nlon: int = 1440
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse remap tables: nearest-4 inverse-distance weights per lat-lon cell.

    Returns ``(idx, w)``: idx int32 (nlat, nlon, 4) flat indices into the
    (6*F*F) cubed-sphere cells, w float32 (nlat, nlon, 4).
    """
    grid = LatLonGrid(nlat, nlon)
    cs = CubedSphereGrid(face_size)
    F = face_size
    lat_c, lon_c = cs.latlon
    # cubed-sphere cell centers as unit vectors
    lat_r = np.deg2rad(lat_c.ravel())
    lon_r = np.deg2rad(lon_c.ravel())
    pts = np.stack(
        [np.cos(lat_r) * np.cos(lon_r), np.cos(lat_r) * np.sin(lon_r), np.sin(lat_r)],
        axis=-1,
    )  # (6FF, 3)

    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    glat = np.deg2rad(grid.lat)[:, None] * np.ones((1, nlon))
    glon = np.deg2rad(grid.lon)[None, :] * np.ones((nlat, 1))
    q = np.stack(
        [np.cos(glat) * np.cos(glon), np.cos(glat) * np.sin(glon), np.sin(glat)],
        axis=-1,
    ).reshape(-1, 3)
    dist, idx = tree.query(q, k=4)

    w = 1.0 / np.maximum(dist, 1e-12)
    w = w / w.sum(axis=-1, keepdims=True)
    return (
        idx.reshape(nlat, nlon, 4).astype(np.int32),
        w.reshape(nlat, nlon, 4).astype(np.float32),
    )


@lru_cache(maxsize=8)
def cubed_sphere_halo_indices(face_size: int = 64, pad: int = 1) -> np.ndarray:
    """Cross-face halo gather table for cubed-sphere convolutions.

    Returns int32 (6, F+2p, F+2p) flat indices into the (6*F*F) cell
    array.  Interior cells map to themselves; halo cells map to the
    nearest cell on the neighboring face, found by extending the
    equiangular face coordinate beyond ±π/4 and doing a spherical
    nearest-neighbor lookup.  Convolutions then run per-face with VALID
    padding after one static gather.
    """
    F, p = face_size, pad
    cs = CubedSphereGrid(F)
    lat_c, lon_c = cs.latlon
    lat_r = np.deg2rad(lat_c.ravel())
    lon_r = np.deg2rad(lon_c.ravel())
    pts = np.stack(
        [np.cos(lat_r) * np.cos(lon_r), np.cos(lat_r) * np.sin(lon_r), np.sin(lat_r)],
        axis=-1,
    )
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)

    c = (np.arange(-p, F + p) + 0.5) / F * (np.pi / 2) - np.pi / 4
    b, a = np.meshgrid(c, c, indexing="ij")
    out = np.empty((6, F + 2 * p, F + 2 * p), dtype=np.int32)
    interior = np.arange(6 * F * F, dtype=np.int32).reshape(6, F, F)
    for face in range(6):
        v = _face_xyz(face, a, b)
        _, idx = tree.query(v.reshape(-1, 3), k=1)
        grid_idx = idx.reshape(F + 2 * p, F + 2 * p).astype(np.int32)
        # keep exact self-indices in the interior (avoids any NN rounding)
        grid_idx[p : F + p, p : F + p] = interior[face]
        out[face] = grid_idx
    return out


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

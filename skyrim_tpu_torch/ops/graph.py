"""Static graph tables for GraphCast (port of skyrim_tpu/ops/graph.py:29-449).

Everything irregular in GraphCast is precomputed here, once, as numpy
index tables: the grid↔mesh bipartite edges (radius query, containing
triangle), edge features in the receiver's local east-north frame, the
dst-sorted multimesh edges packed into segment-aligned blocks
(``build_block_plan``), and the spatial tiles of the two bipartite passes
(``build_g2m_tiles``, ``build_face_tiles``).  The table builders are
copies of the JAX package's, which cannot be imported (its module imports
jax); ``tests/test_torch_graph.py`` holds them equal.

``block_onehot``, ``block_segment_sum`` and ``block_expand_dst`` are the
torch versions of the block-plan expansion and aggregation as one-hot
products; only plain versions use them (the kernels index and sum).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from skyrim_tpu_torch.grid import LatLonGrid, icosahedral_multimesh


def _latlon_to_xyz(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=-1
    )


def _local_frame(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(east, north) unit tangent vectors at each point (N, 3)."""
    z = np.array([0.0, 0.0, 1.0])
    east = np.cross(z, xyz)
    norm = np.linalg.norm(east, axis=-1, keepdims=True)
    # at the poles pick an arbitrary tangent
    east = np.where(norm > 1e-9, east / np.maximum(norm, 1e-9), np.array([1.0, 0, 0]))
    north = np.cross(xyz, east)
    north /= np.maximum(np.linalg.norm(north, axis=-1, keepdims=True), 1e-9)
    return east, north


def edge_features(src_xyz: np.ndarray, dst_xyz: np.ndarray) -> np.ndarray:
    """4 features per edge: [length, d·east_dst, d·north_dst, d·up_dst]."""
    d = src_xyz - dst_xyz
    length = np.linalg.norm(d, axis=-1, keepdims=True)
    east, north = _local_frame(dst_xyz)
    de = (d * east).sum(-1, keepdims=True)
    dn = (d * north).sum(-1, keepdims=True)
    du = (d * dst_xyz).sum(-1, keepdims=True)
    return np.concatenate([length, de, dn, du], axis=-1).astype(np.float32)


def node_features(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
    """3 static features: [sin(lat), cos(lon), sin(lon)]."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    return np.stack([np.sin(lat), np.cos(lon), np.sin(lon)], axis=-1).astype(np.float32)


def _sort_by_dst(src, dst, feat):
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32), feat[order]


@lru_cache(maxsize=4)
def build_graphs(nlat: int, nlon: int, refinements: int, radius_factor: float = 0.6):
    """All static tables for GraphCast on (nlat, nlon) with an R-times
    refined icosahedral multimesh.

    Returns a dict of numpy arrays:
      mesh_src/mesh_dst/mesh_efeat       — multimesh edges (sorted by dst)
      g2m_src/g2m_dst/g2m_efeat          — grid→mesh (src: grid flat idx)
      m2g_src/m2g_dst/m2g_efeat          — mesh→grid (dst: grid flat idx)
      m2g_face / faces                   — containing finest face per grid point
      mesh_nfeat / grid_nfeat            — static node features
      n_mesh / n_grid / finest_edge
    """
    from scipy.spatial import cKDTree

    mesh = icosahedral_multimesh(refinements)
    mverts = mesh["verts"]  # (V, 3)
    mlatlon = mesh["latlon"]
    n_mesh = len(mverts)

    grid = LatLonGrid(nlat, nlon)
    glat = np.repeat(grid.lat, nlon)
    glon = np.tile(grid.lon, nlat)
    gxyz = _latlon_to_xyz(glat, glon)
    n_grid = nlat * nlon

    # --- multimesh edges ---
    ms, md = mesh["edges"][:, 0], mesh["edges"][:, 1]
    mef = edge_features(mverts[ms], mverts[md])
    ms, md, mef = _sort_by_dst(ms, md, mef)

    # --- grid→mesh: grid points within radius of each mesh node ---
    faces = mesh["faces"]
    finest_edge = np.linalg.norm(mverts[faces[:, 0]] - mverts[faces[:, 1]], axis=-1).min()
    radius = radius_factor * np.linalg.norm(
        mverts[faces[:, 0]] - mverts[faces[:, 1]], axis=-1
    ).max()
    gtree = cKDTree(gxyz)
    pairs = gtree.query_ball_point(mverts, r=radius)
    g2m_src = np.concatenate([np.asarray(p, dtype=np.int64) for p in pairs])
    g2m_dst = np.concatenate([np.full(len(p), i, dtype=np.int64) for i, p in enumerate(pairs)])
    g2m_ef = edge_features(gxyz[g2m_src], mverts[g2m_dst])
    g2m_src, g2m_dst, g2m_ef = _sort_by_dst(g2m_src, g2m_dst, g2m_ef)

    # --- mesh→grid: 3 vertices of the containing finest triangle ---
    mtree = cKDTree(mverts)
    _, nearest_v = mtree.query(gxyz, k=1)
    incident: list[list[int]] = [[] for _ in range(n_mesh)]
    for fi, (a, b, c) in enumerate(faces):
        incident[a].append(fi)
        incident[b].append(fi)
        incident[c].append(fi)
    max_inc = max(len(x) for x in incident)
    inc_tbl = np.zeros((n_mesh, max_inc), dtype=np.int64)
    for v, fl in enumerate(incident):
        inc_tbl[v, : len(fl)] = fl
        inc_tbl[v, len(fl) :] = fl[0] if fl else 0
    cand = inc_tbl[nearest_v]  # (n_grid, max_inc)

    # barycentric coords wrt each candidate face (gnomonic projection)
    A = mverts[faces[cand, 0]]  # (n_grid, max_inc, 3)
    B = mverts[faces[cand, 1]]
    C = mverts[faces[cand, 2]]
    P = gxyz[:, None, :]

    def det3(u, v, w):
        return np.einsum("...i,...i->...", u, np.cross(v, w))

    wa = det3(P, B, C)
    wb = det3(A, P, C)
    wc = det3(A, B, P)
    tot = wa + wb + wc
    bary = np.stack([wa, wb, wc], axis=-1) / np.where(
        np.abs(tot)[..., None] > 1e-12, tot[..., None], 1.0
    )
    score = bary.min(axis=-1)  # containing face ⇒ all ≥ 0
    best = score.argmax(axis=1)
    best_face = cand[np.arange(n_grid), best]
    tri = faces[best_face]  # (n_grid, 3)

    m2g_src = tri.reshape(-1)
    m2g_dst = np.repeat(np.arange(n_grid, dtype=np.int64), 3)
    m2g_ef = edge_features(mverts[m2g_src], gxyz[m2g_dst])
    # m2g_dst is already sorted, so the stable sort is the identity and
    # edges 3g..3g+2 stay exactly faces[m2g_face[g]] in vertex order — the
    # face-structured decoder relies on this
    m2g_src, m2g_dst, m2g_ef = _sort_by_dst(m2g_src, m2g_dst, m2g_ef)

    return {
        "mesh_src": ms, "mesh_dst": md, "mesh_efeat": mef,
        "g2m_src": g2m_src, "g2m_dst": g2m_dst, "g2m_efeat": g2m_ef,
        "m2g_src": m2g_src, "m2g_dst": m2g_dst, "m2g_efeat": m2g_ef,
        "m2g_face": best_face.astype(np.int32), "faces": faces.astype(np.int32),
        "mesh_nfeat": node_features(mlatlon[:, 0], mlatlon[:, 1]),
        "grid_nfeat": node_features(glat, glon),
        "n_mesh": n_mesh, "n_grid": n_grid,
        "finest_edge": float(finest_edge),
    }  # fmt: skip


def build_block_plan(
    seg_sorted: np.ndarray,
    n_seg: int,
    target_rows: int = 2048,
    row_multiple: int = 8,
    seg_multiple: int = 8,
    block_multiple: int = 1,
) -> dict:
    """Segment-aligned block partition of a dst-sorted edge list.

    Greedily packs consecutive segments into blocks of ≤ ``target_rows``
    rows (a segment larger than target_rows gets its own block and M grows
    to fit it).  Returns numpy tables:

      starts   (B,)      first edge row of each block
      seg_lo   (B,)      first segment id of each block
      local    (B, M)    per-row local segment index (SB ⇒ padding row)
      unpack   (n_seg,)  flat index of each segment into (B·SB) aggregates
      M, SB              padded rows / segments per block
      n_seg, E           original sizes
    """
    seg = np.asarray(seg_sorted)
    E = len(seg)
    seg_start = np.searchsorted(seg, np.arange(n_seg + 1), side="left")
    blocks = []  # (row_start, seg_lo, n_segs)
    s = 0
    while s < n_seg:
        row0 = seg_start[s]
        e = s + 1
        while e < n_seg and seg_start[e + 1] - row0 <= target_rows:
            e += 1
        blocks.append((row0, s, e - s))
        s = e
    while len(blocks) % block_multiple:  # empty tail blocks
        blocks.append((E, n_seg, 0))
    B = len(blocks)
    M = max((seg_start[s + n] - r0 for r0, s, n in blocks), default=1)
    M = max(-(-M // row_multiple) * row_multiple, row_multiple)
    SB = max(n for _, _, n in blocks)
    SB = max(-(-SB // seg_multiple) * seg_multiple, seg_multiple)
    starts = np.array([r0 for r0, _, _ in blocks], np.int32)
    seg_lo = np.array([s for _, s, _ in blocks], np.int32)
    local = np.full((B, M), SB, np.int32)  # SB = padding sentinel
    for b, (r0, s, n) in enumerate(blocks):
        rows = seg_start[s + n] - r0
        local[b, :rows] = seg[r0 : r0 + rows] - s
    block_of_seg = np.repeat(np.arange(B), [n for _, _, n in blocks])
    segs = np.arange(n_seg)
    unpack = (block_of_seg * SB + segs - seg_lo[block_of_seg]).astype(np.int32)
    return {
        "starts": starts, "seg_lo": seg_lo, "local": local, "unpack": unpack,
        "M": int(M), "SB": int(SB), "n_seg": int(n_seg), "E": int(E),
    }  # fmt: skip


def pad_rows_to_blocks(a: np.ndarray, plan: dict) -> np.ndarray:
    """Re-lay a dst-sorted per-edge table into the plan's padded
    (B, M, ...) block layout."""
    starts, M = plan["starts"], plan["M"]
    B = len(starts)
    out = np.zeros((B, M, *a.shape[1:]), a.dtype)
    E = plan["E"]
    for b in range(B):
        r0 = int(starts[b])
        r1 = int(starts[b + 1]) if b + 1 < B else E
        out[b, : r1 - r0] = a[r0:r1]
    return out


def build_face_tiles(face_hw: np.ndarray, th: int, tw: int) -> dict:
    """Per-(th, tw)-tile unique-face tables for the mesh→grid decoder.

    Spatial (th, tw) grid tiles touch few distinct faces, so the decoder
    reads each tile's unique face rows instead of one wide row per point.
    The tiles need not divide the grid: the last row and column of tiles
    may be partial.

    Returns:
      tile_faces (TH, TW, U) int32 — face ids per tile (padded by
        repeating the tile's first id; harmless duplicate rows)
      tile_local (H, W) int32 — each point's index into its tile's row
      U, th, tw
    """
    face_hw = np.asarray(face_hw)
    H, W = face_hw.shape
    TH, TW = -(-H // th), -(-W // tw)
    uniqs = []
    local = np.zeros((H, W), np.int32)
    for i in range(TH):
        for j in range(TW):
            tile = face_hw[i * th : (i + 1) * th, j * tw : (j + 1) * tw]
            u, inv = np.unique(tile, return_inverse=True)
            uniqs.append(u)
            local[i * th : (i + 1) * th, j * tw : (j + 1) * tw] = inv.reshape(tile.shape)
    U = max(len(u) for u in uniqs)
    U = max(-(-U // 8) * 8, 8)
    tile_faces = np.zeros((TH, TW, U), np.int32)
    k = 0
    for i in range(TH):
        for j in range(TW):
            u = uniqs[k]
            k += 1
            tile_faces[i, j, : len(u)] = u
            tile_faces[i, j, len(u) :] = u[0]
    return {"tile_faces": tile_faces, "tile_local": local,
            "U": int(U), "th": int(th), "tw": int(tw)}  # fmt: skip


def pick_exact_tile(n: int, max_t: int, mult: int = 1) -> int:
    """Largest divisor of ``n`` ≤ ``max_t``, preferring multiples of
    ``mult``.  The grid-major encoder's tiles must cover the grid exactly
    (its slot tables are laid out tile by tile)."""
    divs = [d for d in range(1, min(n, max_t) + 1) if n % d == 0]
    pref = [d for d in divs if d % mult == 0]
    return max(pref or divs)


def build_g2m_tiles(
    src: np.ndarray,
    dst: np.ndarray,
    efeat: np.ndarray,
    H: int,
    W: int,
    n_seg: int,
) -> dict:
    """Grid-major slot tables for the grid→mesh encoder.

    Grid-major, the source side is contiguous (each grid point's latent
    row, out-degree ≤ D), and a (th, tw) spatial tile sends to at most U
    distinct mesh nodes, so the encoder aggregates per tile and a small
    static re-gather combines the tile partials into the mesh nodes.

    Returns:
      D, U                      — max out-degree / padded unique dsts per tile
      slot_ef   (H, W, D, 4)    — per-slot edge features (0 for empty)
      slot_dst  (H, W, D) int32 — per-slot mesh dst id (0 for empty)
      local     (TH, TW, D, th·tw) int32 — slot's index into its tile's
                                  unique table; == U ⇒ empty slot
      combine_idx (Mc,) int32   — flat (tile·U + u) positions, dst-sorted
      combine_seg (Mc,) int32   — their mesh ids (sorted)
      th, tw
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = len(src)
    n_grid = H * W
    order = np.argsort(src, kind="stable")
    s_s, d_s, ef_s = src[order], dst[order], np.asarray(efeat)[order]
    counts = np.bincount(s_s, minlength=n_grid)
    D = int(counts.max())
    starts = np.zeros(n_grid + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    k = np.arange(E) - starts[s_s]
    slot_dst = np.zeros((n_grid, D), np.int32)
    slot_ef = np.zeros((n_grid, D, efeat.shape[-1]), np.float32)
    valid = np.zeros((n_grid, D), bool)
    slot_dst[s_s, k] = d_s
    slot_ef[s_s, k] = ef_s
    valid[s_s, k] = True

    th = pick_exact_tile(H, 16)
    tw = pick_exact_tile(W, 192, mult=16)
    TH, TW = H // th, W // tw
    sd_hw = slot_dst.reshape(H, W, D)
    va_hw = valid.reshape(H, W, D)
    local = np.zeros((H, W, D), np.int32)
    uniqs = []
    for i in range(TH):
        for j in range(TW):
            sl = (slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw))
            tile_d, tile_v = sd_hw[sl], va_hw[sl]
            u, inv = np.unique(tile_d[tile_v], return_inverse=True)
            loc = np.zeros(tile_d.shape, np.int32)
            loc[tile_v] = inv
            uniqs.append(u)
            local[sl] = loc
    U = max((len(u) for u in uniqs), default=1)
    U = max(-(-U // 8) * 8, 8)
    local[~va_hw] = U  # empty slots point past the unique table
    combine_idx, combine_seg = [], []
    t = 0
    for i in range(TH):
        for j in range(TW):
            u = uniqs[t]
            combine_idx.extend(t * U + np.arange(len(u)))
            combine_seg.extend(u)
            t += 1
    combine_idx = np.asarray(combine_idx, np.int32)
    combine_seg = np.asarray(combine_seg, np.int32)
    so = np.argsort(combine_seg, kind="stable")
    local_t = np.ascontiguousarray(
        local.reshape(TH, th, TW, tw, D).transpose(0, 2, 4, 1, 3).reshape(TH, TW, D, th * tw)
    )
    return {
        "D": D, "U": int(U),
        "slot_ef": slot_ef.reshape(H, W, D, -1),
        "slot_dst": sd_hw,
        "local": local_t,
        "combine_idx": combine_idx[so],
        "combine_seg": combine_seg[so],
        "th": int(th), "tw": int(tw),
    }  # fmt: skip


def g2m_row_plan(local_t: np.ndarray, U: int, th: int, tw: int) -> tuple[np.ndarray, np.ndarray]:
    """The filled slots of the grid-major encoder's tables, dst-sorted.

    ``local_t`` (TH, TW, D, th·tw) is ``build_g2m_tiles``' ``local`` (== U ⇒
    empty slot).  Returns:
      rows (E,) int32        — for each filled slot, the flat bias row p·D + k
                               of grid point p = i·W + j (its source row is
                               rows // D), ordered by tile, then by local
                               destination u, then by (k, r) as in local_t
      csr  (TH·TW·U + 1,) int32 — destination g·U + u of tile g owns
                               rows[csr[g·U + u] : csr[g·U + u + 1]]; an empty
                               destination has an empty range
    """
    local_t = np.asarray(local_t)
    TH, TW, D, R = local_t.shape
    if R != th * tw:
        raise ValueError(f"g2m_row_plan: local_t {local_t.shape} for tiles {(th, tw)}")
    W = TW * tw
    T = TH * TW
    flat = local_t.reshape(T, D * R).astype(np.int64)
    t, q = np.nonzero(flat < U)  # row-major: by tile, then (k, r)
    dst = t * U + flat[t, q]
    order = np.argsort(dst, kind="stable")
    t, q, dst = t[order], q[order], dst[order]
    k, r = q // R, q % R
    i = (t // TW) * th + r // tw
    j = (t % TW) * tw + r % tw
    rows = ((i * W + j) * D + k).astype(np.int32)
    csr = np.zeros(T * U + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=T * U), out=csr[1:])
    return rows, csr.astype(np.int32)


def block_onehot(local: torch.Tensor, SB: int, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, SB, M) one-hot aggregation operator from a plan's (B, M) local
    segment ids; padding rows (local == SB) hit no segment."""
    iota = torch.arange(SB, dtype=local.dtype, device=local.device)
    return (local[:, None, :] == iota[None, :, None]).to(dtype)


def block_segment_sum(data_blocks: torch.Tensor, plan: dict, onehot=None) -> torch.Tensor:
    """Aggregate padded (B, M, D) rows into (n_seg, D) with batched one-hot
    products (f32 accumulation), then the plan's ``unpack`` gather."""
    local = torch.as_tensor(plan["local"], device=data_blocks.device)
    oh = block_onehot(local, plan["SB"], torch.float32) if onehot is None else onehot.float()
    agg = torch.einsum("bsm,bmd->bsd", oh, data_blocks.float()).to(data_blocks.dtype)
    unpack = torch.as_tensor(plan["unpack"], dtype=torch.long, device=data_blocks.device)
    return agg.reshape(-1, agg.shape[-1])[unpack]


def block_expand_dst(seg_vals: torch.Tensor, plan: dict, onehot=None) -> torch.Tensor:
    """Expand per-segment rows (n_seg, D) to the padded per-edge block
    layout (B, M, D) as a batched one-hot product, after a small (B·SB)-row
    gather stages each block's segment range."""
    dev = seg_vals.device
    SB = plan["SB"]
    seg_lo = torch.as_tensor(plan["seg_lo"], dtype=torch.long, device=dev)
    idx = (seg_lo[:, None] + torch.arange(SB, device=dev)[None, :]).clamp(0, plan["n_seg"] - 1)
    staged = seg_vals[idx]  # (B, SB, D)
    local = torch.as_tensor(plan["local"], device=dev)
    oh = block_onehot(local, SB, torch.float32) if onehot is None else onehot.float()
    return torch.einsum("bsm,bsd->bmd", oh, staged.float()).to(seg_vals.dtype)

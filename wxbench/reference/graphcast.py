"""Plain f32 GraphCast (Lam et al., Science 382, 2023; arXiv:2212.12794),
written from the published description in the flax parameter layout
that checkpoints use, with its own graph.

The graph: an icosahedron refined ``mesh_refinements`` times by edge
midpoints, the multimesh the union of every level's edges in both
directions; grid→mesh edges from each grid point within 0.6 of the
longest finest-mesh edge of a mesh node; mesh→grid edges from the three
vertices of the finest triangle that contains each grid point.  Edge
features: length and the displacement in the receiver's east, north and
up frame; node features: sin lat, cos lon, sin lon.  Forcings: the
top-of-atmosphere insolation over the 6 h before the step's time
(Spencer's declination and eccentricity, f32 epoch seconds as the
checkpoints' model computes them), scaled by 1/1.5e7, and the sin and
cos of local time and of the year.

One step: [both frames normalised ‖ forcings ‖ static features] → the grid
embedding; grid→mesh messages summed into the embedded mesh nodes, then
the mesh and grid node updates; 16 processor rounds (edge update with a
residual, the new edges summed into their destinations, node update with
a residual); mesh→grid messages summed into the grid nodes and the grid
update; the head gives the change of the normalised last frame.  Every
MLP is Dense → swish → Dense → LayerNorm (the head without); the first
Dense of an edge MLP over [edge ‖ sender ‖ receiver] is applied part by
part, the node parts per node and gathered, which is the same sum.
Everything in float32 with TF32 off; ``quant="fp8"`` rounds each product's
operands to float8 e4m3 (the control).

``weights`` maps flax paths with dots (``net.round_3.MLP_0.Dense_0.kernel``,
``norm.mean``) to tensors.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from wxbench.reference.common import ein, exact_f32, layer_norm, swish

N_FORCINGS = 5
CHUNK = 1 << 18  # rows of a grid-sized or edge-sized product at a time


# --- the graph --------------------------------------------------------------


def _icosahedron():
    phi = (1 + math.sqrt(5)) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
                  [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
                  [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
                  [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return v / np.linalg.norm(v, axis=1, keepdims=True), f


def _refine(verts, faces):
    """Split each triangle in four at its edges' midpoints (new vertices
    appended, so each level's vertices are a prefix of the next's)."""
    mid, new = {}, [verts]
    n = len(verts)

    def m(i, j):
        nonlocal n
        key = (min(i, j), max(i, j))
        if key not in mid:
            p = verts[i] + verts[j]
            new.append((p / np.linalg.norm(p))[None])
            mid[key], n = n, n + 1
        return mid[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = m(a, b), m(b, c), m(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.concatenate(new), np.array(out)


def _xyz(lat_deg, lon_deg):
    lat, lon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], -1)


def _edge_features(src, dst):
    d = src - dst
    east = np.cross(np.array([0.0, 0.0, 1.0]), dst)
    n = np.linalg.norm(east, axis=-1, keepdims=True)
    east = np.where(n > 1e-9, east / np.maximum(n, 1e-9), np.array([1.0, 0.0, 0.0]))
    north = np.cross(dst, east)
    north /= np.maximum(np.linalg.norm(north, axis=-1, keepdims=True), 1e-9)
    cols = [np.linalg.norm(d, axis=-1), (d * east).sum(-1), (d * north).sum(-1), (d * dst).sum(-1)]
    return np.stack(cols, -1).astype(np.float32)


def _node_features(lat_deg, lon_deg):
    lat, lon = np.deg2rad(lat_deg), np.deg2rad(lon_deg)
    return np.stack([np.sin(lat), np.cos(lon), np.sin(lon)], -1).astype(np.float32)


def grid_latlon(nlat: int, nlon: int):
    """The 0.25° grid's rows north to south (poles included) and columns from 0°."""
    lat = np.linspace(90.0, -90.0, nlat) if nlat != 720 else np.linspace(90.0, -90.0, 721)[:720]
    return lat, np.arange(nlon) * (360.0 / nlon)


@lru_cache(maxsize=2)
def build_graph(nlat: int, nlon: int, refinements: int, radius_factor: float = 0.6) -> dict:
    from scipy.spatial import cKDTree

    verts, faces = _icosahedron()
    edges = set()

    def add(fs):
        for a, b, c in fs:
            for i, j in ((a, b), (b, c), (c, a)):
                edges.update(((int(i), int(j)), (int(j), int(i))))

    add(faces)
    for _ in range(refinements):
        verts, faces = _refine(verts, faces)
        add(faces)
    mm = np.array(sorted(edges))
    lat, lon = grid_latlon(nlat, nlon)
    glat, glon = np.repeat(lat, nlon), np.tile(lon, nlat)
    gxyz = _xyz(glat, glon)
    mlat = np.rad2deg(np.arcsin(np.clip(verts[:, 2], -1, 1)))
    mlon = np.rad2deg(np.arctan2(verts[:, 1], verts[:, 0])) % 360.0
    # grid → mesh: every grid point within the radius of a mesh node
    side = np.linalg.norm(verts[faces[:, 0]] - verts[faces[:, 1]], axis=-1)
    near = cKDTree(gxyz).query_ball_point(verts, r=radius_factor * side.max())
    g2m_dst = np.concatenate([np.full(len(p), i) for i, p in enumerate(near)])
    g2m_src = np.concatenate([np.asarray(p, dtype=np.int64) for p in near])
    # mesh → grid: the vertices of the finest triangle holding the grid point,
    # searched among the triangles around its nearest vertex
    _, nearest = cKDTree(verts).query(gxyz, k=1)
    around = [[] for _ in range(len(verts))]
    for fi, tri in enumerate(faces):
        for v in tri:
            around[v].append(fi)
    width = max(len(a) for a in around)
    table = np.array([a + [a[0]] * (width - len(a)) for a in around])
    cand = table[nearest]
    A, B, C = (verts[faces[cand, i]] for i in range(3))
    P = gxyz[:, None, :]

    def det(u, v, w):
        return np.einsum("...i,...i->...", u, np.cross(v, w))

    w = np.stack([det(P, B, C), det(A, P, C), det(A, B, P)], -1)
    tot = w.sum(-1, keepdims=True)
    w = w / np.where(np.abs(tot) > 1e-12, tot, 1.0)
    face = cand[np.arange(len(gxyz)), w.min(-1).argmax(1)]
    m2g_src = faces[face].reshape(-1)
    m2g_dst = np.repeat(np.arange(len(gxyz)), 3)
    return {
        "n_mesh": len(verts), "n_grid": len(gxyz), "lat": lat, "lon": lon,
        "mm_src": mm[:, 0], "mm_dst": mm[:, 1], "mm_ef": _edge_features(verts[mm[:, 0]], verts[mm[:, 1]]),
        "g2m_src": g2m_src, "g2m_dst": g2m_dst, "g2m_ef": _edge_features(gxyz[g2m_src], verts[g2m_dst]),
        "m2g_src": m2g_src, "m2g_dst": m2g_dst, "m2g_ef": _edge_features(verts[m2g_src], gxyz[m2g_dst]),
        "mesh_nf": _node_features(mlat, mlon), "grid_nf": _node_features(glat, glon),
    }


def graph_on(g: dict, device) -> dict:
    out = {}
    for k, v in g.items():
        if isinstance(v, np.ndarray) and k not in ("lat", "lon"):
            out[k] = torch.as_tensor(v, device=device, dtype=torch.long if v.dtype.kind == "i" else torch.float32)
        else:
            out[k] = v
    return out


# --- forcings -----------------------------------------------------------------


def forcings(time_days: float, lat_deg, lon_deg, device) -> torch.Tensor:
    """(5, H, W): 6-h TOA insolation / 1.5e7 and the four clock features, in
    f32 from f32 epoch seconds."""
    sec = torch.tensor(time_days, dtype=torch.float32, device=device) * 86400.0
    lat = torch.deg2rad(torch.as_tensor(lat_deg, dtype=torch.float32, device=device))[:, None]
    lonr = torch.deg2rad(torch.as_tensor(lon_deg, dtype=torch.float32, device=device))[None, :]
    days = sec / 86400.0
    g = 2 * math.pi * torch.remainder(days, 365.25) / 365.25
    decl = (0.006918 - 0.399912 * torch.cos(g) + 0.070257 * torch.sin(g) - 0.006758 * torch.cos(2 * g)
            + 0.000907 * torch.sin(2 * g) - 0.002697 * torch.cos(3 * g) + 0.00148 * torch.sin(3 * g))
    e0 = (1.000110 + 0.034221 * torch.cos(g) + 0.001280 * torch.sin(g) + 0.000719 * torch.cos(2 * g)
          + 0.000077 * torch.sin(2 * g))
    hours, n_sub = 6.0, 24
    total = torch.zeros(lat.shape[0], lonr.shape[1], device=device)
    for i in range(n_sub):
        hour_angle = 2 * math.pi * torch.remainder(days - hours * (i + 0.5) / n_sub / 24.0, 1.0) - math.pi + lonr
        total += (torch.sin(lat) * torch.sin(decl) + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle)).clamp_min(0)
    tisr = 1361.0 * e0 * (total / n_sub) * hours * 3600 / 1.5e7
    lon = torch.as_tensor(lon_deg, dtype=torch.float32, device=device)[None, :]
    ones = torch.ones(lat.shape[0], lonr.shape[1], device=device)
    local = torch.remainder(torch.remainder(days, 1.0) + lon / 360.0, 1.0)
    year = torch.remainder(days, 365.25) / 365.25
    clock = [torch.sin(2 * math.pi * local) * ones, torch.cos(2 * math.pi * local) * ones,
             torch.sin(2 * math.pi * year) * ones, torch.cos(2 * math.pi * year) * ones]
    return torch.stack([tisr, *clock])


# --- the network ----------------------------------------------------------------


def _dense(x, w, p, quant, lo=None, hi=None, bias=True):
    k = w[p + ".kernel"]
    y = ein("ni,io->no", x, k if lo is None else k[lo:hi], quant)
    return y + w[p + ".bias"] if bias else y


def mlp(w, p, x, quant, x2=None, norm=True):
    """Dense → swish → Dense [→ LayerNorm] over rows; ``x2`` the second
    part of a concatenated input. Rows in chunks."""
    out = []
    for lo in range(0, x.shape[0], CHUNK):
        xs = x[lo:lo + CHUNK]
        h = _dense(xs, w, p + ".Dense_0", quant, 0, xs.shape[1])
        if x2 is not None:
            h = h + _dense(x2[lo:lo + CHUNK], w, p + ".Dense_0", quant, xs.shape[1], None, bias=False)
        y = _dense(swish(h), w, p + ".Dense_1", quant)
        out.append(layer_norm(y, w[p + ".LayerNorm_0.scale"], w[p + ".LayerNorm_0.bias"]) if norm else y)
    return torch.cat(out)


def _messages(w, p, e_part, src_part, dst_part, src, dst, n_dst, quant, residual=None):
    """Per edge LN(swish(e + src + dst + b0) @ W1 + b1) (+ the edge, for a
    processor round), and their sum into each destination node."""
    L = src_part.shape[1]
    agg = torch.zeros(n_dst, L, device=src_part.device)
    new = []
    for lo in range(0, src.shape[0], CHUNK):
        s, d = src[lo:lo + CHUNK], dst[lo:lo + CHUNK]
        h = e_part[lo:lo + CHUNK] + src_part[s] + dst_part[d] + w[p + ".Dense_0.bias"]
        m = _dense(swish(h), w, p + ".Dense_1", quant)
        m = layer_norm(m, w[p + ".LayerNorm_0.scale"], w[p + ".LayerNorm_0.bias"])
        if residual is not None:
            m = residual[lo:lo + CHUNK] + m
            new.append(m)
        agg.index_add_(0, d, m)
    return agg, (torch.cat(new) if residual is not None else None)


def static_terms(w, cfg, g, quant=None) -> dict:
    """What a step shares with every other step of one parameter set: the
    embedded mesh nodes and multimesh edges, and the edge and receiver parts
    of the grid→mesh and mesh→grid messages that depend on the geometry
    alone.  Not counted as a step's work."""
    L = cfg["latent"]
    mesh0 = mlp(w, "net.embed_mesh", g["mesh_nf"], quant)
    e = mlp(w, "net.g2m.edge_embed", g["g2m_ef"], quant)
    g2m_e = _dense(e, w, "net.g2m.message.Dense_0", quant, 0, L, bias=False)
    e = mlp(w, "net.m2g.edge_embed", g["m2g_ef"], quant)
    m2g_e = _dense(e, w, "net.m2g.message.Dense_0", quant, 0, L, bias=False)
    return {"mesh0": mesh0, "mm0": mlp(w, "net.embed_mm", g["mm_ef"], quant), "g2m_e": g2m_e,
            "g2m_d": _dense(mesh0, w, "net.g2m.message.Dense_0", quant, 2 * L, 3 * L, bias=False), "m2g_e": m2g_e}


def forward(w, cfg, g, x: torch.Tensor, time_days: float, quant=None, static=None) -> torch.Tensor:
    """(2, C, H, W) physical frames, the newest last → (C, H, W)."""
    L, H, W = cfg["latent"], cfg["lat"], cfg["lon"]
    C = x.shape[1]
    st = static_terms(w, cfg, g, quant) if static is None else static
    mean, std = w["norm.mean"], w["norm.std"]
    xn = (x - mean) / std
    frc = forcings(time_days, g["lat"], g["lon"], x.device).reshape(N_FORCINGS, -1)
    grid = mlp(w, "net.embed_grid", torch.cat([xn.reshape(2 * C, -1), frc, g["grid_nf"].T]).T, quant)
    n_mesh = g["n_mesh"]
    # grid → mesh
    src = _dense(grid, w, "net.g2m.message.Dense_0", quant, L, 2 * L, bias=False)
    agg, _ = _messages(w, "net.g2m.message", st["g2m_e"], src, st["g2m_d"], g["g2m_src"], g["g2m_dst"], n_mesh,
                       quant)
    mesh = st["mesh0"] + mlp(w, "net.g2m.MLP_0", st["mesh0"], quant, x2=agg)
    grid = grid + mlp(w, "net.grid_update", grid, quant)
    mm = st["mm0"]
    for r in range(cfg["processor_rounds"]):
        p = f"net.round_{r}.MLP_0"
        pe, ps, pd = (_dense(t, w, p + ".Dense_0", quant, a * L, (a + 1) * L, bias=False)
                      for a, t in enumerate((mm, mesh, mesh)))
        agg, mm = _messages(w, p, pe, ps, pd, g["mm_src"], g["mm_dst"], n_mesh, quant, residual=mm)
        mesh = mesh + mlp(w, f"net.round_{r}.MLP_1", mesh, quant, x2=agg)
    # mesh → grid
    ps = _dense(mesh, w, "net.m2g.message.Dense_0", quant, L, 2 * L, bias=False)
    pd = _dense(grid, w, "net.m2g.message.Dense_0", quant, 2 * L, 3 * L, bias=False)
    agg, _ = _messages(w, "net.m2g.message", st["m2g_e"], ps, pd, g["m2g_src"], g["m2g_dst"], H * W, quant)
    grid = grid + mlp(w, "net.m2g.MLP_0", grid, quant, x2=agg)
    delta = mlp(w, "net.head", grid, quant, norm=False).T.reshape(C, H, W)
    return (xn[-1] + delta) * std + mean


def param_shapes(cfg: dict, n_in: int) -> dict[str, tuple]:
    """The flax parameter shapes of the net at the configuration's sizes."""
    L, C = cfg["latent"], cfg["in_channels"]
    s = {}

    def add_mlp(p, din, dout, norm=True):
        s.update({p + ".Dense_0.kernel": (din, L), p + ".Dense_0.bias": (L,),
                  p + ".Dense_1.kernel": (L, dout), p + ".Dense_1.bias": (dout,)})
        if norm:
            s.update({p + ".LayerNorm_0.scale": (dout,), p + ".LayerNorm_0.bias": (dout,)})

    add_mlp("net.embed_grid", n_in, L)
    add_mlp("net.embed_mesh", 3, L)
    add_mlp("net.embed_mm", 4, L)
    for b in ("g2m", "m2g"):
        add_mlp(f"net.{b}.edge_embed", 4, L)
        add_mlp(f"net.{b}.message", 3 * L, L)
        add_mlp(f"net.{b}.MLP_0", 2 * L, L)
    for r in range(cfg["processor_rounds"]):
        add_mlp(f"net.round_{r}.MLP_0", 3 * L, L)
        add_mlp(f"net.round_{r}.MLP_1", 2 * L, L)
    add_mlp("net.grid_update", L, L)
    add_mlp("net.head", L, C, norm=False)
    return s


@torch.no_grad()
def forecast_step(w, cfg, x: torch.Tensor, time_days: float, quant=None) -> torch.Tensor:
    g = graph_on(build_graph(cfg["lat"], cfg["lon"], cfg["mesh_refinements"]), x.device)
    with exact_f32():
        return forward(w, cfg, g, x, time_days, quant)

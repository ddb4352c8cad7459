"""GraphCast's static tables, forcings and kernels K6-K9 against the JAX package.

CPU:
- the port's table builders (ops/graph.py, grid.py) give the JAX
  package's tables: integer tables exactly, features to 1e-6;
- the TISR and clock forcings match the JAX versions to 1e-5 relative;
- each plain version of K6-K9 matches the JAX Pallas kernel (run in
  interpret mode, as tests/ops/test_fused_mlp.py runs it) and its XLA
  ``reference_*`` twin on the same numpy inputs: in f32 at atol 2e-5 (the
  tolerance of tests/ops/test_fused_mlp.py:242; 1e-4 relative as well for
  the aggregates, which sum several messages), in bf16 at the golden
  tolerance 3e-2·std(reference) on the mean, the spread and the RMS of
  the difference, 10× that elementwise (the two round intermediates at
  different points: the JAX twins add and apply swish in bf16).

JAX is imported inside the CPU tests only: the card's machine has no JAX
and runs the GPU tests of this file alone.

GPU (marker ``gpu``, skipped without a card): each kernel against its
plain version on the card in bf16, at small shapes that take the awkward
paths (Cin 3, 4 and feature-major 174, Cout 83, padding rows, tiles that
do not divide the grid).  Tolerance, as for K1-K4: elementwise
|kernel − plain| ≤ 2e-2·std(plain) + 2 bf16 ulps of max|plain|.
"""

import datetime

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import fused_mlp as FM
from skyrim_tpu_torch.ops import graph as G
from skyrim_tpu_torch.ops import graph_kernels as GK


def _n(rng, *shape, s=1.0):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _t(tree, dtype=torch.float32, device="cpu"):
    if isinstance(tree, tuple):
        return tuple(_t(t, dtype, device) for t in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a).to(device, dtype)


def _j(tree, dtype=None):
    import jax.numpy as jnp

    if isinstance(tree, tuple):
        return tuple(_j(t, dtype) for t in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    return jnp.asarray(a, a.dtype if a.dtype.kind in "iu" else (dtype or jnp.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_f32(out, ref, agg=False):
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=1e-4 if agg else 0)


def _close_bf16(out, ref):
    """The golden tolerance tol = 3e-2·std(ref) (tests/test_golden.py:74) on
    the mean, the spread and the RMS of the difference, 10·tol elementwise."""
    out, ref = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    tol = 3e-2 * ref.std()
    d = out - ref
    assert abs(out.mean() - ref.mean()) < tol and abs(out.std() - ref.std()) < tol
    assert np.sqrt((d**2).mean()) < tol and np.abs(d).max() < 10 * tol, (np.abs(d).max(), tol)


# --- tables ------------------------------------------------------------------


def _assert_tables_equal(out: dict, ref: dict):
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        o = out[k]
        if isinstance(r, np.ndarray) and r.dtype.kind == "f":
            assert o.shape == r.shape and o.dtype == r.dtype, k
            np.testing.assert_allclose(o, r, atol=1e-6, rtol=0, err_msg=k)
        elif isinstance(r, np.ndarray):
            np.testing.assert_array_equal(o, r, err_msg=k)
            assert o.dtype == r.dtype, k
        else:
            assert o == r, k


def test_multimesh_equals_jax():
    from skyrim_tpu.grid import icosahedral_multimesh as j_mesh

    from skyrim_tpu_torch.grid import icosahedral_multimesh

    _assert_tables_equal(
        {k: v for k, v in icosahedral_multimesh(2).items() if k != "per_level_edge_counts"},
        {k: v for k, v in j_mesh(2).items() if k != "per_level_edge_counts"},
    )
    assert icosahedral_multimesh(2)["per_level_edge_counts"] == j_mesh(2)["per_level_edge_counts"]


def test_build_graphs_equals_jax():
    from skyrim_tpu.ops.graph import build_graphs as j_build

    _assert_tables_equal(G.build_graphs(19, 36, 2), j_build(19, 36, 2))


@pytest.mark.parametrize("target_rows,block_multiple", [(1024, 1), (64, 4)])
def test_block_plan_and_padding_equal_jax(target_rows, block_multiple):
    from skyrim_tpu.ops import graph as JG

    g = G.build_graphs(19, 36, 2)
    for dst, n_seg, feats in ((g["mesh_dst"], g["n_mesh"], (g["mesh_src"], g["mesh_efeat"])),
                              (g["g2m_dst"], g["n_mesh"], (g["g2m_src"], g["g2m_efeat"]))):
        plan = G.build_block_plan(dst, n_seg, target_rows=target_rows, block_multiple=block_multiple)
        ref = JG.build_block_plan(dst, n_seg, target_rows=target_rows, block_multiple=block_multiple)
        _assert_tables_equal(plan, ref)
        for a in feats:
            np.testing.assert_array_equal(G.pad_rows_to_blocks(a, plan), JG.pad_rows_to_blocks(a, ref))


def test_face_tiles_equal_jax():
    """Random faces on an 11x18 grid in 4x8 tiles (partial tiles in both
    dimensions, tests/ops/test_fused_mlp.py:367) and the 19x36 graph's."""
    from skyrim_tpu.ops.graph import build_face_tiles as j_tiles

    face_hw = np.random.default_rng(1).integers(0, 7, size=(11, 18)).astype(np.int32)
    _assert_tables_equal(G.build_face_tiles(face_hw, th=4, tw=8), j_tiles(face_hw, th=4, tw=8))
    g = G.build_graphs(19, 36, 2)
    face = g["m2g_face"].reshape(19, 36)
    _assert_tables_equal(G.build_face_tiles(face, th=8, tw=16), j_tiles(face, th=8, tw=16))


def _random_g2m_edges(H=12, W=20, n_mesh=9, seed=0):
    """Random sparse edges, out-degree 0..3 (tests/ops/test_fused_mlp.py:305)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for p in range(H * W):
        for d in rng.choice(n_mesh, size=rng.integers(0, 4), replace=False):
            src.append(p)
            dst.append(int(d))
    return np.asarray(src), np.asarray(dst), rng.normal(size=(len(src), 4)).astype(np.float32)


def test_g2m_tiles_equal_jax():
    from skyrim_tpu.ops.graph import build_g2m_tiles as j_tiles
    from skyrim_tpu.ops.graph import pick_exact_tile as j_pick

    src, dst, ef = _random_g2m_edges()
    _assert_tables_equal(G.build_g2m_tiles(src, dst, ef, 12, 20, 9), j_tiles(src, dst, ef, 12, 20, 9))
    g = G.build_graphs(19, 36, 2)
    args = (g["g2m_src"], g["g2m_dst"], g["g2m_efeat"], 19, 36, g["n_mesh"])
    _assert_tables_equal(G.build_g2m_tiles(*args), j_tiles(*args))
    for n, t, m in ((721, 16, 1), (1440, 192, 16), (19, 16, 1), (36, 192, 16)):
        assert G.pick_exact_tile(n, t, m) == j_pick(n, t, m)


def test_block_helpers_match_jax():
    import jax.numpy as jnp

    from skyrim_tpu.ops import graph as JG

    g = G.build_graphs(19, 36, 2)
    plan = G.build_block_plan(g["mesh_dst"], g["n_mesh"], target_rows=64)
    rng = np.random.default_rng(3)
    blocks = _n(rng, *plan["local"].shape, 8)
    seg_vals = _n(rng, plan["n_seg"], 8)
    np.testing.assert_allclose(
        G.block_segment_sum(torch.from_numpy(blocks), plan).numpy(),
        np.asarray(JG.block_segment_sum(jnp.asarray(blocks), plan)), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(
        G.block_expand_dst(torch.from_numpy(seg_vals), plan).numpy(),
        np.asarray(JG.block_expand_dst(jnp.asarray(seg_vals), plan)), atol=2e-5, rtol=1e-5)
    oh = G.block_onehot(torch.from_numpy(plan["local"]), plan["SB"], torch.float32)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(JG.block_onehot(plan, jnp.float32)))


# --- forcings ----------------------------------------------------------------


@pytest.mark.parametrize("when", [datetime.datetime(2024, 1, 1, 6), datetime.datetime(1999, 7, 14, 17, 30)])
def test_forcings_match_jax(when):
    """Both packages round the epoch seconds to float32 (the JAX state holds
    float32 days); the fields then agree to 1e-5 relative."""
    from skyrim_tpu.data.solar import clock_features_jax, toa_incident_solar_radiation_jax

    from skyrim_tpu_torch.data.solar import clock_features_torch, toa_incident_solar_radiation_torch
    from skyrim_tpu_torch.grid import LatLonGrid

    grid = LatLonGrid(19, 36)
    days = (when - datetime.datetime(1970, 1, 1)).total_seconds() / 86400.0
    sec32 = np.float32(days) * np.float32(86400.0)
    sec = torch.tensor(days, dtype=torch.float32) * 86400.0
    assert sec.item() == float(sec32)
    ref = np.asarray(toa_incident_solar_radiation_jax(sec32, grid.lat, grid.lon, integration_hours=6.0))
    out = toa_incident_solar_radiation_torch(sec, grid.lat, grid.lon, integration_hours=6.0).numpy()
    assert ref.max() > 0 and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * ref.max())
    ref = np.asarray(clock_features_jax(sec32, grid.lat, grid.lon))
    np.testing.assert_allclose(clock_features_torch(sec, grid.lat, grid.lon).numpy(), ref, rtol=1e-5, atol=1e-5)


# --- K6 plain ----------------------------------------------------------------

MLP_CASES = {
    # name: (N, Cin, Cin2, H, Cout, ln, residual, x_transposed)
    "ln": (700, 24, 0, 48, 16, True, False, False),
    "no_ln": (700, 24, 0, 48, 16, False, False, False),
    "x2_residual": (516, 24, 16, 48, 24, True, True, False),
    "transposed": (700, 21, 0, 48, 16, True, False, True),
    "head_cout83": (300, 32, 0, 32, 83, False, False, False),
    "no_ln_residual": (300, 16, 0, 32, 16, False, True, False),
    # H == Cout with all four: the card's whole-row finish (second Dense,
    # LayerNorm, residual in one launch)
    "h_eq_cout_ln_x2_residual": (300, 24, 16, 32, 32, True, True, False),
}


def _mlp_inputs(spec, seed=0):
    N, Cin, Cin2, H, Cout, ln, res, xt = spec
    rng = np.random.default_rng(seed)
    x = _n(rng, Cin, N) if xt else _n(rng, N, Cin)
    return dict(
        x=x,
        w1b1=(_n(rng, Cin + Cin2, H, s=0.2), _n(rng, H, s=0.1)),
        w2b2=(_n(rng, H, Cout, s=0.2), _n(rng, Cout, s=0.1)),
        ln=(_n(rng, Cout), _n(rng, Cout)) if ln else None,
        x2=_n(rng, N, Cin2) if Cin2 else None,
        residual=_n(rng, N, Cout) if res else None,
    ), xt


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_plain_mlp_matches_jax(case):
    import jax.numpy as jnp

    from skyrim_tpu.ops.fused_mlp import fused_mlp as j_fused
    from skyrim_tpu.ops.fused_mlp import reference_mlp as j_ref

    a, xt = _mlp_inputs(MLP_CASES[case])
    order = ("x", "w1b1", "w2b2", "ln")
    for dt, jdt, close in ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16)):
        out = FM.reference_mlp(*(_t(a[k], dt) for k in order), x2=_t(a["x2"], dt),
                               residual=_t(a["residual"], dt), x_transposed=xt)
        assert out.dtype == dt
        jx = _j(a["x"], jdt)
        jkw = dict(x2=_j(a["x2"], jdt), residual=_j(a["residual"], jdt), x_transposed=xt)
        jargs = (_j(a["w1b1"]), _j(a["w2b2"]), _j(a["ln"]))
        close(out, j_fused(jx, *jargs, interpret=True, **jkw))
        close(out, j_ref(jx, *jargs, **jkw))
    # the CPU wrapper is the plain version
    torch.testing.assert_close(FM.fused_mlp(*(_t(a[k]) for k in order), x2=_t(a["x2"]),
                                            residual=_t(a["residual"]), x_transposed=xt),
                               FM.reference_mlp(*(_t(a[k]) for k in order), x2=_t(a["x2"]),
                                                residual=_t(a["residual"]), x_transposed=xt))


# --- K7-K9 plain ---------------------------------------------------------------


def _finish_params(rng, L):
    return _n(rng, L, s=0.1), (_n(rng, L, L, s=0.2), _n(rng, L, s=0.1)), (_n(rng, L), _n(rng, L))


def _round_inputs(B=4, M=64, SB=16, L=16, seed=23, layout="sorted"):
    """As tests/ops/test_fused_mlp.py:142: sorted local ids with padding;
    ``unsorted`` shuffles each block's ids, ``all_padding_block`` makes every
    row of block 1 a padding row."""
    rng = np.random.default_rng(seed)
    local = np.sort(rng.integers(0, SB + 1, size=(B, M)), axis=-1).astype(np.int32)
    assert (local == SB).any()  # padding rows are on the path
    if layout == "unsorted":
        local = rng.permuted(local, axis=-1)
        assert (np.diff(local, axis=-1) < 0).any()
    elif layout == "all_padding_block":
        local[1] = SB
    b0, wb, ln = _finish_params(rng, L)
    return (_n(rng, B, M, L), _n(rng, B, M, L, s=0.3), _n(rng, B, SB, L, s=0.3), local,
            _n(rng, L, L, s=0.2), b0, wb, ln, SB)


ROUND_LAYOUTS = ("sorted", "unsorted", "all_padding_block")


@pytest.mark.parametrize("layout", ROUND_LAYOUTS)
def test_plain_round_matches_jax(layout):
    import jax.numpy as jnp

    from skyrim_tpu.ops.graph_kernels import fused_round_messages as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_round_messages as j_ref

    a = _round_inputs(layout=layout)
    for dt, jdt, close in ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16)):
        ne, agg = GK.fused_round_messages(*_t(a[:3], dt), _t(a[3]), *_t(a[4:8]), a[8])
        if layout == "all_padding_block":
            assert not agg[1].any()  # no row of the block aggregates
        jin = (*_j(a[:3], jdt), _j(a[3]), *_j(a[4:8]))
        for j_ne, j_agg in (j_fused(*jin, a[8], interpret=True), j_ref(*jin, a[8])):
            close(ne, j_ne)
            if dt == torch.float32:
                _close_f32(agg, j_agg, agg=True)
            else:
                close(agg, j_agg)


def _m2g_inputs(H=11, W=18, L=16, n_faces=7, th=4, tw=8, seed=1):
    """As tests/ops/test_fused_mlp.py:367: tiles that do not divide the grid."""
    rng = np.random.default_rng(seed)
    face_hw = rng.integers(0, n_faces, size=(H, W)).astype(np.int32)
    ft = G.build_face_tiles(face_hw, th=th, tw=tw)
    assert H % th and W % tw
    uniq = _n(rng, n_faces, 3 * L)[ft["tile_faces"]]
    b0, wb, ln = _finish_params(rng, L)
    return (uniq, ft["tile_local"], _n(rng, H, W, 3 * L, s=0.3), _n(rng, H, W, L, s=0.3), b0, wb, ln, 3,
            ft["th"], ft["tw"])


# K8's shapes: face tiles that do not divide the grid (all three); grid
# points not a multiple of the kernel's 21-point tile (11 x 18 = 198,
# 37 x 70 = 2,590 = 21 * 123 + 7) and fewer than one tile (3 x 5)
M2G_SHAPES = {
    "11x18": dict(H=11, W=18, n_faces=7, th=4, tw=8),
    "37x70": dict(H=37, W=70, n_faces=40, th=8, tw=16),
    "3x5": dict(H=3, W=5, n_faces=5, th=2, tw=4),
}


@pytest.mark.parametrize("shape", sorted(M2G_SHAPES))
def test_plain_m2g_matches_jax(shape):
    import jax.numpy as jnp

    from skyrim_tpu.ops.graph_kernels import fused_m2g_tiled as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_m2g_tiled as j_ref

    a = _m2g_inputs(**M2G_SHAPES[shape])
    H, W = a[1].shape
    for dt, jdt, close in ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16)):
        out = GK.fused_m2g_tiled(_t(a[0], dt), _t(a[1]), *_t(a[2:4], dt), *_t(a[4:7]), *a[7:])
        assert out.shape == (H, W, 16) and out.dtype == dt
        jin = (_j(a[0], jdt), _j(a[1]), *_j(a[2:4], jdt), *_j(a[4:7]), *a[7:])
        close(out, j_fused(*jin, interpret=True))
        close(out, j_ref(*jin))


def _g2m_inputs(H=12, W=20, L=16, seed=0):
    src, dst, ef = _random_g2m_edges(H, W, seed=seed)
    gt = G.build_g2m_tiles(src, dst, ef, H, W, 9)
    rng = np.random.default_rng(seed + 1)
    b0, wb, ln = _finish_params(rng, L)
    assert (gt["local"] == gt["U"]).any()  # empty slots are on the path
    return (_n(rng, H, W, L), _n(rng, H, W, gt["D"] * L, s=0.3), gt["local"], b0, wb, ln,
            gt["D"], gt["U"], gt["th"], gt["tw"]), gt


def test_plain_g2m_matches_jax():
    import jax.numpy as jnp

    from skyrim_tpu.ops.graph_kernels import fused_g2m_tiled as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_g2m_tiled as j_ref

    a, _ = _g2m_inputs()
    for dt, jdt, close in ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16)):
        out = GK.fused_g2m_tiled(*_t(a[:2], dt), _t(a[2]), *_t(a[3:6]), *a[6:])
        jin = (*_j(a[:2], jdt), _j(a[2]), *_j(a[3:6]), *a[6:])
        for ref in (j_fused(*jin, interpret=True), j_ref(*jin)):
            if dt == torch.float32:
                _close_f32(out, ref, agg=True)
            else:
                close(out, ref)


def _g2m_plan_cases():
    """(local_t, U, th, tw) of the random tables and of the 19x36 graph's."""
    _, gt = _g2m_inputs()
    g = G.build_graphs(19, 36, 2)
    g19 = G.build_g2m_tiles(g["g2m_src"], g["g2m_dst"], g["g2m_efeat"], 19, 36, g["n_mesh"])
    return {name: (t["local"], t["U"], t["th"], t["tw"]) for name, t in (("random", gt), ("graph_19x36", g19))}


@pytest.mark.parametrize("case", ["random", "graph_19x36"])
def test_g2m_row_plan_lists_filled_slots(case):
    """Every filled slot exactly once and no empty one, sorted by (tile, u)
    and within a destination by (k, r); csr consistent, empty destinations
    present as empty ranges."""
    local_t, U, th, tw = _g2m_plan_cases()[case]
    TH, TW, D, R = local_t.shape
    W = TW * tw
    rows, csr = G.g2m_row_plan(local_t, U, th, tw)
    assert rows.dtype == np.int32 and csr.dtype == np.int32 and csr.shape == (TH * TW * U + 1,)
    want, want_dst = [], []
    for g in range(TH * TW):
        ti, tj = divmod(g, TW)
        for u in range(U):
            for k in range(D):
                for r in range(R):
                    if local_t[ti, tj, k, r] == u:
                        i, j = ti * th + r // tw, tj * tw + r % tw
                        want.append((i * W + j) * D + k)
                        want_dst.append(g * U + u)
    np.testing.assert_array_equal(rows, np.asarray(want, np.int32))
    assert len(rows) == int((local_t < U).sum()) and len(set(rows.tolist())) == len(rows)
    assert csr[0] == 0 and csr[-1] == len(rows) and (np.diff(csr) >= 0).all()
    np.testing.assert_array_equal(np.diff(csr), np.bincount(want_dst, minlength=TH * TW * U))
    assert (np.diff(csr) == 0).any()  # empty destinations are on the path


def _compacted_g2m(asrc, bias, rows, csr, b0, wb, ln, D, shape):
    """K9's compacted formulation in plain torch: the plan's rows gathered,
    finished, and summed per destination in f32 by csr."""
    L = asrc.shape[-1]
    rows = rows.long()
    h = asrc.reshape(-1, L)[rows // D].float() + bias.reshape(-1, L)[rows].float()
    m = FM.reference_finish(h, b0, wb, ln, asrc.dtype).float()
    dst = torch.repeat_interleave(torch.arange(len(csr) - 1), torch.diff(csr.long()))
    acc = torch.zeros((len(csr) - 1, L), dtype=torch.float32).index_add_(0, dst, m)
    return acc.to(asrc.dtype).reshape(shape)


def test_compacted_g2m_matches_jax():
    import jax.numpy as jnp

    from skyrim_tpu.ops.graph_kernels import fused_g2m_tiled as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_g2m_tiled as j_ref

    a, gt = _g2m_inputs()
    rows, csr = (torch.from_numpy(x) for x in G.g2m_row_plan(gt["local"], gt["U"], gt["th"], gt["tw"]))
    TH, TW = gt["local"].shape[:2]
    for dt, jdt, close in ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16)):
        out = _compacted_g2m(*_t(a[:2], dt), rows, csr, *_t(a[3:6]), a[6], (TH, TW, gt["U"], 16))
        jin = (*_j(a[:2], jdt), _j(a[2]), *_j(a[3:6]), *a[6:])
        refs = (GK.reference_g2m_tiled(*_t(a[:2], dt), _t(a[2]), *_t(a[3:6]), *a[6:]),
                j_fused(*jin, interpret=True), j_ref(*jin))
        for ref in refs:
            if dt == torch.float32:
                _close_f32(out, ref, agg=True)
            else:
                close(out, ref)


def test_g2m_wrapper_with_and_without_plan():
    a, gt = _g2m_inputs()
    args = (*_t(a[:2], torch.bfloat16), _t(a[2]), *_t(a[3:6]), *a[6:])
    plan = GK.g2m_plan(args[2], gt["U"], gt["th"], gt["tw"])
    torch.testing.assert_close(GK.fused_g2m_tiled(*args, plan=plan), GK.fused_g2m_tiled(*args), rtol=0, atol=0)


# --- GPU: kernels against their plain versions --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close_card(out, ref):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max()
    assert ((out - ref).abs() <= tol).all(), (float((out - ref).abs().max()), float(tol))


GPU_MLP_CASES = {
    # name: (N, Cin, Cin2, H, Cout, ln, residual, x_transposed)
    "embed_grid_cin174_transposed": (1000, 174, 0, 64, 64, True, False, True),
    # feature-major: N % 8 != 0 takes the element loads, N % 8 == 0 (and not
    # a multiple of the 128-row tile) the TMA kernel
    "feature_major_n1001_elements": (1001, 174, 0, 128, 128, True, False, True),
    "feature_major_n1000_tma": (1000, 174, 0, 128, 128, True, False, True),
    "embed_mesh_cin3": (1000, 3, 0, 64, 64, True, False, False),
    "edge_embed_cin4": (1000, 4, 0, 64, 64, True, False, False),
    "mesh_x2_residual": (1000, 64, 64, 64, 64, True, True, False),
    "head_cout83": (1000, 64, 0, 64, 83, False, False, False),
    "no_ln_residual": (1000, 64, 0, 128, 64, False, True, False),
    # the whole-row finish with its residual, M not a multiple of its 64-row tile
    "ln_residual_l64": (1000, 64, 0, 64, 64, True, True, False),
    "ln_x2_residual_l64": (1001, 64, 64, 64, 64, True, True, False),
    "ln_residual_l512": (1000, 512, 0, 512, 512, True, True, False),
    "ln_x2_residual_l512": (1001, 512, 512, 512, 512, True, True, False),
    # a LayerNorm with H != Cout: the second GEMM and the LayerNorm rows kernel
    "ln_h128_cout64_chain": (1000, 64, 0, 128, 64, True, True, False),
}

# fused_mlp's two launches by shape (ops/fused_mlp.py mlp_paths): the first
# product's A path and the finish.  GraphCast at published width (N = 721 x
# 1440 grid rows, 40,962 mesh nodes, L 512: the 21 K6 calls of a forward and
# the cache build's embedders), its golden test configuration's embedding,
# and every card test case above.
_GN = 721 * 1440
MLP_PATHS = {
    "graphcast_embed_grid": ((_GN, 174, 0, 512, 512, True, False, True), ("feature_major_tma", "rows_ln")),
    "graphcast_grid_update": ((_GN, 512, 0, 512, 512, True, True, False), ("rows", "rows_ln")),
    "graphcast_m2g_mlp0": ((_GN, 512, 512, 512, 512, True, True, False), ("rows", "rows_ln")),
    "graphcast_head": ((_GN, 512, 0, 512, 83, False, False, False), ("rows", "gemm")),
    "graphcast_mesh_mlps": ((40962, 512, 512, 512, 512, True, True, False), ("rows", "rows_ln")),
    "graphcast_embed_mesh": ((40962, 3, 0, 512, 512, True, False, False), ("elements", "rows_ln")),
    "graphcast_edge_embed": ((3 * _GN, 4, 0, 512, 512, True, False, False), ("elements", "rows_ln")),
    "golden_embed_grid": ((19 * 36, 16, 0, 16, 16, True, False, True), ("elements", "rows_ln")),
    "embed_grid_cin174_transposed": (GPU_MLP_CASES["embed_grid_cin174_transposed"], ("elements", "rows_ln")),
    "feature_major_n1001_elements": (GPU_MLP_CASES["feature_major_n1001_elements"], ("elements", "rows_ln")),
    "feature_major_n1000_tma": (GPU_MLP_CASES["feature_major_n1000_tma"], ("feature_major_tma", "rows_ln")),
    "embed_mesh_cin3": (GPU_MLP_CASES["embed_mesh_cin3"], ("elements", "rows_ln")),
    "edge_embed_cin4": (GPU_MLP_CASES["edge_embed_cin4"], ("elements", "rows_ln")),
    "mesh_x2_residual": (GPU_MLP_CASES["mesh_x2_residual"], ("rows", "rows_ln")),
    "head_cout83": (GPU_MLP_CASES["head_cout83"], ("rows", "gemm")),
    "no_ln_residual": (GPU_MLP_CASES["no_ln_residual"], ("rows", "gemm")),
    "ln_residual_l64": (GPU_MLP_CASES["ln_residual_l64"], ("rows", "rows_ln")),
    "ln_x2_residual_l64": (GPU_MLP_CASES["ln_x2_residual_l64"], ("rows", "rows_ln")),
    "ln_residual_l512": (GPU_MLP_CASES["ln_residual_l512"], ("rows", "rows_ln")),
    "ln_x2_residual_l512": (GPU_MLP_CASES["ln_x2_residual_l512"], ("rows", "rows_ln")),
    "ln_h128_cout64_chain": (GPU_MLP_CASES["ln_h128_cout64_chain"], ("rows", "gemm_ln_rows")),
}


@pytest.mark.parametrize("case", sorted(MLP_PATHS))
def test_mlp_paths(case):
    """The dispatch rule names the paths the kernels are built for: the
    feature-major TMA path only for embed_grid's shapes (no x2, N % 8 == 0,
    H a multiple of 128), the whole-row finish for every LayerNorm with
    H == Cout, the chain elsewhere; unaligned bases take the element loads."""
    spec, expected = MLP_PATHS[case]
    assert FM.mlp_paths(*spec) == expected
    N, Cin, Cin2, H, _, _, _, xt = spec
    assert FM.a_path(N, Cin, Cin2, H, xt, aligned=False) == "elements"


def test_mlp_paths_cover_card_cases():
    assert set(GPU_MLP_CASES) <= set(MLP_PATHS)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_MLP_CASES))
def test_mlp_kernel_matches_plain(cuda, case):
    a, xt = _mlp_inputs(GPU_MLP_CASES[case])
    order = ("x", "w1b1", "w2b2", "ln")
    args = [_t(a[k], torch.bfloat16 if k == "x" else torch.float32, cuda) for k in order]
    kw = dict(x2=_t(a["x2"], torch.bfloat16, cuda), residual=_t(a["residual"], torch.bfloat16, cuda),
              x_transposed=xt)
    before = FM.fused_mlp.launches
    ln_before, fin_before = sum(FM.ln_rows.launches_by_shape.values()), sum(FM.mlp_finish.launches_by_shape.values())
    out = FM.fused_mlp(*args, **kw)
    torch.cuda.synchronize()
    assert FM.fused_mlp.launches == before + 1
    finish = FM.mlp_paths(*GPU_MLP_CASES[case])[1]
    assert sum(FM.mlp_finish.launches_by_shape.values()) - fin_before == (finish == "rows_ln")
    assert sum(FM.ln_rows.launches_by_shape.values()) - ln_before == (finish == "gemm_ln_rows")
    _close_card(out, FM.reference_mlp(*args, **kw))


def _mlp_card_args(cuda, case):
    a, xt = _mlp_inputs(GPU_MLP_CASES[case])
    args = [_t(a[k], torch.bfloat16 if k == "x" else torch.float32, cuda) for k in ("x", "w1b1", "w2b2", "ln")]
    kw = dict(x2=_t(a["x2"], torch.bfloat16, cuda), residual=_t(a["residual"], torch.bfloat16, cuda),
              x_transposed=xt)
    return args, kw


@pytest.mark.gpu
def test_mlp_launches_ln_finish_and_head_chain(cuda):
    """A LayerNorm case launches the whole-row finish and no LayerNorm rows
    kernel; the head (Cout 83, no LayerNorm) still takes the second GEMM."""
    for case, finishes in (("ln_x2_residual_l512", 1), ("head_cout83", 0)):
        args, kw = _mlp_card_args(cuda, case)
        ln_before, fin_before = dict(FM.ln_rows.launches_by_shape), dict(FM.mlp_finish.launches_by_shape)
        FM.fused_mlp(*args, **kw)
        torch.cuda.synchronize()
        assert FM.ln_rows.launches_by_shape == ln_before
        M, L = GPU_MLP_CASES[case][0], GPU_MLP_CASES[case][4]
        key = (M, L, kw["residual"] is not None)
        assert FM.mlp_finish.launches_by_shape.get(key, 0) - fin_before.get(key, 0) == finishes


@pytest.mark.gpu
def test_mlp_repeat_equal_bits(cuda):
    """Two calls of K6 on the same inputs give the same bits."""
    args, kw = _mlp_card_args(cuda, "ln_x2_residual_l512")
    out, again = FM.fused_mlp(*args, **kw), FM.fused_mlp(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_mlp_finish_guard_rows(cuda):
    """The whole-row finish's TMA store into an output with 64 sentinel rows
    past M (M not a multiple of the 64-row tile): the guard rows come back
    unchanged, the rows before them equal the wrapper's output."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    M, L = 1001, 512
    rng = np.random.default_rng(8)
    h, res = _t(_n(rng, M, L), torch.bfloat16, cuda), _t(_n(rng, M, L), torch.bfloat16, cuda)
    wb = (_t(_n(rng, L, L, s=L**-0.5), torch.bfloat16, cuda), _t(_n(rng, L, s=0.1), device=cuda))
    ln = (_t(1 + _n(rng, L, s=0.1), device=cuda), _t(_n(rng, L, s=0.1), device=cuda))
    sentinel = 0x7FA5
    buf = torch.full((M + 64, L), sentinel, dtype=torch.int16, device=cuda)
    lib = FM._lib()
    err = lib.skt_mlp_finish(h.data_ptr(), wb[0].data_ptr(), wb[1].data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
                             res.data_ptr(), buf.data_ptr(), M, L, _EPS, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    out = FM.mlp_finish(h, wb, ln, res)
    torch.cuda.synchronize()
    assert (buf[M:] == sentinel).all()
    assert torch.equal(buf[:M].view(torch.bfloat16), out)


@pytest.mark.gpu
def test_mlp_feature_major_k_tail_not_read(cuda):
    """embed_grid's A as rows 0..173 of a (176, N) buffer, W1 as rows 0..173
    of a (176, H) buffer, both with 1e4 in rows 174-175: the feature-major
    TMA path's K tail comes in as zeros, never from those rows."""
    N, Cin, H = 1000, 174, 128
    assert FM.a_path(N, Cin, 0, H, True) == "feature_major_tma"
    a, _ = _mlp_inputs((N, Cin, 0, H, H, True, False, True))
    xbuf = torch.full((Cin + 2, N), 1e4, dtype=torch.bfloat16, device=cuda)
    wbuf = torch.full((Cin + 2, H), 1e4, dtype=torch.bfloat16, device=cuda)  # bf16: the wrapper reads it in place
    xbuf[:Cin] = _t(a["x"], torch.bfloat16, cuda)
    wbuf[:Cin] = _t(a["w1b1"][0], torch.bfloat16, cuda)
    x, w1b1 = xbuf[:Cin], (wbuf[:Cin], _t(a["w1b1"][1], device=cuda))
    args = (x, w1b1, _t(a["w2b2"], device=cuda), _t(a["ln"], device=cuda))
    out = FM.fused_mlp(*args, x_transposed=True)
    torch.cuda.synchronize()
    _close_card(out, FM.reference_mlp(*args, x_transposed=True))


def _close_card_per_element(out, ref):
    """For f32 sums of a varying number of messages: the ulps of each
    element's own |plain|, so a missing message is not hidden under the
    largest aggregate's."""
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs()
    assert ((out - ref).abs() <= tol).all(), float(((out - ref).abs() / tol).max())


@pytest.mark.gpu
def test_round_kernel_matches_plain_with_padding(cuda):
    a = _round_inputs(B=6, M=256, SB=48, L=64)
    bf = torch.bfloat16
    args = (*_t(a[:3], bf, cuda), _t(a[3], device=cuda), *_t(a[4:8], device=cuda), a[8])
    ne, agg = GK.fused_round_messages(*args)
    torch.cuda.synchronize()
    ne_r, agg_r = GK.reference_round_messages(*args)
    _close_card(ne, ne_r)
    _close_card(agg, agg_r)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 512], ids=["L64", "L512"])
@pytest.mark.parametrize("layout", ROUND_LAYOUTS)
def test_round_kernel_layouts_and_repeat(cuda, layout, L):
    """K7 on sorted, unsorted and all-padding ids, on the cp.async ring's
    64-wide tiles and at the width of the TMA kernel; two calls on the same
    inputs give the same bits."""
    a = _round_inputs(B=3, M=256, SB=48, L=L, layout=layout)
    bf = torch.bfloat16
    a = (*a[:4], a[4] * (16 / L) ** 0.5, a[5], (a[6][0] * (16 / L) ** 0.5, a[6][1]), *a[7:])  # unit-variance products
    args = (*_t(a[:3], bf, cuda), _t(a[3], device=cuda), *_t(a[4:8], device=cuda), a[8])
    ne, agg = GK.fused_round_messages(*args)
    ne2, agg2 = GK.fused_round_messages(*args)
    torch.cuda.synchronize()
    assert torch.equal(ne, ne2) and torch.equal(agg, agg2)
    ne_r, agg_r = GK.reference_round_messages(*args)
    _close_card(ne, ne_r)
    _close_card_per_element(agg, agg_r)


SEGSUM_IDS = ("sorted", "unsorted", "out_of_range")


@pytest.mark.gpu
@pytest.mark.parametrize("ids", SEGSUM_IDS)
def test_segment_sum_matches_scatter_add(cuda, ids):
    """The segmented sum against scatter_add_ in f32: ids in [0, S) aggregate
    in any order, every other id (S, beyond, negative) is skipped."""
    G_, R, S, C = 5, 333, 37, 192
    rng = np.random.default_rng(3)
    local = np.sort(rng.integers(0, S, size=(G_, R)), axis=-1).astype(np.int32)
    if ids == "unsorted":
        local = rng.permuted(local, axis=-1)
    elif ids == "out_of_range":
        local = rng.integers(-3, S + 4, size=(G_, R)).astype(np.int32)
        assert (local < 0).any() and (local >= S).any()
    x = _t(_n(rng, G_ * R, C), torch.bfloat16, cuda)
    loc = _t(local, device=cuda)
    out = FM.segment_sum(x, loc, S)
    again = FM.segment_sum(x, loc, S)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    acc = torch.zeros((G_, S + 1, C), dtype=torch.float32, device=cuda)
    idx = torch.where((loc >= 0) & (loc < S), loc, S).long()
    acc.scatter_add_(1, idx[..., None].expand(-1, -1, C), x.float().view(G_, R, C))
    _close_card_per_element(out, acc[:, :S].to(torch.bfloat16))


GPU_GEMM_SHAPES = {
    # name: (M, K1, K2, N, feature-major): the row GEMM's ragged edges
    "mesh_rows_m40962": (40962, 512, 0, 512, False),
    "head_n83": (4099, 512, 0, 83, False),
    "embed_k174_feature_major": (4099, 174, 0, 512, True),
    "split_k512_k512": (4099, 512, 512, 512, False),
    "k3_element_rows": (1000, 3, 0, 64, False),
    "n192_k768": (300, 768, 0, 192, False),
    # the TMA kernel's tile walk: M 1, 127, 129; three tiles for each of 132
    # blocks (one consumer a tile fewer); many tiles a block, at N 192 and
    # with a split K; and the expansion epilogue of K7 (skt_round_gemm) on
    # shuffled ids with padding rows, (B, M, SB, L)
    "m1_n512": (1, 512, 0, 512, False),
    "m127_n576": (127, 192, 0, 576, False),
    "m129_n192": (129, 768, 0, 192, False),
    "odd_tiles_per_block": (3 * 132 * 128 - 5, 128, 0, 128, False),
    "many_tiles_per_block_n192": (40000, 192, 0, 192, False),
    "many_tiles_split_k256_k256": (40000, 256, 256, 512, False),
    "round_gemm_shuffled_padded": ("round", 40, 1024, 176, 512),
}


def _round_gemm_matches_plain(cuda, B, M, SB, L):
    """skt_round_gemm through the library: h = bf16(swish(e @ We + gsrc +
    staged[local] + b0)), no staged row where local == SB."""
    import ctypes

    from skyrim_tpu_torch.ops import _build

    a = _round_inputs(B=B, M=M, SB=SB, L=L, layout="unsorted")
    bf = torch.bfloat16
    e, gsrc, staged = _t(a[:3], bf, cuda)
    local, we, b0 = _t(a[3], device=cuda), _t(a[4], bf, cuda), _t(a[5], device=cuda)
    rows = B * M
    h = torch.empty(rows, L, device=cuda, dtype=bf)
    lib = _build.load("graph_round")
    fn = lib.skt_round_gemm
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    err = fn(e.data_ptr(), we.data_ptr(), b0.data_ptr(), gsrc.data_ptr(), staged.data_ptr(), local.data_ptr(),
             h.data_ptr(), rows, L, M, SB, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "skt_round_gemm")
    torch.cuda.synchronize()
    hit = (local < SB).unsqueeze(-1)
    expand = torch.gather(staged.float(), 1, local.clamp(max=SB - 1).long().unsqueeze(-1).expand(B, M, L)) * hit
    pre = e.float().view(rows, L) @ we.float() + gsrc.float().view(rows, L) + expand.view(rows, L) + b0
    _close_card(h, torch.nn.functional.silu(pre).to(bf))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_GEMM_SHAPES))
def test_row_gemm_matches_matmul(cuda, case):
    """The row GEMM against torch.matmul in f32 on the same bf16 operands."""
    if GPU_GEMM_SHAPES[case][0] == "round":
        return _round_gemm_matches_plain(cuda, *GPU_GEMM_SHAPES[case][1:])
    M, K1, K2, N, xt = GPU_GEMM_SHAPES[case]
    rng = np.random.default_rng(5)
    a = _t(_n(rng, *((K1, M) if xt else (M, K1))), torch.bfloat16, cuda)
    a2 = _t(_n(rng, M, K2), torch.bfloat16, cuda) if K2 else None
    w = _t(_n(rng, K1 + K2, N, s=(K1 + K2) ** -0.5), torch.bfloat16, cuda)
    b = _t(_n(rng, N, s=0.1), device=cuda)
    out = FM.mlp_gemm(a, w, b, a2=a2, transposed=xt)
    torch.cuda.synchronize()
    rows = a.T.float() if xt else a.float()
    if a2 is not None:
        rows = torch.cat([rows, a2.float()], dim=1)
    _close_card(out, rows @ w.float() + b)


@pytest.mark.gpu
def test_m2g_kernel_matches_plain_partial_tiles(cuda):
    a = _m2g_inputs(H=37, W=70, L=64, n_faces=40, th=8, tw=16)
    bf = torch.bfloat16
    args = (_t(a[0], bf, cuda), _t(a[1], device=cuda), *_t(a[2:4], bf, cuda), *_t(a[4:7], device=cuda), *a[7:])
    out = GK.fused_m2g_tiled(*args)
    torch.cuda.synchronize()
    _close_card(out, GK.reference_m2g_tiled(*args))


def _m2g_card_args(cuda, shape, L):
    a = _m2g_inputs(L=L, **M2G_SHAPES[shape])
    bf = torch.bfloat16
    return (_t(a[0], bf, cuda), _t(a[1], device=cuda), *_t(a[2:4], bf, cuda), *_t(a[4:7], device=cuda), *a[7:])


@pytest.mark.gpu
@pytest.mark.parametrize("L", [16, 64, 512])
@pytest.mark.parametrize("shape", sorted(M2G_SHAPES))
def test_m2g_kernel_matches_plain(cuda, shape, L):
    """K8 in one launch, no LayerNorm rows launch beside it, against its
    plain version: a partial last 21-point tile (11 x 18, 37 x 70), a grid
    smaller than one tile (3 x 5), face tiles that do not divide the grid,
    and L 16 and 64 (columns and W rows past L read as 0) as well as 512."""
    args = _m2g_card_args(cuda, shape, L)
    before, ln_before = GK.fused_m2g_tiled.launches, dict(FM.ln_rows.launches_by_shape)
    out = GK.fused_m2g_tiled(*args)
    torch.cuda.synchronize()
    assert GK.fused_m2g_tiled.launches == before + 1 and FM.ln_rows.launches_by_shape == ln_before
    _close_card(out, GK.reference_m2g_tiled(*args))


@pytest.mark.gpu
def test_m2g_kernel_guard_rows(cuda):
    """K8's TMA store into an output with 64 sentinel rows past H·W (a
    partial last tile): the guard rows come back unchanged, the rows before
    them equal the wrapper's output."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    L = 512
    uniq, local, bias, ad, b0, wb, ln, _, th, tw = _m2g_card_args(cuda, "37x70", L)
    (H, W), (TH, TW, U, _) = local.shape, uniq.shape
    n, sentinel = H * W, 0x7FA5
    buf = torch.full((n + 64, L), sentinel, dtype=torch.int16, device=cuda)
    w = wb[0].to(torch.bfloat16).contiguous()
    lib = GK._m2g_lib()
    err = lib.skt_m2g_messages(uniq.data_ptr(), local.data_ptr(), bias.data_ptr(), ad.data_ptr(), b0.data_ptr(),
                               w.data_ptr(), wb[1].data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), buf.data_ptr(),
                               H, W, L, U, th, tw, TW, _EPS, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    out = GK.fused_m2g_tiled(uniq, local, bias, ad, b0, wb, ln, 3, th, tw)
    torch.cuda.synchronize()
    assert (buf[n:] == sentinel).all()
    assert torch.equal(buf[:n].view(torch.bfloat16), out.view(n, L))


@pytest.mark.gpu
def test_m2g_kernel_repeat_equal_bits(cuda):
    """Two launches of K8 on the same inputs give the same bits."""
    args = _m2g_card_args(cuda, "37x70", 512)
    out, again = GK.fused_m2g_tiled(*args), GK.fused_m2g_tiled(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_g2m_kernel_matches_plain(cuda):
    a, _ = _g2m_inputs(H=24, W=40, L=64)
    bf = torch.bfloat16
    args = (*_t(a[:2], bf, cuda), _t(a[2], device=cuda), *_t(a[3:6], device=cuda), *a[6:])
    out = GK.fused_g2m_tiled(*args)
    torch.cuda.synchronize()
    _close_card(out, GK.reference_g2m_tiled(*args))


def _g2m_empty_tile_inputs(H=24, W=40, L=64):
    """Tables with no edge from the first tile's points and E not a multiple of 64."""
    src, dst, ef = _random_g2m_edges(H, W, seed=4)
    th = G.pick_exact_tile(H, 16)
    keep = src >= th * W  # tw = W here: the first tile is rows 0 .. th - 1
    src, dst, ef = src[keep], dst[keep], ef[keep]
    if len(src) % 64 == 0:
        src, dst, ef = src[1:], dst[1:], ef[1:]
    gt = G.build_g2m_tiles(src, dst, ef, H, W, 9)
    assert gt["th"] == th and gt["tw"] == W and not (gt["local"][0, 0] < gt["U"]).any()
    rng = np.random.default_rng(5)
    b0, wb, ln = _finish_params(rng, L)
    return (_n(rng, H, W, L), _n(rng, H, W, gt["D"] * L, s=0.3), gt["local"], b0, wb, ln,
            gt["D"], gt["U"], gt["th"], gt["tw"]), gt


@pytest.mark.gpu
@pytest.mark.parametrize("with_plan", [False, True], ids=["own_plan", "table_plan"])
def test_g2m_kernel_empty_tile_ragged_rows(cuda, with_plan):
    """K9 with a tile that has no filled slot (its partials come out 0) and E
    not a multiple of the 64-row tile, with the plan built by the wrapper or
    passed in as the tables pass it."""
    a, gt = _g2m_empty_tile_inputs()
    bf = torch.bfloat16
    args = (*_t(a[:2], bf, cuda), _t(a[2], device=cuda), *_t(a[3:6], device=cuda), *a[6:])
    plan = GK.g2m_plan(args[2], gt["U"], gt["th"], gt["tw"]) if with_plan else None
    assert plan is None or plan[0].shape[0] % 64
    out = GK.fused_g2m_tiled(*args, plan=plan)
    torch.cuda.synchronize()
    assert not out[0, 0].any()
    _close_card_per_element(out, GK.reference_g2m_tiled(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 520])
def test_csr_sum_matches_in_order_sum(cuda, C):
    """The CSR sum against an in-order f32 sum of each destination's rows, bit
    for bit, twice for equal bits; empty ranges give 0."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 9, size=301)
    counts[::7] = 0
    csr = np.zeros(len(counts) + 1, np.int32)
    np.cumsum(counts, out=csr[1:])
    x = _t(_n(rng, int(csr[-1]), C), torch.bfloat16, cuda)
    c = torch.from_numpy(csr).to(cuda)
    out, again = GK.csr_sum(x, c), GK.csr_sum(x, c)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    acc = torch.zeros((len(counts), C), dtype=torch.float32, device=cuda)
    lo, hi = c[:-1].long(), c[1:].long()
    for i in range(int(counts.max())):
        hit = lo + i < hi
        acc[hit] += x[(lo + i)[hit]].float()
    assert torch.equal(out, acc.to(torch.bfloat16))


def _g2m_messages_inputs(cuda, L):
    """K9's messages inputs on the card at width L, with the plan's rows cut to
    a count that is not a multiple of the 64-row tile."""
    a, gt = _g2m_inputs(H=24, W=40, L=L, seed=6)
    bf = torch.bfloat16
    s = (16 / L) ** 0.5  # unit-variance products at any width
    asrc, bias = _t(a[0], bf, cuda), _t(a[1], bf, cuda)
    b0, wb, ln = _t(a[3], device=cuda), (_t(a[4][0] * s, device=cuda), _t(a[4][1], device=cuda)), _t(a[5], device=cuda)
    rows, _ = GK.g2m_plan(_t(a[2], device=cuda), gt["U"], gt["th"], gt["tw"])
    rows = rows[: len(rows) - (1 if len(rows) % 64 == 0 else 0)]
    return asrc, bias, rows, b0, wb, ln, gt["D"]


def _within_ulps(out, ref, n=2):
    """Every element of out within n bf16 ulps of ref's value."""
    ref = ref.float()
    assert torch.isfinite(out.float()).all()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-100))) - 7)
    assert ((out.float() - ref).abs() <= n * ulp).all(), float(((out.float() - ref).abs() / ulp).max())


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 512])
def test_g2m_messages_match_gemm_ln_chain(cuda, L):
    """The fused messages kernel against the two-launch chain on the same
    gathered rows (the finish GEMM, rowgemm_kernel with its own swish
    prologue, then the LayerNorm rows kernel): with one of its two sources
    given the rows and the other zero ((x + 0) + b0 == x + b0 in f32, each
    source in turn) the rounding points are the same and only the order of
    the sums differs, so within 2 bf16 ulps of the chain's value.  With both
    sources, against K14's messages on the same rows gathered beforehand."""
    asrc, bias, rows, b0, wb, ln, D = _g2m_messages_inputs(cuda, L)
    r = rows.long()
    src = asrc.view(-1, L)[r // D].contiguous()
    y = FM.finish_gemm(src, b0, wb)
    chain = FM.ln_rows(y, ln, out=y)
    as_bias = asrc.view(-1, L).repeat_interleave(D, 0).view(bias.shape)  # bias row r = asrc row r // D
    for a, bb in ((asrc, torch.zeros_like(bias)), (torch.zeros_like(asrc), as_bias)):
        _within_ulps(GK.g2m_messages(a, bb, rows, b0, wb, ln, D), chain)
    m = GK.g2m_messages(asrc, bias, rows, b0, wb, ln, D)
    _within_ulps(m, GK.block_messages(src, bias.view(-1, L)[r].contiguous(), b0, wb, ln))


@pytest.mark.gpu
def test_g2m_messages_guard_rows(cuda):
    """The messages' TMA store into an output with 64 sentinel rows past E:
    the guard rows come back unchanged, the rows before them equal the
    wrapper's output."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    L = 512
    asrc, bias, rows, b0, wb, ln, D = _g2m_messages_inputs(cuda, L)
    E, sentinel = rows.shape[0], 0x7FA5
    buf = torch.full((E + 64, L), sentinel, dtype=torch.int16, device=cuda)
    w = wb[0].to(torch.bfloat16).contiguous()
    lib = GK._g2m_lib()
    err = lib.skt_g2m_messages(asrc.data_ptr(), bias.data_ptr(), b0.data_ptr(), w.data_ptr(), wb[1].data_ptr(),
                               ln[0].data_ptr(), ln[1].data_ptr(), rows.data_ptr(), buf.data_ptr(), E, L, D, _EPS,
                               torch.cuda.current_stream().cuda_stream)
    assert err == 0
    m = GK.g2m_messages(asrc, bias, rows, b0, wb, ln, D)
    torch.cuda.synchronize()
    assert (buf[E:] == sentinel).all()
    assert torch.equal(buf[:E].view(torch.bfloat16), m)

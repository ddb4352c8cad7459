"""The finish and untiled message ops K12, K13, K14 of the port against the
JAX package.

CPU: the same numpy inputs go through the JAX Pallas kernel (interpret
mode, as tests/ops/test_fused_mlp.py:80-119,235-242 runs it), its XLA
``reference_*`` twin and the port's function, whose CPU path is its plain
PyTorch version.  f32 at atol 3e-5 (1e-4 relative as well for K14's
aggregates, which sum several messages, as tests/ops/test_fused_mlp.py:111);
bf16 at the golden tolerance 3e-2·std(reference) on the mean, the spread
and the RMS of the difference and 10× that elementwise, as
tests/test_torch_graph.py holds K6-K9 (the JAX twins add and apply swish in
bf16 and K13's twin sums its slots in bf16, so single elements differ by an
ulp of a value of 8 or more, past an absolute 3e-2).

JAX is imported inside the CPU tests only: the card's machine has no JAX
and runs the GPU tests of this file alone.

GPU (marker ``gpu``, skipped without a card): each kernel against its plain
version on the card in bf16 at shapes that take the ragged paths (N not a
multiple of 128 nor of K13's points a tile, Cout != L, deg 1 to 4, L up to
512, unsorted, shuffled and all-padding ``local``), its launches counted
(K12 one where Cout == L, else two; K13 one, K14 two), K12, K13 and K14
within 2 ulps of the two-launch chain, their TMA stores into 64 guard rows,
and the refusal of L > 512.  Tolerance, as for K6-K9: elementwise |kernel − plain| ≤
2e-2·std(plain) + 2 bf16 ulps of max|plain|.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import fused_mlp as FM
from skyrim_tpu_torch.ops import graph_kernels as GK


def _n(rng, *shape, s=1.0):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _t(tree, dtype=torch.float32, device="cpu"):
    if isinstance(tree, tuple):
        return tuple(_t(t, dtype, device) for t in tree)
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a).to(device, dtype)


def _j(tree, dtype=None):
    import jax.numpy as jnp

    if isinstance(tree, tuple):
        return tuple(_j(t, dtype) for t in tree)
    a = np.asarray(tree)
    return jnp.asarray(a, a.dtype if a.dtype.kind in "iu" else (dtype or jnp.float32))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_f32(out, ref, agg=False):
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-5, rtol=1e-4 if agg else 0)


def _close_bf16(out, ref, agg=False):
    out, ref = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    tol = 3e-2 * ref.std()
    d = out - ref
    assert abs(out.mean() - ref.mean()) < tol and abs(out.std() - ref.std()) < tol
    assert np.sqrt((d**2).mean()) < tol and np.abs(d).max() < 10 * tol, (np.abs(d).max(), tol)


def _dtypes():
    import jax.numpy as jnp

    return ((torch.float32, jnp.float32, _close_f32), (torch.bfloat16, jnp.bfloat16, _close_bf16))


def _finish_params(rng, L, Cout=None):
    Cout = Cout or L
    return _n(rng, L, s=0.1), (_n(rng, L, Cout, s=0.2), _n(rng, Cout, s=0.1)), (_n(rng, Cout), _n(rng, Cout))


# --- K12 ---------------------------------------------------------------------

FINISH_CASES = {"n516_l32": (516, 32, 32), "n300_l32_cout48": (300, 32, 48), "n7_l16_cout8": (7, 16, 8)}


def _finish_inputs(case, seed=0):
    N, L, Cout = FINISH_CASES[case]
    rng = np.random.default_rng(seed)
    return (_n(rng, N, L), *_finish_params(rng, L, Cout))


@pytest.mark.parametrize("case", sorted(FINISH_CASES))
def test_fused_finish_matches_jax(case):
    pytest.importorskip("jax")
    from skyrim_tpu.ops.fused_mlp import fused_finish as j_fused
    from skyrim_tpu.ops.fused_mlp import reference_finish as j_ref

    a = _finish_inputs(case)
    for dt, jdt, close in _dtypes():
        before = FM.fused_finish.launches
        out = FM.fused_finish(_t(a[0], dt), *_t(a[1:]))
        assert FM.fused_finish.launches == before  # the plain path launches nothing
        assert out.dtype == dt and tuple(out.shape) == (a[0].shape[0], a[2][0].shape[1])
        jin = (_j(a[0], jdt), *_j(a[1:]))
        close(out, j_fused(*jin, interpret=True))
        close(out, j_ref(*jin))


# --- K13 ---------------------------------------------------------------------

FIXED_CASES = {"n300_deg3": (300, 16, 3), "n70_deg2": (70, 16, 2), "n1030_deg1": (1030, 8, 1), "n50_deg4": (50, 8, 4)}


def _fixed_inputs(case, seed=0):
    N, L, deg = FIXED_CASES[case]
    rng = np.random.default_rng(seed)
    return (_n(rng, N, deg * L), _n(rng, N, deg * L, s=0.2), _n(rng, N, L, s=0.2), *_finish_params(rng, L), deg)


@pytest.mark.parametrize("case", sorted(FIXED_CASES))
def test_fused_fixed_degree_messages_matches_jax(case):
    pytest.importorskip("jax")
    from skyrim_tpu.ops.graph_kernels import fused_fixed_degree_messages as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_fixed_degree_messages as j_ref

    a = _fixed_inputs(case)
    for dt, jdt, close in _dtypes():
        out = GK.fused_fixed_degree_messages(*_t(a[:3], dt), *_t(a[3:6]), a[6])
        assert out.dtype == dt and tuple(out.shape) == a[2].shape
        jin = (*_j(a[:3], jdt), *_j(a[3:6]), a[6])
        close(out, j_fused(*jin, interpret=True))
        close(out, j_ref(*jin))


# --- K14 ---------------------------------------------------------------------

BLOCK_CASES = ("sorted", "unsorted", "shuffled", "one_block_all_padding", "sb_not_multiple_of_8")


def _block_inputs(case, B=4, M=64, SB=16, L=16, seed=12):
    """As tests/ops/test_fused_mlp.py:101: local ids in [0, SB], SB = padding;
    "shuffled": a sorted plan's ids permuted within each block."""
    rng = np.random.default_rng(seed)
    if case == "sb_not_multiple_of_8":
        SB = 13
    local = rng.integers(0, SB + 1, size=(B, M))
    if case != "unsorted":
        local = np.sort(local, axis=-1)
    if case == "shuffled":
        local = np.stack([row[rng.permutation(M)] for row in local])
    if case == "one_block_all_padding":
        local[1] = SB
    assert (local == SB).any()  # padding rows are on the path
    return (_n(rng, B, M, L), _n(rng, B, M, L, s=0.2), local.astype(np.int32), *_finish_params(rng, L), SB)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_fused_block_messages_matches_jax(case):
    pytest.importorskip("jax")
    from skyrim_tpu.ops.graph_kernels import fused_block_messages as j_fused
    from skyrim_tpu.ops.graph_kernels import reference_block_messages as j_ref

    a = _block_inputs(case)
    for dt, jdt, close in _dtypes():
        out = GK.fused_block_messages(*_t(a[:2], dt), _t(a[2]), *_t(a[3:6]), a[6])
        assert out.dtype == dt and tuple(out.shape) == (4, a[6], 16)
        if case == "one_block_all_padding":
            assert not out[1].any()
        jin = (*_j(a[:2], jdt), _j(a[2]), *_j(a[3:6]), a[6])
        close(out, j_fused(*jin, interpret=True), agg=True)
        close(out, j_ref(*jin), agg=True)


def test_block_messages_sum_what_fixed_degree_messages_sum():
    """K14 over blocks whose segment s holds the deg slots of row s is K13."""
    a = _fixed_inputs("n300_deg3")
    wide, bias_w, ad, b0, wb, ln, deg = a
    N, L = ad.shape
    src = (wide.reshape(N, deg, L) + ad[:, None]).reshape(1, N * deg, L)
    local = np.repeat(np.arange(N), deg).reshape(1, N * deg)
    out = GK.fused_block_messages(_t(src), _t(bias_w.reshape(1, N * deg, L)), _t(local), *_t((b0, wb, ln)), N)
    ref = GK.fused_fixed_degree_messages(*_t((wide, bias_w, ad, b0, wb, ln)), deg)
    np.testing.assert_allclose(out[0].numpy(), ref.numpy(), atol=3e-5, rtol=1e-4)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close_card(out, ref):
    out, ref = out.float(), ref.float()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max()
    assert ((out - ref).abs() <= tol).all(), (float((out - ref).abs().max()), float(tol))


# N, L, Cout: the one-launch path at L 64 and 512 with ragged N (not a
# multiple of the 64-row tile), the chain where Cout != L
GPU_FINISH_CASES = {"n1000_l64": (1000, 64, 64), "n777_l64_cout40": (777, 64, 40), "n130_l512_cout256": (130, 512, 256),
                    "n1000_l512": (1000, 512, 512), "n70_l512": (70, 512, 512)}  # fmt: skip
FINISH_LAUNCHES = {"rows_ln": 1, "gemm_ln_rows": 2}  # kernel launches a call on each path


def _finish_kernel_launches():
    """Launches of every kernel K12 may take, summed."""
    return FM.finish_rows_ln.launches + FM.finish_gemm.launches + sum(FM.ln_rows.launches_by_shape.values())


def test_finish_path_by_shape():
    """K12 takes one launch where Cout == L, L % 8 == 0 and L <= 512 (every
    GraphCast shape), the two-launch chain elsewhere; the card cases hold
    both paths, the one-launch path at L 512 with a ragged N."""
    assert FM.finish_path(512, 512) == FM.finish_path(64, 64) == "rows_ln"
    assert FM.finish_path(512, 256) == FM.finish_path(64, 40) == FM.finish_path(520, 520) == "gemm_ln_rows"
    paths = {case: FM.finish_path(L, Cout) for case, (_, L, Cout) in GPU_FINISH_CASES.items()}
    assert set(paths.values()) == set(FINISH_LAUNCHES)
    assert any(paths[c] == "rows_ln" and L == 512 and N % 64 for c, (N, L, _) in GPU_FINISH_CASES.items())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_FINISH_CASES))
def test_finish_kernel_matches_plain(cuda, case):
    N, L, Cout = GPU_FINISH_CASES[case]
    rng = np.random.default_rng(0)
    args = (_t(_n(rng, N, L), torch.bfloat16, cuda), *_t(_finish_params(rng, L, Cout), device=cuda))
    path = FM.finish_path(L, Cout)
    before, on_path, kernels = FM.fused_finish.launches, FM.fused_finish.launches_by_path.get(path, 0), _finish_kernel_launches()
    out = FM.fused_finish(*args)
    torch.cuda.synchronize()
    assert FM.fused_finish.launches == before + 1
    assert FM.fused_finish.launches_by_path[path] == on_path + 1
    assert _finish_kernel_launches() == kernels + FINISH_LAUNCHES[path]
    _close_card(out, FM.reference_finish(*args, torch.bfloat16))


GPU_FIXED_CASES = {"n1000_l64_deg3": (1000, 64, 3), "n333_l64_deg2": (333, 64, 2), "n129_l128_deg4": (129, 128, 4),
                   "n1000_l64_deg1": (1000, 64, 1), "n300_l512_deg3": (300, 512, 3)}


def test_rows_ln_tile_by_group():
    """K13's tile at deg 1 to 4: whole points of deg rows within 64 rows."""
    assert [GK.rows_ln_tile(g) for g in (1, 2, 3, 4)] == [(64, 64), (64, 32), (63, 21), (64, 16)]
    with pytest.raises(ValueError, match="1 to 4"):
        GK.rows_ln_tile(5)


def test_gpu_fixed_cases_end_in_partial_tiles():
    """Every card case of K13 ends in a partial tile and every deg is on the card."""
    assert {deg for _, _, deg in GPU_FIXED_CASES.values()} == {1, 2, 3, 4}
    assert all(N % GK.rows_ln_tile(deg)[1] for N, _, deg in GPU_FIXED_CASES.values())


def test_check_segment_sum_limits():
    """The segmented sum's one limit, taken by segment_sum and by K14's
    wrapper before its messages launch: S·512 + R·4 bytes of shared memory
    within a block's, and C even."""
    from skyrim_tpu_torch.ops import _build

    FM.check_segment_sum(328, 8192, 512)  # K14 at GraphCast's full width
    S = (_build.MAX_SMEM - 4 * 8192) // 512
    FM.check_segment_sum(S, 8192, 512)
    with pytest.raises(ValueError, match="fused_block_messages: S .* shared memory"):
        FM.check_segment_sum(S + 1, 8192, 512, "fused_block_messages")
    with pytest.raises(ValueError, match="must be even"):
        FM.check_segment_sum(8, 64, 63)


def _message_kernel_launches():
    """Launches of every kernel K13 and K14 may take, summed."""
    return (GK.fused_fixed_degree_messages.launches + GK.block_messages.launches + FM.segment_sum.launches
            + FM.finish_gemm.launches + sum(FM.ln_rows.launches_by_shape.values()))


def _fixed_card_args(cuda, N, L, deg, seed=1):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    return (_t(_n(rng, N, deg * L), bf, cuda), _t(_n(rng, N, deg * L, s=0.3), bf, cuda), _t(_n(rng, N, L, s=0.3), bf, cuda),
            *_t(_finish_params(rng, L), device=cuda), deg)  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_FIXED_CASES))
def test_fixed_degree_kernel_matches_plain(cuda, case):
    N, L, deg = GPU_FIXED_CASES[case]
    args = _fixed_card_args(cuda, N, L, deg)
    before, kernels = GK.fused_fixed_degree_messages.launches, _message_kernel_launches()
    out = GK.fused_fixed_degree_messages(*args)
    torch.cuda.synchronize()
    assert GK.fused_fixed_degree_messages.launches == before + 1
    assert _message_kernel_launches() == kernels + 1  # one launch, no chain
    _close_card(out, GK.reference_fixed_degree_messages(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_kernel_matches_plain(cuda, case):
    a = _block_inputs(case, B=6, M=250, SB=48, L=64)
    bf = torch.bfloat16
    args = (*_t(a[:2], bf, cuda), _t(a[2], device=cuda), *_t(a[3:6], device=cuda), a[6])
    before, kernels = GK.fused_block_messages.launches, _message_kernel_launches()
    msgs, sums = GK.block_messages.launches, FM.segment_sum.launches
    out = GK.fused_block_messages(*args)
    torch.cuda.synchronize()
    assert GK.fused_block_messages.launches == before + 1
    assert (GK.block_messages.launches, FM.segment_sum.launches) == (msgs + 1, sums + 1)
    assert _message_kernel_launches() == kernels + 2  # the messages, then the sum
    _close_card(out, GK.reference_block_messages(*args))
    if case == "one_block_all_padding":
        assert not out[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("L", [64, 512])
def test_messages_match_gemm_ln_chain(cuda, L):
    """K12's one launch, K14's messages and K13 at deg 1 against the
    two-launch chain on the same rows (the finish GEMM, rowgemm_kernel with
    its own swish prologue, then the LayerNorm rows kernel): K12 on the rows
    themselves, K13 and K14 with each source of the prologue given the rows
    in turn and the others zero ((x + 0) + b0 == x + b0 in f32), so the
    rounding points are the same and only the order of the LayerNorm's sums
    differs.  Within 2 bf16 ulps of the chain's value plus four f32 roundings
    (2^-22) of the LayerNorm's last terms |(y - mean)·rstd·scale| + |shift|:
    where those cancel, the f32 rounding of two LayerNorms can exceed a bf16
    ulp of the result.  The check's power: the LayerNorm of the product
    before its bf16 rounding must fail it."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    rng = np.random.default_rng(8)
    M = 1000  # not a multiple of the 64-row tile
    x = _t(_n(rng, M, L), torch.bfloat16, cuda)
    b0, (w, b), ln = _t(_finish_params(rng, L), device=cuda)
    wb = (w * (16 / L) ** 0.5, b)  # unit-variance products at any width
    scale, shift = (v.double() for v in ln)

    def layernorm(y):  # f64, and its last terms' magnitude
        mean, var = y.mean(1, keepdim=True), y.var(1, unbiased=False, keepdim=True)
        t = (y - mean) * torch.rsqrt(var + _EPS) * scale
        return t + shift, t.abs() + shift.abs()

    y = FM.finish_gemm(x, b0, wb)
    _, terms = layernorm(y.double())
    chain = FM.ln_rows(y, ln, out=y).double()
    tol = 2 * torch.exp2(torch.floor(torch.log2(chain.abs().clamp_min(2.0**-100))) - 7) + 2.0**-22 * terms

    def over(out):
        return float(((out.double() - chain).abs() / tol).max())

    z = torch.zeros_like(x)
    assert FM.finish_path(L, L) == "rows_ln"
    kernels = _finish_kernel_launches()
    outs = [FM.fused_finish(x, b0, wb, ln)]
    assert _finish_kernel_launches() == kernels + 1
    outs += [GK.block_messages(x, z, b0, wb, ln), GK.block_messages(z, x, b0, wb, ln)]
    outs += [GK.fused_fixed_degree_messages(*srcs, b0, wb, ln, 1) for srcs in ((x, z, z), (z, x, z), (z, z, x))]
    torch.cuda.synchronize()
    for out in outs:
        assert torch.isfinite(out.float()).all()
        assert over(out) <= 1, over(out)
    h = x.float() + b0
    h = (h * torch.sigmoid(h)).to(torch.bfloat16)
    unrounded, _ = layernorm(h.double() @ wb[0].to(torch.bfloat16).double() + b.double())
    assert over(unrounded) > 1, over(unrounded)


@pytest.mark.gpu
def test_message_kernels_guard_rows(cuda):
    """K12's one launch and K13's and K14's messages' TMA stores into outputs
    with 64 sentinel rows past the end (partial last tiles; K13 at deg 3 and
    1): the guard rows come back unchanged, the rows before them equal the
    wrappers' outputs."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    sentinel, st = 0x7FA5, torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(4)
    flib = FM._finish_lib()
    for N, L in ((1000, 64), (70, 512)):
        x = _t(_n(rng, N, L), torch.bfloat16, cuda)
        b0, (w, b), (scale, shift) = _t(_finish_params(rng, L), device=cuda)
        buf = torch.full((N + 64, L), sentinel, dtype=torch.int16, device=cuda)
        w16 = w.to(torch.bfloat16)
        err = flib.skt_finish_rows_ln(x.data_ptr(), b0.data_ptr(), w16.data_ptr(), b.data_ptr(), scale.data_ptr(),
                                      shift.data_ptr(), buf.data_ptr(), N, L, _EPS, st)  # fmt: skip
        assert err == 0
        out = FM.fused_finish(x, b0, (w, b), (scale, shift))
        torch.cuda.synchronize()
        assert (buf[N:] == sentinel).all()
        assert torch.equal(buf[:N].view(torch.bfloat16), out)
    lib = GK._messages_lib()
    for N, L, deg in ((1000, 64, 3), (1000, 64, 1)):
        wide, bias_w, ad, b0, (w, b), (scale, shift), _ = _fixed_card_args(cuda, N, L, deg, seed=3)
        buf = torch.full((N + 64, L), sentinel, dtype=torch.int16, device=cuda)
        w16 = w.to(torch.bfloat16)
        err = lib.skt_fixed_degree_messages(wide.data_ptr(), bias_w.data_ptr(), ad.data_ptr(), b0.data_ptr(),
                                            w16.data_ptr(), b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                            buf.data_ptr(), N, L, deg, _EPS, st)  # fmt: skip
        assert err == 0
        out = GK.fused_fixed_degree_messages(wide, bias_w, ad, b0, (w, b), (scale, shift), deg)
        torch.cuda.synchronize()
        assert (buf[N:] == sentinel).all()
        assert torch.equal(buf[:N].view(torch.bfloat16), out)
    a = _block_inputs("sorted", B=6, M=250, SB=48, L=64)
    src, bias = (_t(x, torch.bfloat16, cuda).view(-1, 64) for x in a[:2])
    b0, (w, b), (scale, shift) = _t(a[3:6], device=cuda)
    R, w16 = src.shape[0], w.to(torch.bfloat16)
    buf = torch.full((R + 64, 64), sentinel, dtype=torch.int16, device=cuda)
    err = lib.skt_block_messages(src.data_ptr(), bias.data_ptr(), b0.data_ptr(), w16.data_ptr(), b.data_ptr(),
                                 scale.data_ptr(), shift.data_ptr(), buf.data_ptr(), R, 64, _EPS, st)  # fmt: skip
    assert err == 0
    m = GK.block_messages(src, bias, b0, (w, b), (scale, shift))
    torch.cuda.synchronize()
    assert (buf[R:] == sentinel).all()
    assert torch.equal(buf[:R].view(torch.bfloat16), m)


@pytest.mark.gpu
def test_message_wrappers_raise_on_unsupported_cuda_input(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: f32 or
    non-contiguous rows are refused, never sent to the plain version."""
    rng = np.random.default_rng(2)
    b0, wb, ln = _t(_finish_params(rng, 64), device=cuda)
    x = torch.zeros(100, 64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        FM.fused_finish(x, b0, wb, ln)
    xb = torch.zeros(100, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        FM.fused_finish(xb[:, ::2], b0, wb, ln)
    with pytest.raises(ValueError, match="bfloat16"):
        GK.fused_fixed_degree_messages(torch.zeros(100, 192, device=cuda), xb[:, :192], xb[:, :64], b0, wb, ln, 3)
    with pytest.raises(ValueError, match="deg 1 to 4"):
        GK.fused_fixed_degree_messages(torch.zeros(10, 320, device=cuda, dtype=torch.bfloat16), x, x, b0, wb, ln, 5)
    src = torch.zeros(2, 50, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        GK.fused_block_messages(src, src, torch.zeros(2, 50, device=cuda, dtype=torch.long), b0, wb, ln, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        GK.fused_block_messages(src.float(), src, torch.zeros(2, 50, device=cuda, dtype=torch.int32), b0, wb, ln, 8)
    with pytest.raises(ValueError, match="shared memory"):
        GK.fused_block_messages(src, src, torch.zeros(2, 50, device=cuda, dtype=torch.int32), b0, wb, ln, 500)
    # rows wider than one block holds (512 columns)
    b0w, wbw, lnw = _t(_finish_params(rng, 520), device=cuda)
    wide = torch.zeros(10, 3 * 520, device=cuda, dtype=torch.bfloat16)
    adw = torch.zeros(10, 520, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="L <= 512"):
        GK.fused_fixed_degree_messages(wide, wide, adw, b0w, wbw, lnw, 3)
    srcw = torch.zeros(2, 50, 520, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="L <= 512"):
        GK.fused_block_messages(srcw, srcw, torch.zeros(2, 50, device=cuda, dtype=torch.int32), b0w, wbw, lnw, 8)

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
multiple of 128, Cout != L, deg 2 and 3, unsorted and all-padding
``local``).  Tolerance, as for K6-K9: elementwise |kernel − plain| ≤
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

BLOCK_CASES = ("sorted", "unsorted", "one_block_all_padding", "sb_not_multiple_of_8")


def _block_inputs(case, B=4, M=64, SB=16, L=16, seed=12):
    """As tests/ops/test_fused_mlp.py:101: local ids in [0, SB], SB = padding."""
    rng = np.random.default_rng(seed)
    if case == "sb_not_multiple_of_8":
        SB = 13
    local = rng.integers(0, SB + 1, size=(B, M))
    if case != "unsorted":
        local = np.sort(local, axis=-1)
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


GPU_FINISH_CASES = {"n1000_l64": (1000, 64, 64), "n777_l64_cout40": (777, 64, 40), "n130_l512_cout256": (130, 512, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_FINISH_CASES))
def test_finish_kernel_matches_plain(cuda, case):
    N, L, Cout = GPU_FINISH_CASES[case]
    rng = np.random.default_rng(0)
    args = (_t(_n(rng, N, L), torch.bfloat16, cuda), *_t(_finish_params(rng, L, Cout), device=cuda))
    before = FM.fused_finish.launches
    out = FM.fused_finish(*args)
    torch.cuda.synchronize()
    assert FM.fused_finish.launches == before + 1
    _close_card(out, FM.reference_finish(*args, torch.bfloat16))


GPU_FIXED_CASES = {"n1000_l64_deg3": (1000, 64, 3), "n333_l64_deg2": (333, 64, 2), "n129_l128_deg4": (129, 128, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_FIXED_CASES))
def test_fixed_degree_kernel_matches_plain(cuda, case):
    N, L, deg = GPU_FIXED_CASES[case]
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    args = (_t(_n(rng, N, deg * L), bf, cuda), _t(_n(rng, N, deg * L, s=0.3), bf, cuda), _t(_n(rng, N, L, s=0.3), bf, cuda),
            *_t(_finish_params(rng, L), device=cuda), deg)  # fmt: skip
    before = GK.fused_fixed_degree_messages.launches
    out = GK.fused_fixed_degree_messages(*args)
    torch.cuda.synchronize()
    assert GK.fused_fixed_degree_messages.launches == before + 1
    _close_card(out, GK.reference_fixed_degree_messages(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_kernel_matches_plain(cuda, case):
    a = _block_inputs(case, B=6, M=250, SB=48, L=64)
    bf = torch.bfloat16
    args = (*_t(a[:2], bf, cuda), _t(a[2], device=cuda), *_t(a[3:6], device=cuda), a[6])
    before = GK.fused_block_messages.launches
    out = GK.fused_block_messages(*args)
    torch.cuda.synchronize()
    assert GK.fused_block_messages.launches == before + 1
    _close_card(out, GK.reference_block_messages(*args))
    if case == "one_block_all_padding":
        assert not out[1].any()


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

"""K1–K4 of the port against the JAX package.

CPU: each plain PyTorch version matches the JAX Pallas kernel (run in
interpret mode, as tests/ops/test_fused_block.py runs it) and its XLA
``reference_*`` twin in f32 at atol 3e-5 (the tolerance of
tests/ops/test_fused_block.py:49).  The rolls are exact.

JAX is imported inside the CPU tests only: the card's machine has no
JAX, and runs the GPU tests of this file alone.

GPU (marker ``gpu``, skipped without a card): each hand-written kernel
against its plain version on the card in bf16.  Tolerance: the two
differ by bf16 rounding of intermediates (the residual stream above
all) and f32 summation order, so elementwise
|kernel − plain| ≤ 2e-2·std(plain) + 2 bf16 ulps of max|plain|
(2·2⁻⁸·max|plain|); the roll is exact.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import fused_block as FB
from skyrim_tpu_torch.ops import resample as RS
from skyrim_tpu_torch.ops import roll as RL
from skyrim_tpu_torch.ops.gemm import gemm, ln_gemm, plain_gemm, plain_ln_gemm
from skyrim_tpu_torch.ops.windows import shift_attention_mask, window_partition, window_reverse

WINDOW = (2, 6, 12)


def _block_inputs(shifted, Z=4, H=12, Wd=24, C=32, heads=4, valid=(3, 11, 24), seed=0):
    """Random block inputs (numpy, f32) with a non-trivial valid extent."""
    rng = np.random.default_rng(seed)
    wlen = int(np.prod(WINDOW))
    nz, nh = Z // WINDOW[0], H // WINDOW[1]
    hidden = 4 * C

    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    shift = (1, 3, 6) if shifted else (0, 0, 0)
    mask = shift_attention_mask((Z, H, Wd), WINDOW, shift, valid)
    return dict(
        x=n(Z, H, Wd, C),
        ln1=(1 + n(C, s=0.1), n(C, s=0.1)),
        qkv_wb=(n(C, 3 * C, s=C**-0.5), n(3 * C, s=0.1)),
        bias=n(nz * nh, heads, wlen, wlen, s=0.5),
        mask=mask,
        proj_wb=(n(C, C, s=C**-0.5), n(C, s=0.1)),
        ln2=(1 + n(C, s=0.1), n(C, s=0.1)),
        mlp_wb=(n(C, hidden, s=C**-0.5), n(hidden, s=0.1), n(hidden, C, s=hidden**-0.5), n(C, s=0.1)),
    )


def _to(tree, fn):
    if isinstance(tree, tuple):
        return tuple(_to(t, fn) for t in tree)
    return None if tree is None else fn(tree)


def _args(inp, fn):
    keys = ("x", "ln1", "qkv_wb", "bias", "mask", "proj_wb", "ln2", "mlp_wb")
    return [_to(inp[k], fn) for k in keys]


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_plain_matches_jax(shifted):
    import jax.numpy as jnp

    from skyrim_tpu.ops.fused_block import fused_swin_block_4d, reference_swin_block

    inp = _block_inputs(shifted)
    assert inp["mask"] is not None  # valid < padded extents: masked either way
    j_args = _args(inp, jnp.asarray)
    ref_kernel = np.asarray(fused_swin_block_4d(*j_args, WINDOW, 4, interpret=True))
    ref_twin = np.asarray(reference_swin_block(*j_args, WINDOW, 4))
    out = FB.fused_swin_block(*_args(inp, torch.from_numpy), WINDOW, 4).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=3e-5, rtol=0)
    np.testing.assert_allclose(out, ref_twin, atol=3e-5, rtol=0)


@pytest.mark.parametrize("shifts", [(1, 3, 6), (-1, -3, -6), (3, 8, 23), (0, 0, 5), (-5, 13, -30)])
def test_roll_plain_matches_jax(shifts):
    import jax.numpy as jnp

    from skyrim_tpu.ops.roll import roll3d as j_roll3d

    x = np.random.default_rng(0).normal(size=(4, 9, 24, 16)).astype(np.float32)
    ref = np.asarray(j_roll3d(jnp.asarray(x), shifts, interpret=True))
    out = RL.roll3d(torch.from_numpy(x), shifts).numpy()
    np.testing.assert_array_equal(out, ref)
    back = RL.shift_roll(RL.shift_roll(torch.from_numpy(x), shifts, True), shifts, False)
    np.testing.assert_array_equal(back.numpy(), x)


def test_resample_plain_matches_jax():
    import jax.numpy as jnp

    from skyrim_tpu.ops.resample import (
        fused_downsample as j_fused_downsample,
        fused_upsample as j_fused_upsample,
        reference_downsample as j_reference_downsample,
        reference_upsample as j_reference_upsample,
    )

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 14, 24, 16)).astype(np.float32)
    ln = (rng.normal(size=(64,)).astype(np.float32), rng.normal(size=(64,)).astype(np.float32))
    wb = ((rng.normal(size=(64, 32)) * 0.1).astype(np.float32), rng.normal(size=(32,)).astype(np.float32))
    jx, jln, jwb = jnp.asarray(x), _to(ln, jnp.asarray), _to(wb, jnp.asarray)
    out = RS.fused_downsample(torch.from_numpy(x), _to(ln, torch.from_numpy), _to(wb, torch.from_numpy))
    assert tuple(out.shape) == (3, 7, 12, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_fused_downsample(jx, jln, jwb, interpret=True)), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_reference_downsample(jx, jln, jwb)), atol=3e-5, rtol=0)

    xu = rng.normal(size=(3, 7, 12, 32)).astype(np.float32)
    wbu = ((rng.normal(size=(32, 64)) * 0.1).astype(np.float32), rng.normal(size=(64,)).astype(np.float32))
    lnu = (rng.normal(size=(16,)).astype(np.float32), rng.normal(size=(16,)).astype(np.float32))
    jxu, jwbu, jlnu = jnp.asarray(xu), _to(wbu, jnp.asarray), _to(lnu, jnp.asarray)
    out = RS.fused_upsample(torch.from_numpy(xu), _to(wbu, torch.from_numpy), _to(lnu, torch.from_numpy))
    assert tuple(out.shape) == (3, 14, 24, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_fused_upsample(jxu, jwbu, jlnu, interpret=True)), atol=3e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_reference_upsample(jxu, jwbu, jlnu)), atol=3e-5, rtol=0)


def test_gemm_cpu_takes_plain_version():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    before = gemm.launches
    np.testing.assert_allclose(gemm(a, w, b, gelu=True).numpy(), plain_gemm(a, w, b, gelu=True).numpy())
    assert gemm.launches == before  # plain path launches nothing


def _ln_gemm_inputs(M, K, N, seed=0):
    """Rows for the LayerNorm-prologue GEMM (numpy, f32): normal rows, rows
    whose mean lies 6 standard deviations from 0 (values on a 1/16 grid, so
    that every sum of x and x² is exact in f32 in any order, and the fast
    variance E[x²] − E[x]² cancels five of its bits the same way in both
    frameworks), and all-zero rows (the window padding); γ ≠ 1, β ≠ 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[1::5] = np.round(16 * (6 + rng.normal(size=x[1::5].shape))) / 16
    x[3::5] = 0
    ln = ((1 + 0.1 * rng.normal(size=K)).astype(np.float32), (0.1 * rng.normal(size=K)).astype(np.float32))
    w = (rng.normal(size=(K, N)) * K**-0.5).astype(np.float32)
    b = (0.1 * rng.normal(size=N)).astype(np.float32)
    return x, ln, w, b


@pytest.mark.parametrize("K", [192, 384])
@pytest.mark.parametrize("gelu", [False, True], ids=["bias", "gelu"])
def test_plain_ln_gemm_matches_jax(K, gelu):
    """plain_ln_gemm against the JAX kernel's own arithmetic for LN1 + qkv
    and LN2 + fc1 (skyrim_tpu/ops/fused_block.py: _layernorm_f32, the f32 dot,
    + bias, nn.gelu) at M 37, in f32 at atol 3e-5 (the tolerance of
    tests/ops/test_fused_block.py:49)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from skyrim_tpu.ops.fused_block import _layernorm_f32 as j_layernorm_f32

    M, N = 37, (4 if gelu else 3) * K
    x, ln, w, b = _ln_gemm_inputs(M, K, N)
    assert np.abs(x[1::5].mean(1)).min() > 5 and not x[3::5].any()
    h = j_layernorm_f32(jnp.asarray(x), jnp.asarray(ln[0])[None], jnp.asarray(ln[1])[None])
    ref = jax.lax.dot_general(h, jnp.asarray(w), (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    ref = ref + jnp.asarray(b)
    if gelu:
        ref = nn.gelu(ref)
    before = ln_gemm.launches
    out = ln_gemm(torch.from_numpy(x), _to(ln, torch.from_numpy), torch.from_numpy(w), torch.from_numpy(b), gelu=gelu)
    assert ln_gemm.launches == before  # the plain version on the CPU launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)
    plain = plain_ln_gemm(torch.from_numpy(x), _to(ln, torch.from_numpy), torch.from_numpy(w), torch.from_numpy(b), gelu=gelu)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


@pytest.mark.parametrize("C,path", [(16, "ln_gemm"), (192, "ln_gemm"), (384, "ln_gemm"), (512, "ln_gemm"),
                                    (520, "chain"), (1536, "chain")])  # fmt: skip
def test_block_path_by_width(C, path):
    """K1 runs five launches (LayerNorms in ln_gemm's prologue) where a row
    block fits the kernel's shared memory, the seven-launch chain above it."""
    assert FB.block_path(C) == path


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_bf16_close(out, ref):
    out, ref = out.float(), ref.float()
    tol = 2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max()
    err = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= tol).all()), f"max err {err.max().item():.4g} vs std {ref.std().item():.4g}"


def _cuda_args(inp, dev):
    args = _args(inp, lambda a: torch.from_numpy(a).to(dev))
    args[0] = args[0].to(torch.bfloat16)
    return args


# (M, K, N).  Beside the first four, the TMA kernel's tile walk: M 1, 127,
# 129; a tile count that gives each of 132 blocks three tiles, so one
# consumer has a tile fewer than the other; M large enough for every block to
# walk many tiles, at N 192 (64 x 192 tiles) and 512 (128 x 128)
GEMM_SHAPES = [(1000, 192, 576), (300, 16, 48), (257, 768, 192), (4096, 384, 1536),
               (1, 192, 192), (127, 384, 576), (129, 512, 512), (3 * 132 * 128 - 5, 128, 128),
               (40000, 192, 576), (40000, 512, 512)]  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
@pytest.mark.parametrize("epi", ["bias", "gelu", "residual"])
def test_gemm_kernel_matches_plain(cuda, M, K, N, epi):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=cuda, generator=g) * K**-0.5).to(torch.bfloat16)
    b = torch.randn(N, device=cuda, generator=g)
    r = torch.randn(M, N, device=cuda, generator=g).to(torch.bfloat16) if epi == "residual" else None
    out = gemm(a, w, b, gelu=epi == "gelu", residual=r)
    torch.cuda.synchronize()
    assert_bf16_close(out, plain_gemm(a, w, b, gelu=epi == "gelu", residual=r))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(40962, 384, 192), (40962, 512, 512)])
def test_gemm_tma_store_writes_only_its_tile(cuda, M, K, N):
    """skt_gemm_bf16 through the library into an output with 64 guard rows
    past a ragged M (residual epilogue): the guard rows come back with their
    bits, the M rows within the kernel tolerance."""
    import ctypes

    from skyrim_tpu_torch.ops import _build

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=cuda, generator=g) * K**-0.5).to(torch.bfloat16)
    b = torch.randn(N, device=cuda, generator=g)
    r = torch.randn(M, N, device=cuda, generator=g).to(torch.bfloat16)
    sentinel = 0x7FA5  # a bf16 NaN pattern no product writes
    buf = torch.full((M + 64, N), sentinel, device=cuda, dtype=torch.int16)
    lib = _build.load("gemm")
    fn = lib.skt_gemm_bf16
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    err = fn(a.data_ptr(), w.data_ptr(), b.data_ptr(), r.data_ptr(), buf.data_ptr(), M, N, K, 2,
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "skt_gemm_bf16")
    torch.cuda.synchronize()
    assert bool((buf[M:] == sentinel).all())
    assert_bf16_close(buf[:M].view(torch.bfloat16), plain_gemm(a, w, b, residual=r))


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,heads", [(32, 4), (16, 2), (192, 6)])
def test_swin_block_kernel_matches_plain(cuda, shifted, C, heads):
    args = _cuda_args(_block_inputs(shifted, C=C, heads=heads), cuda)
    before = FB.fused_swin_block.launches
    out = FB.fused_swin_block(*args, WINDOW, heads)
    torch.cuda.synchronize()
    assert FB.fused_swin_block.launches == before + 1
    assert_bf16_close(out, FB.reference_swin_block(*args, WINDOW, heads))


@pytest.mark.gpu
def test_window_attention_kernel_matches_plain(cuda):
    args = _cuda_args(_block_inputs(True, C=64, heads=2), cuda)
    Z, H, Wd, C = args[0].shape
    qkv = torch.randn(Z, H, Wd, 3 * C, device=cuda).to(torch.bfloat16)
    out = FB.window_attention(qkv, args[3], args[4], WINDOW, 2)
    ref = FB.reference_window_attention_qkv(
        window_partition(qkv, WINDOW), args[3], args[4], Wd // WINDOW[2], 2
    )
    torch.cuda.synchronize()
    assert_bf16_close(out, window_reverse(ref, WINDOW, (Z, H, Wd)))


@pytest.mark.gpu
@pytest.mark.parametrize("shifts", [(1, 3, 6), (-1, -3, -6), (3, 8, 23)])
def test_roll_kernel_exact(cuda, shifts):
    x = torch.randn(4, 9, 24, 16, device=cuda).to(torch.bfloat16)
    out = RL.roll3d(x, shifts)
    torch.cuda.synchronize()
    assert torch.equal(out, RL.plain_roll3d(x, shifts))


# (Z, H, W, C, N, pad): K3 takes x (Z, H, W, C), a view of a buffer of H + pad
# rows, to N; K4 takes an input of K3's output shape (Z, ceil(H / 2), W / 2,
# N), a view the same way, back to C.  Tiles are pixels along a line:
# W / 2 = 181 gives tiles of 61, 61 and 59, W / 2 = 66 two of 33.
RESAMPLE_CASES = [
    (3, 14, 24, 16, 32, 0),  # the small configuration's widths, one tile a line
    (8, 13, 24, 16, 32, 5),  # its stage shapes: 13 token rows in a buffer of 18
    (3, 14, 24, 192, 384, 0),  # Pangu's widths
    (2, 13, 362, 192, 384, 5),  # odd H in a window-padded buffer, W / 2 = 181
    (1, 8, 132, 192, 384, 4),  # W / 2 = 66
]


def _resample_inputs(Z, H, W, C, N, pad, offset, dev):
    """K3's and K4's inputs as views of buffers with `pad` rows more, offset
    so that a merged row's |mean| is about `offset` times its std, and
    their parameters (beta drawn at 0.3)."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    H2, W2 = -(-H // 2), W // 2
    x = (randn(Z, H + pad, W, C) + offset).to(torch.bfloat16)[:, :H]
    ln, wb = (1 + randn(4 * C, s=0.1), randn(4 * C, s=0.3)), (randn(4 * C, N, s=(4 * C) ** -0.5), randn(N, s=0.1))
    xu = (randn(Z, H2 + pad, W2, N) + offset).to(torch.bfloat16)[:, :H2]
    wbu, lnu = (randn(N, 4 * C, s=N**-0.5), randn(4 * C, s=0.1)), (1 + randn(C, s=0.1), randn(C, s=0.3))
    return (x, ln, wb), (xu, wbu, lnu)


@pytest.mark.gpu
@pytest.mark.parametrize("Z,H,W,C,N,pad", RESAMPLE_CASES)
@pytest.mark.parametrize("offset", [0.0, 4.0], ids=["centred", "mean 4 std"])
def test_resample_kernels_match_plain(cuda, Z, H, W, C, N, pad, offset):
    """K3 (odd H from the buffer's rows as zeros) and K4, each one launch on
    a strided view, against their plain versions."""
    (x, ln, wb), (xu, wbu, lnu) = _resample_inputs(Z, H, W, C, N, pad, offset, cuda)
    before = RS.fused_downsample.launches
    out = RS.fused_downsample(x, ln, wb, RS.prepare_downsample(ln, wb))
    torch.cuda.synchronize()
    assert RS.fused_downsample.launches == before + 1
    assert_bf16_close(out, RS.reference_downsample(RS.pad_even_h(x), ln, wb))
    before = RS.fused_upsample.launches
    out = RS.fused_upsample(xu, wbu, lnu, RS.prepare_upsample(wbu, lnu))
    torch.cuda.synchronize()
    assert RS.fused_upsample.launches == before + 1
    assert_bf16_close(out, RS.reference_upsample(xu, wbu, lnu))


@pytest.mark.gpu
@pytest.mark.parametrize("Z,H,W,C,N,pad", RESAMPLE_CASES[2:4])
def test_resample_kernels_write_only_their_rows(cuda, Z, H, W, C, N, pad):
    """skt_downsample_bf16 (stores from registers) and skt_upsample_bf16
    (TMA stores) through the library into outputs with 64 rows of a
    sentinel before and after: the guard rows keep their bits, and every
    output row is written, equal to the wrapper's output."""
    from skyrim_tpu_torch.ops import _build
    from skyrim_tpu_torch.ops.resample import _EPS, _lib

    (x, ln, wb), (xu, wbu, lnu) = _resample_inputs(Z, H, W, C, N, pad, 0.0, cuda)
    lib, stream = _lib(), torch.cuda.current_stream().cuda_stream
    sentinel = 0x7FA5  # a bf16 NaN pattern no kernel writes
    H2, W2 = -(-H // 2), W // 2
    for name, rows, width, launch, ref in (
        ("skt_downsample_bf16", Z * H2 * W2, N,
         lambda out, p=RS.prepare_downsample(ln, wb): lib.skt_downsample_bf16(
             x.data_ptr(), *x.stride()[:3], Z, H, W, C, *(t.data_ptr() for t in p), out, N, _EPS, stream),
         lambda: RS.fused_downsample(x, ln, wb)),
        ("skt_upsample_bf16", Z * 4 * H2 * W2, C,
         lambda out, p=RS.prepare_upsample(wbu, lnu): lib.skt_upsample_bf16(
             xu.data_ptr(), *xu.stride()[:3], Z, H2, W2, N, *(t.data_ptr() for t in p), out, C, _EPS, stream),
         lambda: RS.fused_upsample(xu, wbu, lnu)),
    ):  # fmt: skip
        buf = torch.full((rows + 128, width), sentinel, device=cuda, dtype=torch.int16)
        _build.check(lib, launch(buf[64:].data_ptr()), name)
        torch.cuda.synchronize()
        assert bool((buf[:64] == sentinel).all()) and bool((buf[64 + rows:] == sentinel).all()), name
        assert not bool((buf[64:64 + rows] == sentinel).any()), name
        assert torch.equal(buf[64:64 + rows].view(torch.bfloat16).reshape(-1), ref().reshape(-1)), name


@pytest.mark.gpu
def test_wrappers_raise_on_unsupported_cuda_input(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: an f32
    activation is refused, never sent to the plain version."""
    args = _cuda_args(_block_inputs(False), cuda)
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="bf16"):
        FB.fused_swin_block(*args, WINDOW, 4)
    a = torch.randn(8, 16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        gemm(a, a.new_zeros(16, 8), a.new_zeros(8))
    with pytest.raises(ValueError, match="bf16"):
        RS.fused_downsample(torch.randn(2, 4, 4, 16, device=cuda), (a, a), (a, a))


def _cuda_ln_gemm_inputs(M, K, N, dev, seed=0):
    x, ln, w, b = _ln_gemm_inputs(M, K, N, seed)
    return (torch.from_numpy(x).to(dev).to(torch.bfloat16), _to(ln, lambda a: torch.from_numpy(a).to(dev)),
            torch.from_numpy(w).to(dev).to(torch.bfloat16), torch.from_numpy(b).to(dev))  # fmt: skip


# (M, K, N): Pangu's two widths with qkv's and fc1's N at an M that is not a
# multiple of the row block (K <= 256 takes 128-row blocks and 64-wide tiles,
# wider rows 64-row blocks and 128-wide tiles); one row; a K that is not a
# multiple of the 64-wide slice and rows shorter than one (the small
# configurations' C 16); the widest K; an N that is not a multiple of the
# tile; a run of tiles long enough for every block to span several row blocks
LN_GEMM_SHAPES = [(1000, 192, 576), (1000, 192, 768), (1000, 384, 1152), (1000, 384, 1536), (1, 192, 576),
                  (130, 200, 96), (777, 16, 48), (777, 32, 128), (300, 512, 2048), (300, 384, 200),
                  (40000, 192, 576), (20000, 384, 1536)]  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", LN_GEMM_SHAPES)
@pytest.mark.parametrize("gelu", [False, True], ids=["bias", "gelu"])
def test_ln_gemm_kernel_matches_plain(cuda, M, K, N, gelu):
    x, ln, w, b = _cuda_ln_gemm_inputs(M, K, N, cuda)
    before = ln_gemm.launches
    out = ln_gemm(x, ln, w, b, gelu=gelu)
    torch.cuda.synchronize()
    assert ln_gemm.launches == before + 1
    assert_bf16_close(out, plain_ln_gemm(x, ln, w, b, gelu=gelu))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1000, 192, 576), (40962, 384, 1536), (777, 16, 48)])
def test_ln_gemm_tma_store_writes_only_its_rows(cuda, M, K, N):
    """skt_ln_gemm_bf16 through the library into an output with 64 guard rows
    past a ragged M: the guard rows come back with their bits, the M rows
    equal the wrapper's output."""
    from skyrim_tpu_torch.ops import _build
    from skyrim_tpu_torch.ops.gemm import _EPS, _lib

    x, ln, w, b = _cuda_ln_gemm_inputs(M, K, N, cuda)
    sentinel = 0x7FA5  # a bf16 NaN pattern no product writes
    buf = torch.full((M + 64, N), sentinel, device=cuda, dtype=torch.int16)
    lib = _lib()
    err = lib.skt_ln_gemm_bf16(x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), w.data_ptr(), b.data_ptr(),
                               buf.data_ptr(), M, N, K, 1, _EPS, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "skt_ln_gemm_bf16")
    torch.cuda.synchronize()
    assert bool((buf[M:] == sentinel).all())
    assert torch.equal(buf[:M].view(torch.bfloat16), ln_gemm(x, ln, w, b, gelu=True))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [192, 384])
def test_ln_gemm_check_refuses_faults(cuda, K):
    """The kernel passes the check; three outputs a faulty kernel would give
    (each row's statistics taken from the next row, the LayerNorm left out,
    β dropped) fail it."""
    M, N = 4096, 3 * K
    x, ln, w, b = _cuda_ln_gemm_inputs(M, K, N, cuda)
    ref = plain_ln_gemm(x, ln, w, b)
    assert_bf16_close(ln_gemm(x, ln, w, b), ref)
    xf = x.float()
    mu = torch.roll(xf.mean(-1, keepdim=True), -1, 0)
    var = torch.roll((xf * xf).mean(-1, keepdim=True), -1, 0) - mu * mu
    h_next = ((xf - mu) * torch.rsqrt(var.clamp_min(0) + 1e-6) * ln[0] + ln[1]).to(torch.bfloat16)
    faults = {
        "statistics of the next row": plain_gemm(h_next, w, b),
        "LayerNorm left out": plain_gemm(x, w, b),
        "beta dropped": plain_ln_gemm(x, (ln[0], torch.zeros_like(ln[1])), w, b),
    }
    for name, out in faults.items():
        with pytest.raises(AssertionError):
            assert_bf16_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,window,dims,path,launches", [
    (192, 6, (2, 6, 12), (4, 12, 24), "ln_gemm", 5),
    (384, 12, (2, 6, 12), (4, 12, 24), "ln_gemm", 5),
    (1536, 24, (1, 6, 12), (1, 12, 24), "chain", 7),
])  # fmt: skip
def test_swin_block_launches_by_path(cuda, C, heads, window, dims, path, launches):
    """fused_swin_block launches five kernels at Pangu's widths (no LayerNorm
    rows launch) and seven at FuXi's C 1536, by the kernels' counters, and
    agrees with its plain version on either path."""
    from skyrim_tpu_torch.ops.windows import shift_attention_mask

    g = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda, generator=g) * scale

    wlen, hidden = int(np.prod(window)), 4 * C
    nz, nh = dims[0] // window[0], dims[1] // window[1]
    mask = torch.from_numpy(shift_attention_mask(dims, window, tuple(w // 2 for w in window), dims)).to(cuda)
    args = [randn(*dims, C).to(torch.bfloat16), (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)), randn(nz * nh, heads, wlen, wlen, scale=0.02),
            mask, (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)), (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1), randn(hidden, C, scale=hidden**-0.5),
             randn(C, scale=0.1))]  # fmt: skip
    kernels = (ln_gemm, gemm, FB.layernorm, FB.window_attention)
    before = [k.launches for k in kernels]
    by_path = dict(FB.fused_swin_block.launches_by_path)
    out = FB.fused_swin_block(*args, window, heads)
    torch.cuda.synchronize()
    counts = [k.launches - n for k, n in zip(kernels, before)]
    assert sum(counts) == launches
    assert counts == ([2, 2, 0, 1] if path == "ln_gemm" else [0, 4, 2, 1])
    assert FB.fused_swin_block.launches_by_path[path] == by_path.get(path, 0) + 1
    assert_bf16_close(out, FB.reference_swin_block(*args, window, heads))

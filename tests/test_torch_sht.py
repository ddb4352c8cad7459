"""The port's spherical harmonic transform against the JAX package's.

The same numpy fields go through ``skyrim_tpu.ops.sht.SHT`` (JAX, f32,
the matmul longitude path) and ``skyrim_tpu_torch.ops.sht.SHT``, on both
grid types, including SFNO's geometry where mmax = lmax + 1 (an all-zero
last Legendre row).  Tolerance: max abs ≤ 1e-5·max|ref| (f32 sums of up
to nlat·nlon terms).  The quadrature and round-trip checks copy
tests/ops/test_sht.py on the port's functions.

JAX is imported inside the tests: the card's machine has no JAX and runs
only the ``gpu`` test of this file.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops.sht import SHT, clenshaw_curtis_weights, full_f32, get_sht, legendre_matrix

REL = 1e-5
# (grid, nlat, nlon, lmax, mmax): the golden SFNO test grids (49x96 in, 12x24
# Gauss inside), fcnv2_sm's mmax = lmax + 1, and an odd nlon
GEOMETRIES = [
    ("equiangular", 49, 96, 12, 13),
    ("legendre-gauss", 12, 24, 12, 13),
    ("equiangular", 33, 64, 16, 16),
    ("legendre-gauss", 20, 45, 18, 20),
]


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("grid,nlat,nlon,lmax,mmax", GEOMETRIES)
def test_forward_and_inverse_match_jax(grid, nlat, nlon, lmax, mmax):
    jnp = pytest.importorskip("jax.numpy")
    from skyrim_tpu.ops.sht import SHT as JSHT

    ref_sht, sht = JSHT(nlat, nlon, lmax, mmax, grid=grid), SHT(nlat, nlon, lmax, mmax, grid=grid)
    x = _field((2, 3, nlat, nlon))
    ref = np.asarray(ref_sht.forward(jnp.asarray(x)))
    out = sht.forward(torch.from_numpy(x))
    assert out.dtype == torch.complex64 and out.shape == ref.shape == (2, 3, lmax, mmax)
    assert np.abs(out.numpy() - ref).max() <= REL * np.abs(ref).max()

    alm = (_field((3, lmax, mmax), 1) + 1j * _field((3, lmax, mmax), 2)).astype(np.complex64)
    ref = np.asarray(ref_sht.inverse(jnp.asarray(alm)))
    out = sht.inverse(torch.from_numpy(alm))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (3, nlat, nlon)
    assert np.abs(out.numpy() - ref).max() <= REL * np.abs(ref).max()


def test_tables_equal_jax():
    """Quadrature and Legendre tables are numpy float64 copies: equal bit
    for bit; the row m = lmax of SFNO's geometry is all zeros."""
    pytest.importorskip("jax")
    from skyrim_tpu.ops import sht as jsht

    for n in (2, 12, 33, 721):
        np.testing.assert_array_equal(clenshaw_curtis_weights(n), jsht.clenshaw_curtis_weights(n))
    ct = np.cos(np.linspace(0, np.pi, 49))
    P = legendre_matrix(49, 12, 13, ct)
    np.testing.assert_array_equal(P, jsht.legendre_matrix(49, 12, 13, ct))
    assert not P[12].any() and P[11, 11].any()
    with pytest.raises(ValueError, match="need at least 2"):
        clenshaw_curtis_weights(1)


def test_clenshaw_curtis_exactness():
    """CC weights integrate low-degree polynomials exactly."""
    n = 33
    w = clenshaw_curtis_weights(n)
    x = np.cos(np.arange(n) * np.pi / (n - 1))
    np.testing.assert_allclose(w.sum(), 2.0, atol=1e-12)  # ∫1 dx
    np.testing.assert_allclose((w * x).sum(), 0.0, atol=1e-12)
    np.testing.assert_allclose((w * x**2).sum(), 2 / 3, atol=1e-10)
    np.testing.assert_allclose((w * x**6).sum(), 2 / 7, atol=1e-10)


def test_legendre_orthonormality():
    """∫ P̄_l^m P̄_l'^m dcosθ = δ_{ll'} / (2π)."""
    nlat, L, M = 129, 20, 20
    P = legendre_matrix(nlat, L, M, np.cos(np.linspace(0, np.pi, nlat)))
    w = clenshaw_curtis_weights(nlat)
    for m in (0, 1, 5):
        G = (P[m] * w) @ P[m].T
        expected = np.eye(L) / (2 * np.pi)
        expected[:m, :m] = 0  # l < m rows are zero
        np.testing.assert_allclose(G, expected, atol=1e-8)


@pytest.mark.parametrize("grid", ["equiangular", "legendre-gauss"])
def test_roundtrip_bandlimited(grid):
    """SHT∘ISHT is the identity on band-limited coefficients."""
    nlat, nlon, L = 65, 128, 32
    sht = SHT(nlat, nlon, lmax=L, mmax=L, grid=grid)
    rng = np.random.default_rng(0)
    alm = (rng.normal(size=(3, L, L)) + 1j * rng.normal(size=(3, L, L))).astype(np.complex64)
    li, mi = np.arange(L)[:, None], np.arange(L)[None, :]
    alm[:, li < mi] = 0  # no l < m modes
    alm[:, :, 0] = alm[:, :, 0].real  # a real field's m = 0 modes are real
    back = sht.forward(sht.inverse(torch.from_numpy(alm))).numpy()
    np.testing.assert_allclose(back, alm, atol=2e-4)


def test_roundtrip_grid_and_constant_field():
    """A smooth low-degree field survives SHT then ISHT; a constant field is
    pure (l, m) = (0, 0) with a_00 = c·sqrt(4π)."""
    nlat, nlon = 65, 128
    sht = SHT(nlat, nlon, lmax=nlat // 2, mmax=nlat // 2)
    lat = np.linspace(np.pi / 2, -np.pi / 2, nlat)
    lon = np.linspace(0, 2 * np.pi, nlon, endpoint=False)
    x = (np.cos(lat)[:, None] ** 2 * np.cos(2 * lon)[None, :] + np.sin(lat)[:, None]).astype(np.float32)[None]
    back = sht.inverse(sht.forward(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, atol=2e-3)
    alm = SHT(33, 64, lmax=16, mmax=16).forward(torch.ones(1, 33, 64)).numpy()
    np.testing.assert_allclose(alm[0, 0, 0].real, np.sqrt(4 * np.pi), rtol=1e-4)
    alm[0, 0, 0] = 0
    assert np.abs(alm).max() < 1e-3


def test_channel_last_pair_matches_forward():
    """``analysis``/``synthesis`` on (H, W, B), as SFNO calls them, give
    ``forward``/``inverse``'s numbers in the (M, L, 2B) layout."""
    sht = SHT(12, 24, 12, 13, grid="legendre-gauss")
    x = torch.from_numpy(_field((12, 24, 4), 3))
    z = sht.analysis(x)
    alm = sht.forward(x.permute(2, 0, 1))  # (B, L, M)
    assert z.shape == (13, 12, 8)
    torch.testing.assert_close(torch.complex(z[..., :4], z[..., 4:]), alm.permute(2, 1, 0), rtol=0, atol=0)
    torch.testing.assert_close(sht.synthesis(z), sht.inverse(alm).permute(1, 2, 0), rtol=0, atol=0)


def test_get_sht_caches_per_geometry_and_device():
    a = get_sht(12, 24, 12, 13, grid="legendre-gauss")
    assert get_sht(12, 24, 12, 13, grid="legendre-gauss", device="cpu") is a
    assert get_sht(12, 24, 12, 13) is not a
    with pytest.raises(ValueError, match="unknown SHT grid"):
        SHT(12, 24, grid="healpix")


def test_full_f32_restores_the_callers_precision():
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.gpu
def test_card_transforms_run_in_full_f32():
    """On the card with TF32 switched on for f32 matmuls, the transforms at
    fcnv2_sm's outer geometry (721x1440 equiangular, (120, 121) modes) stay
    within 1e-5·max of the float64 CPU computation: they take no TF32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = torch.get_float32_matmul_precision()
    x = torch.from_numpy(_field((721, 1440, 4)))
    try:
        torch.set_float32_matmul_precision("high")  # TF32 allowed outside the transform
        sht = SHT(721, 1440, 120, 121, device="cuda")
        z = sht.analysis(x.cuda()).cpu()
        y = sht.synthesis(z.cuda()).cpu()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    ref = SHT(721, 1440, 120, 121, dtype=torch.float64)
    z64, y64 = ref.analysis(x.double()), ref.synthesis(z.double())
    assert float((z.double() - z64).abs().max()) <= REL * float(z64.abs().max())
    assert float((y.double() - y64).abs().max()) <= REL * float(y64.abs().max())

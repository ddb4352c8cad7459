"""Spherical harmonic transform as batched Legendre products (port of
skyrim_tpu/ops/sht.py).

- longitude: the truncated real DFT as one product against the stacked
  cos/sin tables of the ``mmax`` kept modes (the JAX package's
  ``lon_mode="matmul"``; its ``"fft"`` cross-check path is not ported);
- latitude: the contraction with the orthonormal associated Legendre
  matrices, a product batched over m;
- quadrature: Clenshaw–Curtis on the pole-inclusive equiangular grid,
  Gauss–Legendre on the Gauss grid.

The tables are computed once in float64 numpy and held as f32 tensors on
the device, cached per (nlat, nlon, lmax, mmax, grid, device).  Every
product runs in full f32 (parity with torch-harmonics needs it): inside
``full_f32`` the card's f32 matmuls take no TF32 whatever the caller set.

The model-facing pair works channel-last: ``analysis`` maps (H, W, B)
to (M, L, 2B), real parts in the first B channels and imaginary parts in
the last B, and ``synthesis`` maps back, so no full-resolution transpose
is made; ``forward``/``inverse`` keep the JAX package's signatures.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch


def clenshaw_curtis_weights(n: int) -> np.ndarray:
    """Weights w_j for ∫_{-1}^{1} f(x) dx ≈ Σ w_j f(x_j), x_j = cos(jπ/(n−1)).

    Endpoint-inclusive (the lat grid includes both poles).
    """
    if n < 2:
        raise ValueError("need at least 2 nodes")
    N = n - 1
    theta = np.arange(n) * np.pi / N
    w = np.ones(n)
    ks = np.arange(1, N // 2 + 1)
    for j in range(n):
        terms = np.cos(2 * ks * theta[j]) / (4 * ks**2 - 1)
        # halve the last term when N is even (k = N/2)
        if N % 2 == 0:
            terms[-1] *= 0.5
        w[j] = (2.0 / N) * (1 - 2 * np.sum(terms))
    w[0] /= 2
    w[-1] /= 2
    return w


def legendre_matrix(nlat: int, lmax: int, mmax: int, costheta: np.ndarray) -> np.ndarray:
    """Orthonormal associated Legendre P̄_l^m at the given cosθ nodes.

    Returns (mmax, lmax, nlat) float64, zero for l < m (so a row m ≥ lmax
    is all zeros).  Normalised so that ∫ P̄ P̄ dcosθ = 1/(2π) · δ: the
    spherical-harmonic normalisation with the 2π longitude factor folded in.
    """
    x = np.asarray(costheta, dtype=np.float64)
    sx = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    P = np.zeros((mmax, lmax, nlat))
    # P̄_0^0 = sqrt(1/4π)
    pmm = np.full(nlat, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(mmax):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sx * pmm
        if m < lmax:
            P[m, m] = pmm
        if m + 1 < lmax:
            P[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[m, l] = a * (x * P[m, l - 1] - b * P[m, l - 2])
    return P


@contextlib.contextmanager
def full_f32():
    """f32 matmuls in full precision (no TF32) inside the block, the
    caller's setting restored after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


class SHT:
    """Spherical harmonic analysis/synthesis on a latitude-ring grid.

    ``grid``: "equiangular" (pole-inclusive θ = 0..π, Clenshaw–Curtis; the
    721-point 0.25° grid) or "legendre-gauss" (Gauss–Legendre nodes,
    north to south; SFNO's internal grid).  ``dtype``: of the tables and
    the products, f32 (float64 serves reference checks).
    """

    def __init__(self, nlat: int, nlon: int, lmax: int | None = None, mmax: int | None = None,
                 grid: str = "equiangular", device="cpu", dtype: torch.dtype = torch.float32):
        self.nlat, self.nlon = nlat, nlon
        self.lmax = lmax or nlat
        self.mmax = mmax or min(self.lmax, nlon // 2 + 1)
        self.grid = grid
        if grid == "equiangular":
            ct = np.cos(np.linspace(0, np.pi, nlat))
            w = clenshaw_curtis_weights(nlat)  # dcosθ quadrature
        elif grid == "legendre-gauss":
            x, w = np.polynomial.legendre.leggauss(nlat)
            ct, w = x[::-1].copy(), w[::-1].copy()
        else:
            raise ValueError(f"unknown SHT grid {grid!r}")
        P = legendre_matrix(nlat, self.lmax, self.mmax, ct)  # (M, L, H)

        # analysis carries the quadrature weights and the 2π/nlon longitude
        # integral; synthesis folds the Hermitian weights (2, except m = 0
        # and the Nyquist mode) into its tables
        theta = np.arange(nlon)[:, None] * np.arange(self.mmax)[None, :] * (2 * np.pi / nlon)  # (W, M)
        hw = np.full((self.mmax,), 2.0)
        hw[0] = 1.0
        if nlon % 2 == 0 and self.mmax - 1 == nlon // 2:
            hw[-1] = 1.0

        def table(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

        # each table rounded on its own, as the JAX package rounds its four
        self._lon_fwd = torch.cat([table(np.cos(theta).T), table(-np.sin(theta).T)])  # (2M, W)
        self._lon_inv = torch.cat([table(np.cos(theta) * hw), -table(np.sin(theta) * hw)], 1)  # (W, 2M)
        self._Pw = table(P * w[None, None, :] * (2 * np.pi / nlon))  # (M, L, H)
        self._Pt = table(P.transpose(0, 2, 1))  # (M, H, L)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """Real (H, W, B) → (M, L, 2B) f32: Re a_lm in [..., :B], Im in [..., B:]."""
        H, Wd, B = x.shape
        M = self.mmax
        with full_f32():
            F = torch.matmul(self._lon_fwd, x.to(self._Pw.dtype))  # (H, 2M, B)
            F = F.view(H, 2, M, B).permute(2, 0, 1, 3).reshape(M, H, 2 * B)
            return torch.bmm(self._Pw, F)

    def synthesis(self, z: torch.Tensor) -> torch.Tensor:
        """(M, L, 2B) f32 in ``analysis``'s layout → real (H, W, B) f32."""
        M, _, B2 = z.shape
        B = B2 // 2
        with full_f32():
            F = torch.bmm(self._Pt, z.to(self._Pt.dtype))  # (M, H, 2B)
            F = F.view(M, self.nlat, 2, B).permute(1, 2, 0, 3).reshape(self.nlat, 2 * M, B)
            return torch.matmul(self._lon_inv, F)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Analysis: real (..., H, W) → complex64 (..., L, M)."""
        lead = x.shape[:-2]
        xb = x.reshape(-1, self.nlat, self.nlon).permute(1, 2, 0)
        B = xb.shape[-1]
        z = self.analysis(xb)  # (M, L, 2B)
        alm = torch.complex(z[..., :B], z[..., B:]).permute(2, 1, 0)
        return alm.reshape(*lead, self.lmax, self.mmax)

    def inverse(self, alm: torch.Tensor) -> torch.Tensor:
        """Synthesis: complex (..., L, M) → real (..., H, W) f32."""
        lead = alm.shape[:-2]
        a = alm.reshape(-1, self.lmax, self.mmax).permute(2, 1, 0)  # (M, L, B)
        y = self.synthesis(torch.cat([a.real, a.imag], -1))  # (H, W, B)
        return y.permute(2, 0, 1).reshape(*lead, self.nlat, self.nlon)


@lru_cache(maxsize=16)
def _cached_sht(nlat, nlon, lmax, mmax, grid, device) -> SHT:
    return SHT(nlat, nlon, lmax, mmax, grid=grid, device=device)


def get_sht(nlat: int, nlon: int, lmax: int | None = None, mmax: int | None = None,
            grid: str = "equiangular", device="cpu") -> SHT:
    """The cached transform of this geometry, its tables on ``device``."""
    return _cached_sht(nlat, nlon, lmax, mmax, grid, torch.device(device))

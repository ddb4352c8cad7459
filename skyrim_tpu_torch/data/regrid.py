"""Lat-lon regridding + pressure-level interpolation for IC ingestion.

The reference re-interpolates IFS fields onto the ERA5 metadata grid
with extrapolation and fills missing pressure levels by interpolating
between available ones (reference skyrim/libs/ic/ifs.py:38-51,161-170
via ``xarray.interp``).  Here both are vectorized numpy: separable
bilinear weights over (lat, lon) with periodic longitude and linear
edge extrapolation in latitude, and linear-in-pressure level
interpolation with edge extrapolation — so 0.4° or reduced-level
sources land on the canonical 0.25° / 13-level contract
(SURVEY.md §1 data contract).

Pure host-side numpy by design: IC preparation happens once per
forecast on the host while the card runs the model.  The weights are
float64 and the output keeps the input's dtype (float32 for fetched
fields), as in the JAX package, so both give the same IC bits.

The port's copy of skyrim_tpu/data/regrid.py.
"""

from __future__ import annotations

import numpy as np


def _axis_weights(
    src: np.ndarray, dst: np.ndarray, periodic: float | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, w) such that out = src_vals[i0]·(1−w) + src_vals[i1]·w.

    ``src`` may be ascending or descending (lat grids run 90→−90).
    With ``periodic`` (the axis period, e.g. 360 for longitude) dst
    points beyond the last node wrap to the first; otherwise edge
    intervals extrapolate linearly (the reference's
    ``fill_value="extrapolate"``).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    flip = src.size > 1 and src[1] < src[0]
    s = src[::-1] if flip else src
    n = s.size

    if periodic is not None:
        d = np.mod(dst - s[0], periodic) + s[0]
        # nodes + wrapped first node close the circle
        idx = np.searchsorted(s, d, side="right") - 1
        idx = np.clip(idx, 0, n - 1)
        nxt = (idx + 1) % n
        span = np.where(
            idx < n - 1, s[(idx + 1) % n] - s[idx], periodic - (s[-1] - s[0])
        )
        w = (d - s[idx]) / np.where(span == 0, 1.0, span)
    else:
        idx = np.searchsorted(s, dst, side="right") - 1
        idx = np.clip(idx, 0, n - 2)  # edge cells extrapolate
        nxt = idx + 1
        span = s[nxt] - s[idx]
        w = (dst - s[idx]) / np.where(span == 0, 1.0, span)

    if flip:
        idx = n - 1 - idx
        nxt = n - 1 - nxt
    return idx.astype(np.int64), nxt.astype(np.int64), w


def regrid_latlon(
    values: np.ndarray,
    src_lat: np.ndarray,
    src_lon: np.ndarray,
    dst_lat: np.ndarray,
    dst_lon: np.ndarray,
) -> np.ndarray:
    """Bilinear regrid of (..., H, W) onto (dst_lat, dst_lon).

    Longitude is periodic (360°); latitude extrapolates linearly past
    the first/last ring (reference ic/ifs.py:161-170 semantics).
    """
    values = np.asarray(values)
    i0, i1, wy = _axis_weights(src_lat, dst_lat)
    j0, j1, wx = _axis_weights(src_lon, dst_lon, periodic=360.0)
    wy = wy.reshape(-1, 1)
    wx = wx.reshape(1, -1)
    v00 = values[..., i0[:, None], j0[None, :]]
    v01 = values[..., i0[:, None], j1[None, :]]
    v10 = values[..., i1[:, None], j0[None, :]]
    v11 = values[..., i1[:, None], j1[None, :]]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).astype(values.dtype, copy=False)


def interp_pressure_levels(
    values: np.ndarray,
    src_levels_hpa: np.ndarray,
    dst_levels_hpa: np.ndarray,
) -> np.ndarray:
    """Linear-in-pressure interpolation of (..., L, H, W) over levels.

    Matches the reference's ``interp(isobaricInhPa=level)`` (linear in
    hPa, reference ic/ifs.py:38-51); destination levels outside the
    source range extrapolate from the nearest interval.
    """
    values = np.asarray(values)
    i0, i1, w = _axis_weights(src_levels_hpa, dst_levels_hpa)
    v0 = np.take(values, i0, axis=-3)
    v1 = np.take(values, i1, axis=-3)
    w = w.reshape(-1, 1, 1)
    return (v0 * (1 - w) + v1 * w).astype(values.dtype, copy=False)


def to_canonical_grid(
    values: np.ndarray,
    src_lat: np.ndarray,
    src_lon: np.ndarray,
    dst_lat: np.ndarray | None = None,
    dst_lon: np.ndarray | None = None,
) -> np.ndarray:
    """Regrid (..., H, W) onto the canonical 721×1440 0.25° grid
    (no-op when the source already matches)."""
    if dst_lat is None:
        dst_lat = np.linspace(90.0, -90.0, 721)
    if dst_lon is None:
        dst_lon = np.arange(0.0, 360.0, 0.25)
    src_lat = np.asarray(src_lat, np.float64)
    src_lon = np.asarray(src_lon, np.float64)
    if (
        src_lat.size == np.size(dst_lat)
        and src_lon.size == np.size(dst_lon)
        and np.allclose(src_lat, dst_lat)
        and np.allclose(src_lon, dst_lon)
    ):
        return np.asarray(values)
    return regrid_latlon(values, src_lat, src_lon, dst_lat, dst_lon)

"""Top-of-atmosphere incident solar radiation (TISR) and clock forcings.

Port of ``toa_incident_solar_radiation_jax`` and ``clock_features_jax``
(skyrim_tpu/data/solar.py:75-145): GraphCast's time-dependent inputs,
computed from orbital geometry (Spencer's declination and eccentricity
series, solar hour angle) on the model's device.

Both take ``time_sec`` as a float32 tensor of epoch seconds and compute in
float32 throughout, as the JAX functions do: near 2024 float32 epoch
seconds are spaced 128 s apart, so the forcings depend on where the
caller rounds to float32 (``GraphCastModel._forcings`` does it where the
JAX model does).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SOLAR_CONSTANT = 1361.0  # W/m²


def _rad(deg: np.ndarray, device) -> torch.Tensor:
    return torch.deg2rad(torch.as_tensor(np.asarray(deg), dtype=torch.float32, device=device))


def toa_incident_solar_radiation(
    time_sec: torch.Tensor,
    lat_deg: np.ndarray,
    lon_deg: np.ndarray,
    integration_hours: float = 1.0,
) -> torch.Tensor:
    """TOA insolation (J/m²) accumulated over ``integration_hours`` ending at
    ``time_sec``, on the (lat, lon) grid: (nlat, nlon) float32.

    Day of year is (days since 1970-01-01) mod 365.25, as in the JAX
    version."""
    dev = time_sec.device
    lat = _rad(lat_deg, dev)[:, None]
    lon = _rad(lon_deg, dev)[None, :]
    days = time_sec.to(torch.float32) / 86400.0
    g = 2 * math.pi * torch.remainder(days, 365.25) / 365.25
    decl = (
        0.006918
        - 0.399912 * torch.cos(g) + 0.070257 * torch.sin(g)
        - 0.006758 * torch.cos(2 * g) + 0.000907 * torch.sin(2 * g)
        - 0.002697 * torch.cos(3 * g) + 0.00148 * torch.sin(3 * g)
    )  # fmt: skip
    e0 = (
        1.000110
        + 0.034221 * torch.cos(g) + 0.001280 * torch.sin(g)
        + 0.000719 * torch.cos(2 * g) + 0.000077 * torch.sin(2 * g)
    )  # fmt: skip
    n_sub = max(int(integration_hours * 4), 1)
    total = torch.zeros((lat.shape[0], lon.shape[1]), dtype=torch.float32, device=dev)
    for i in range(n_sub):
        ts = days - (integration_hours * (i + 0.5) / n_sub) / 24.0
        hour_angle = 2 * math.pi * torch.remainder(ts, 1.0) - math.pi + lon
        cosz = torch.sin(lat) * torch.sin(decl) + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle)
        total += cosz.clamp_min(0.0)
    mean_cosz = total / n_sub
    return SOLAR_CONSTANT * e0 * mean_cosz * integration_hours * 3600


def clock_features(time_sec: torch.Tensor, lat_deg: np.ndarray, lon_deg: np.ndarray) -> torch.Tensor:
    """(4, nlat, nlon) float32: sin/cos of local time of day and of the year's
    progress, from epoch seconds."""
    dev = time_sec.device
    lon = torch.as_tensor(np.asarray(lon_deg), dtype=torch.float32, device=dev)[None, :]
    ones = torch.ones((len(lat_deg), len(lon_deg)), dtype=torch.float32, device=dev)
    days = time_sec.to(torch.float32) / 86400.0
    local = torch.remainder(torch.remainder(days, 1.0) + lon / 360.0, 1.0)
    year = torch.remainder(days, 365.25) / 365.25
    return torch.stack(
        [
            torch.sin(2 * math.pi * local) * ones,
            torch.cos(2 * math.pi * local) * ones,
            torch.sin(2 * math.pi * year) * ones,
            torch.cos(2 * math.pi * year) * ones,
        ]
    )

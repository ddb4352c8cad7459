"""Prediction wrappers (port of skyrim_tpu/core/prediction.py).

``GlobalPrediction`` wraps a canonical Field (or a saved path) with
slicing, nearest-point access, and wind-speed helpers.
``GlobalPredictionRollout`` wraps a list of per-step snapshots.  Host
code, numpy only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.save import load_forecast


class GlobalPrediction:
    def __init__(self, source: Field | str | Path):
        if isinstance(source, (str, Path)):
            self.filepath = str(source)
            self.prediction = load_forecast(source)
        else:
            self.filepath = None
            self.prediction = source

    @property
    def coords(self) -> dict:
        return self.prediction.coords

    @property
    def channels(self) -> list[str]:
        return list(self.prediction.coords["channel"])

    @property
    def size(self):
        return self.prediction.sizes

    def slice(
        self,
        lat: slice | None = None,
        lon: slice | None = None,
        channel: str | list[str] | None = None,
        n_step: int | None = None,
    ) -> Field:
        """Select a subset."""
        out = self.prediction
        if n_step is not None:
            out = out.isel(time=n_step)
        if channel is not None:
            out = out.sel(channel=channel)
        if lat is not None:
            out = out.sel(lat=lat)
        if lon is not None:
            out = out.sel(lon=lon)
        return out

    def point(
        self,
        lat: float,
        lon: float,
        channel: str | None = None,
        n_step: int | None = None,
    ):
        """Nearest-neighbor point lookup."""
        out = self.prediction.sel(lat=lat, lon=lon, method="nearest")
        if channel is not None:
            out = out.sel(channel=channel)
        if n_step is not None:
            out = out.isel(time=n_step)
        return out

    def point_wind_uv(self, lat: float, lon: float, pressure_level: int | None = None):
        u_name = f"u{pressure_level}" if pressure_level else "u10m"
        v_name = f"v{pressure_level}" if pressure_level else "v10m"
        u = self.point(lat, lon, channel=u_name)
        v = self.point(lat, lon, channel=v_name)
        return u.data, v.data

    def wind_speed(self, lat: float, lon: float, pressure_level: int | None = None):
        """√(u²+v²) at a point."""
        u, v = self.point_wind_uv(lat, lon, pressure_level)
        return np.sqrt(u**2 + v**2)

    def surface_wind_speed(self, lat: float, lon: float):
        """10 m wind speed."""
        return self.wind_speed(lat, lon)


class GlobalPredictionRollout:
    """List-of-snapshots wrapper."""

    def __init__(self, rollout: list[Field | str | Path]):
        self.rollout = [GlobalPrediction(r) for r in rollout]

    @property
    def time_points(self) -> list[np.datetime64]:
        return [r.prediction.coords["time"][-1] for r in self.rollout]

    def wind_speed(self, lat: float, lon: float, pressure_level: int | None = None):
        return np.array(
            [
                np.atleast_1d(r.wind_speed(lat, lon, pressure_level))[-1]
                for r in self.rollout
            ]
        )

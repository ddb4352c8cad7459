"""Equiangular lat-lon grid (the port's copy of skyrim_tpu/grid.py:23-76).

The canonical contract grid is the 0.25° equiangular lat-lon grid,
lat 90 → −90 inclusive (721 points), lon 0 → 359.75 (1440 points).
FourCastNet v1 uses the same grid without the south-pole row (720 lats).
The cubed-sphere and icosahedral grids are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class LatLonGrid:
    """Equiangular lat-lon grid, latitude descending (north first)."""

    nlat: int = 721
    nlon: int = 1440
    include_south_pole: bool = True

    @cached_property
    def lat(self) -> np.ndarray:
        # 90 .. -90 inclusive for 721; FCN drops the last (south pole) row.
        full = np.linspace(90.0, -90.0, 721, dtype=np.float64)
        if self.nlat == 721:
            return full
        if self.nlat == 720:
            return full[:720]
        return np.linspace(90.0, -90.0, self.nlat, dtype=np.float64)

    @cached_property
    def lon(self) -> np.ndarray:
        return np.arange(self.nlon, dtype=np.float64) * (360.0 / self.nlon)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nlat, self.nlon)

    @property
    def resolution_deg(self) -> float:
        return 360.0 / self.nlon

    def nearest_index(self, lat: float, lon: float) -> tuple[int, int]:
        lon = lon % 360.0
        i = int(np.abs(self.lat - lat).argmin())
        j = int(np.abs(self.lon - lon).argmin())
        return i, j

    @cached_property
    def cell_area_weights(self) -> np.ndarray:
        """Normalized cos(lat) quadrature weights, shape (nlat,).

        Pole rows get half-cells; weights sum to 1.
        """
        lat_r = np.deg2rad(self.lat)
        d = np.deg2rad(self.resolution_deg)
        # cell edges clamped to the poles
        upper = np.clip(lat_r + d / 2, -np.pi / 2, np.pi / 2)
        lower = np.clip(lat_r - d / 2, -np.pi / 2, np.pi / 2)
        w = np.sin(upper) - np.sin(lower)
        return w / w.sum()


GRID_721x1440 = LatLonGrid(721, 1440)
GRID_720x1440 = LatLonGrid(720, 1440, include_south_pole=False)

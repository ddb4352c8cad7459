"""Initial-condition sources and dispatch (port of skyrim_tpu/data/ic.py).

``get_data_source(channel_names, ic_source)`` returns a source that
produces the canonical (time, channel, lat, lon) Field:

- ``gfs`` / ``ifs`` / ``ens`` / ``cds``: the operational fetchers
  (data/gfs.py, data/ifs.py, data/ens.py, data/cds.py: GRIB over an
  injectable transport, decoded on the host)
- ``file:<path>``: restart from a saved forecast (NetCDF or Zarr) or IC
- ``synthetic``: climatology-shaped random ICs for offline runs

``get_ic`` fetches an IC without a model.
"""

from __future__ import annotations

import abc
import datetime
import re
import zlib
from typing import Sequence

import numpy as np

from skyrim_tpu_torch.channels import parse_channel
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.grid import GRID_721x1440, LatLonGrid
from skyrim_tpu_torch.io.save import load_forecast
from skyrim_tpu_torch.utils.logging import logger


class ICSource(abc.ABC):
    """A provider of initial conditions on the canonical grid."""

    name: str = "abstract"

    def __init__(self, channel_names: Sequence[str], grid: LatLonGrid = GRID_721x1440):
        self.channel_names = list(channel_names)
        self.grid = grid

    @abc.abstractmethod
    def fetch(
        self,
        time: datetime.datetime,
        n_history: int = 1,
        time_step: datetime.timedelta = datetime.timedelta(hours=6),
    ) -> Field:
        """Return (n_history, C, H, W) Field ending at ``time``."""

    def __getitem__(self, time: datetime.datetime) -> Field:
        return self.fetch(time)


class FileSource(ICSource):
    """IC from a saved forecast file (restart support)."""

    name = "file"

    def __init__(self, channel_names, path: str, grid: LatLonGrid = GRID_721x1440):
        super().__init__(channel_names, grid)
        self.path = path

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        f = load_forecast(self.path)
        f = f.sel(channel=self.channel_names)
        n = min(n_history, f.sizes["time"])
        return f.isel(time=list(range(f.sizes["time"] - n, f.sizes["time"])))


#: rough climatological (mean, std) per variable code for synthetic ICs
_CLIMATOLOGY = {
    "z": (1.0e5, 1.2e5), "q": (3e-3, 4e-3), "t": (250.0, 30.0),
    "u": (5.0, 12.0), "v": (0.0, 8.0), "w": (0.0, 0.3), "r": (50.0, 30.0),
    "t2m": (285.0, 15.0), "u10m": (0.0, 6.0), "v10m": (0.0, 5.0),
    "u100m": (0.0, 7.0), "v100m": (0.0, 6.0), "msl": (1.013e5, 1.3e3),
    "sp": (9.8e4, 7e3), "tcwv": (25.0, 17.0), "tp": (1e-4, 5e-4),
    "tp06": (5e-4, 2e-3), "d2m": (280.0, 15.0),
}  # fmt: skip


def climatology_stats(channel_name: str) -> tuple[float, float]:
    """Rough climatological (mean, std) for one channel, level-adjusted."""
    if re.fullmatch(r"c\d+", channel_name):
        # reduced test configs use placeholder channel names (cNN)
        return 0.0, 1.0
    c = parse_channel(channel_name)
    mean, std = _CLIMATOLOGY.get(c.var, (0.0, 1.0))
    if c.level is not None:
        # scale aloft: geopotential grows, temperature falls
        frac = c.level / 1000.0
        if c.var == "z":
            mean = 1.0e5 * (1.05 - frac)
        elif c.var == "t":
            mean = 210.0 + 80.0 * frac
        elif c.var == "q":
            mean = 5e-3 * frac**2
    return mean, std


class SyntheticSource(ICSource):
    """Smooth random fields with per-variable climatological scales.

    Deterministic in (time, channel) across processes: the seed is a
    CRC32 of the pair, not Python's per-process salted ``hash``.
    """

    name = "synthetic"

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        H, W = self.grid.shape
        times = [time - (n_history - 1 - i) * time_step for i in range(n_history)]
        data = np.empty((n_history, len(self.channel_names), H, W), np.float32)
        lat = np.deg2rad(self.grid.lat)[:, None]
        lon = np.deg2rad(self.grid.lon)[None, :]
        for ti, t in enumerate(times):
            for ci, name in enumerate(self.channel_names):
                mean, std = climatology_stats(name)
                rng = np.random.default_rng(
                    zlib.crc32(f"{int(t.timestamp())}:{name}".encode())
                )
                k1, k2 = rng.uniform(1, 4, 2)
                p1, p2 = rng.uniform(0, 2 * np.pi, 2)
                fld = (
                    np.sin(k1 * lon + p1) * np.cos(lat) ** 2
                    + 0.5 * np.cos(k2 * lon + p2) * np.sin(2 * lat)
                )
                noise = rng.normal(0, 0.15, (H, W))
                data[ti, ci] = mean + std * (fld + noise)
        return Field.from_canonical(
            data, times, self.channel_names, self.grid.lat, self.grid.lon,
            attrs={"source": self.name},
        )


def get_data_source(
    channel_names: Sequence[str],
    initial_condition_source: str = "gfs",
    **kwargs,
) -> ICSource:
    src = initial_condition_source.lower()
    if src == "synthetic":
        return SyntheticSource(channel_names, **kwargs)
    if src == "file" or src.startswith("file:"):
        path = kwargs.pop("path", None) or initial_condition_source.partition(":")[2]
        if not path:
            raise ValueError("file source needs a path: ic_source='file:/path'")
        return FileSource(channel_names, path, **kwargs)
    if src == "gfs":
        from skyrim_tpu_torch.data.gfs import GFSSource

        return GFSSource(channel_names, **kwargs)
    if src == "ifs":
        from skyrim_tpu_torch.data.ifs import IFSSource

        return IFSSource(channel_names, **kwargs)
    if src == "ens":
        from skyrim_tpu_torch.data.ens import ENSSource

        return ENSSource(channel_names, **kwargs)
    if src == "cds":
        from skyrim_tpu_torch.data.cds import CDSSource

        return CDSSource(channel_names, **kwargs)
    raise ValueError(f"unknown IC source {initial_condition_source!r}")


def get_ic(
    channels: Sequence[str],
    start_time: datetime.datetime,
    ic_source: str = "ifs",
) -> Field:
    """Model-free IC fetch on the canonical grid."""
    source = get_data_source(channels, ic_source)
    logger.info("fetching IC %s @ %s", ic_source, start_time)
    return source.fetch(start_time)

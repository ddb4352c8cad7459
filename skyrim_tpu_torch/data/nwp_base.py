"""Shared machinery for NWP product fetchers (GFS/IFS/ENS).

The reference exposes NWP products through the same forecast/predict
surface as neural models so baselines are interchangeable downstream
(SURVEY.md §2.3).  This base provides: sha256-keyed local caching
(reference gfs.py:199-236), canonical Field assembly, availability
probing, the ``predict``/``forecast``/``snipe`` surfaces, and parallel
channel downloads.

One deliberate improvement: the reference needs a ProcessPool because
eccodes is not thread-safe (reference ens.py:271-273); our pure-Python
GRIB decoder is thread-safe, so downloads use threads (no pickling, no
fork cost).

The port's copy of skyrim_tpu/data/nwp_base.py.
"""

from __future__ import annotations

import abc
import datetime
import hashlib
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from skyrim_tpu_torch.data import schedules
from skyrim_tpu_torch.data.transport import http_get
from skyrim_tpu_torch.data.vocab import Vocabulary
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.grid import GRID_721x1440
from skyrim_tpu_torch.io.save import LOCAL_CACHE, SaveConfig, save_forecast
from skyrim_tpu_torch.utils.logging import logger


class NWPProduct(abc.ABC):
    """A forecast product: vocabulary + schedule + byte-range fetch plan."""

    product: str  # "gfs" | "ifs" | "ens"
    vocabulary: Vocabulary

    def __init__(
        self,
        channels: Sequence[str],
        transport: Callable = http_get,
        cache: bool = True,
        max_workers: int = 8,
    ):
        self.channels = list(channels)
        self.assure_channels_exist(self.channels)
        self.transport = transport
        self.cache_enabled = cache
        self.max_workers = max_workers

    def assure_channels_exist(self, channels):
        missing = [c for c in channels if c not in self.vocabulary]
        if missing:
            raise ValueError(
                f"channels not in {self.product.upper()} vocabulary: {missing}"
            )

    @classmethod
    def list_available_channels(cls) -> list[str]:
        return cls.vocabulary.channels

    # -- caching ------------------------------------------------------------

    @property
    def cache_dir(self) -> Path:
        d = Path(LOCAL_CACHE) / self.product
        d.mkdir(parents=True, exist_ok=True)
        return d

    def clear_cache(self):
        if self.cache_dir.exists():
            shutil.rmtree(self.cache_dir)
            logger.info("cleared %s cache", self.product)

    def _cached_fetch(self, key: str, fetch: Callable[[], bytes]) -> bytes:
        if not self.cache_enabled:
            return fetch()
        name = hashlib.sha256(key.encode()).hexdigest() + ".grib2"
        path = self.cache_dir / name
        if path.exists():
            return path.read_bytes()
        data = fetch()
        # a temporary name per thread, then an atomic replace: no partial
        # downloads in the cache, and two threads fetching one key (IFS
        # interpolating a missing level beside a channel of a level it
        # reads) both land, where a shared ".part" name loses one rename
        tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.part")
        tmp.write_bytes(data)
        os.replace(tmp, path)
        return data

    # -- product specifics ---------------------------------------------------

    @abc.abstractmethod
    def fetch_channel(
        self, channel: str, init: datetime.datetime, step: int
    ) -> np.ndarray:
        """One (H, W) field on the canonical grid (north-first, lon 0-360)."""

    def available(self, init: datetime.datetime) -> bool:
        """Probe whether the cycle exists upstream."""
        return True

    # -- assembly ------------------------------------------------------------

    def fetch_dataarray(
        self, init: datetime.datetime, steps: Sequence[int]
    ) -> Field:
        """(time, channel, lat, lon) Field for the requested steps
        (reference gfs.py:416-499 semantics)."""
        grid = GRID_721x1440
        H, W = grid.shape
        out = np.full((len(steps), len(self.channels), H, W), np.nan, np.float32)

        def work(args):
            si, ci = args
            try:
                out[si, ci] = self.fetch_channel(self.channels[ci], init, steps[si])
            except Exception as e:  # degrade per-channel like the reference
                logger.warning(
                    "%s fetch failed for %s step %s: %s",
                    self.product, self.channels[ci], steps[si], e,
                )

        jobs = [(si, ci) for si in range(len(steps)) for ci in range(len(self.channels))]
        if self.max_workers > 1:
            with ThreadPoolExecutor(self.max_workers) as pool:
                list(pool.map(work, jobs))
        else:
            for j in jobs:
                work(j)

        times = [init + datetime.timedelta(hours=int(s)) for s in steps]
        return Field.from_canonical(
            out, times, self.channels, grid.lat, grid.lon,
            attrs={"source": self.product, "init_time": init.isoformat()},
        )

    # -- user surface --------------------------------------------------------

    def forecast(
        self,
        start_time: datetime.datetime,
        lead_time: int = 24,
        time_step: int | None = 6,
    ) -> Field:
        steps = schedules.forecast_steps(
            self.product, start_time.hour, lead_time, time_step
        )
        return self.fetch_dataarray(start_time, steps)

    def predict(
        self,
        date: str,  # YYYYMMDD
        time: str = "0000",
        lead_time: int = 24,
        time_step: int | None = 6,
        save: bool = False,
        save_config: SaveConfig | dict | None = None,
    ):
        init = datetime.datetime(
            int(date[:4]), int(date[4:6]), int(date[6:8]), int(time[:2]), int(time[2:4])
        )
        field = self.forecast(init, lead_time, time_step)
        if save:
            if isinstance(save_config, dict):
                save_config = SaveConfig(**save_config)
            pred_time = init + datetime.timedelta(hours=lead_time)
            path = save_forecast(
                field, self.product, init, pred_time, self.product,
                save_config or SaveConfig(),
            )
            return field, path
        return field

    def snipe(
        self,
        target_date: str,
        target_time: str = "0000",
        max_hours_back: int = 24,
    ) -> dict[str, Field]:
        """Same valid time from multiple init cycles (reference
        gfs.py:342-387): returns {init_iso: Field}."""
        target = datetime.datetime(
            int(target_date[:4]), int(target_date[4:6]), int(target_date[6:8]),
            int(target_time[:2]), int(target_time[2:4]),
        )
        out = {}
        for init, lead in schedules.available_start_times(
            self.product, target, max_hours_back
        ):
            if not self.available(init):
                logger.warning("cycle %s unavailable; skipping", init)
                continue
            out[init.isoformat()] = self.fetch_dataarray(init, [lead])
        return out

"""Copernicus CDS / ERA5 reanalysis client + dataset factory.

Re-implements the reference's CDS layer (skyrim/libs/benchmark/cds.py):
97-channel ``dataset::variable::level`` vocabulary, per-channel GRIB
download + cache → canonical Field, request-body building grouped by
y/m/d/h (cds.py:327-356), ``forecast``/``benchmark`` hindcast surfaces
mirroring ``Skyrim.predict`` (cds.py:395-428), and the
``create_dataset`` batch generators that cut training sets into
per-slice files + metadata (cds.py:430-621) feeding the finetune API.

Without the cdsapi SDK, the client speaks the CDS REST
API directly through the injectable transport (requests are built and
cached identically, so everything except the live HTTP is hermetically
testable — the reference's own tests mock ``cdsapi.Client``,
tests/libs/benchmark/test_cds.py:32-38).

The port's copy of skyrim_tpu/data/cds.py.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import time as _time
from pathlib import Path
from typing import Sequence

import numpy as np

from skyrim_tpu_torch.data import grib
from skyrim_tpu_torch.data.ic import ICSource
from skyrim_tpu_torch.data.transport import http_get
from skyrim_tpu_torch.data.vocab import CDS_PRESSURE_DATASET, CDS_SINGLE_DATASET, CDS_VOCAB  # noqa: F401 (re-exported)
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.grid import GRID_721x1440
from skyrim_tpu_torch.io.save import LOCAL_CACHE
from skyrim_tpu_torch.io.netcdf import write_netcdf
from skyrim_tpu_torch.utils.logging import logger

CDS_URL = os.environ.get("CDSAPI_URL", "https://cds.climate.copernicus.eu/api")


def build_request(
    channel: str, times: Sequence[datetime.datetime]
) -> tuple[str, dict]:
    """(dataset, request-body) for one channel over a set of timestamps
    (grouping semantics of reference cds.py:327-356)."""
    entry = CDS_VOCAB[channel]
    body = {
        "product_type": "reanalysis",
        "variable": entry.provider_id,
        "year": sorted({f"{t.year:04d}" for t in times}),
        "month": sorted({f"{t.month:02d}" for t in times}),
        "day": sorted({f"{t.day:02d}" for t in times}),
        "time": sorted({f"{t.hour:02d}:00" for t in times}),
        "format": "grib",
    }
    if entry.levtype == CDS_PRESSURE_DATASET:
        body["pressure_level"] = entry.level
    return entry.levtype, body


class CDS:
    """Minimal CDS client with sha256-keyed GRIB cache."""

    def __init__(self, channels: Sequence[str], transport=None, cache: bool = True):
        missing = [c for c in channels if c not in CDS_VOCAB]
        if missing:
            raise ValueError(f"channels not in CDS vocabulary: {missing}")
        self.channels = list(channels)
        self.transport = transport or self._live_retrieve
        self.cache_enabled = cache

    # -- live API (gated on credentials/network) ----------------------------

    def _live_retrieve(self, dataset: str, body: dict) -> bytes:
        key = os.environ.get("CDSAPI_KEY")
        if not key:
            raise RuntimeError(
                "CDSAPI_KEY not set — live CDS retrieval needs credentials "
                "(see .env.example in the reference)"
            )
        import urllib.request

        req = urllib.request.Request(
            f"{CDS_URL}/retrieve/v1/processes/{dataset}/execute",
            data=json.dumps({"inputs": body}).encode(),
            headers={"PRIVATE-TOKEN": key, "Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            job = json.loads(resp.read())
        status_url = f"{CDS_URL}/retrieve/v1/jobs/{job['jobID']}"
        while True:
            with urllib.request.urlopen(
                urllib.request.Request(status_url, headers={"PRIVATE-TOKEN": key})
            ) as resp:
                st = json.loads(resp.read())
            if st["status"] == "successful":
                break
            if st["status"] in ("failed", "dismissed"):
                raise RuntimeError(f"CDS job failed: {st}")
            _time.sleep(2)
        with urllib.request.urlopen(
            urllib.request.Request(
                f"{status_url}/results", headers={"PRIVATE-TOKEN": key}
            )
        ) as resp:
            results = json.loads(resp.read())
        href = results["asset"]["value"]["href"]
        return http_get(href)

    # -- fetch ----------------------------------------------------------------

    @property
    def cache_dir(self) -> Path:
        d = Path(LOCAL_CACHE) / "cds"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _fetch_channel(self, channel: str, times) -> bytes:
        dataset, body = build_request(channel, times)
        key = hashlib.sha256(
            json.dumps([dataset, body], sort_keys=True).encode()
        ).hexdigest()
        path = self.cache_dir / f"{key}.grib"
        if self.cache_enabled and path.exists():
            return path.read_bytes()
        data = self.transport(dataset, body)
        if self.cache_enabled:
            path.write_bytes(data)
        return data

    def fetch_dataarray(self, times: Sequence[datetime.datetime]) -> Field:
        """(time, channel, lat, lon) reanalysis snapshot set
        (reference cds.py:226-325)."""
        grid = GRID_721x1440
        H, W = grid.shape
        out = np.full((len(times), len(self.channels), H, W), np.nan, np.float32)
        for ci, ch in enumerate(self.channels):
            raw = self._fetch_channel(ch, tuple(times))
            msgs = grib.decode_all(raw)
            if len(msgs) < len(times):
                logger.warning(
                    "CDS returned %d messages for %d times (%s)",
                    len(msgs), len(times), ch,
                )
            for ti in range(min(len(times), len(msgs))):
                out[ti, ci] = msgs[ti].values
        return Field.from_canonical(
            out, list(times), self.channels, grid.lat, grid.lon,
            attrs={"source": "cds"},
        )

    # -- user surface ---------------------------------------------------------

    def forecast(
        self,
        start_time: datetime.datetime,
        n_steps: int = 4,
        time_step: datetime.timedelta = datetime.timedelta(hours=6),
    ) -> Field:
        """'Hindcast' of reanalysis timestamps (reference cds.py:395-410)."""
        times = [start_time + i * time_step for i in range(n_steps + 1)]
        return self.fetch_dataarray(times)

    def benchmark(
        self,
        date: str,
        time: str = "0000",
        lead_time: int = 24,
        time_step: int = 6,
    ) -> Field:
        """Truth series mirroring Skyrim.predict's interface
        (reference cds.py:412-428)."""
        start = datetime.datetime(
            int(date[:4]), int(date[4:6]), int(date[6:8]), int(time[:2]), int(time[2:4])
        )
        n_steps = lead_time // time_step
        return self.forecast(start, n_steps, datetime.timedelta(hours=time_step))

    # -- dataset factory (training sets for finetune/) ------------------------

    def create_dataset_from_timestamps(
        self,
        times: Sequence[datetime.datetime],
        output_dir: str,
        slice_size: int = 4,
    ) -> dict:
        """Cut ``times`` into per-slice NetCDFs + metadata.json
        (reference cds.py:430-621)."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        slices = [
            list(times[i : i + slice_size]) for i in range(0, len(times), slice_size)
        ]
        files = []
        for i, chunk in enumerate(slices):
            field = self.fetch_dataarray(chunk)
            path = out / f"slice_{i:05d}.nc"
            write_netcdf(field, path)
            files.append(path.name)
        meta = {
            "channels": self.channels,
            "n_slices": len(slices),
            "slice_size": slice_size,
            "times": [t.isoformat() for t in times],
            "files": files,
        }
        (out / "metadata.json").write_text(json.dumps(meta, indent=2))
        logger.success("dataset: %d slices → %s", len(slices), out)
        return meta

    def create_dataset(
        self,
        start: datetime.datetime,
        end: datetime.datetime,
        output_dir: str,
        time_step: datetime.timedelta = datetime.timedelta(hours=6),
        slice_size: int = 4,
    ) -> dict:
        times = []
        t = start
        while t <= end:
            times.append(t)
            t += time_step
        return self.create_dataset_from_timestamps(times, output_dir, slice_size)


class CDSSource(ICSource):
    """ERA5 reanalysis as IC (reference ic path for -ic cds)."""

    name = "cds"

    def __init__(self, channel_names, grid=None, **kwargs):
        super().__init__(channel_names)
        self.client = CDS(channel_names, **kwargs)

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        times = [time - (n_history - 1 - i) * time_step for i in range(n_history)]
        return self.client.fetch_dataarray(times)

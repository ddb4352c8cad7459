"""NOAA GFS fetcher — byte-range GRIB over public HTTPS.

Re-implements the reference's GFS client (skyrim/libs/nwp/gfs.py):
``.idx`` sidecar parsing → single-message byte-range reads from
``noaa-gfs-bdp-pds`` (via its anonymous HTTPS endpoint, without
boto3/s3fs), per-channel assembly into the canonical Field,
availability probe, cache.

The port's copy of skyrim_tpu/data/gfs.py; its live CLI
``main()`` is not ported.
"""

from __future__ import annotations

import datetime

import numpy as np

from skyrim_tpu_torch.data import grib
from skyrim_tpu_torch.data.regrid import to_canonical_grid
from skyrim_tpu_torch.data.ic import ICSource
from skyrim_tpu_torch.data.idx import MAX_BYTE_SIZE, lookup, parse_idx
from skyrim_tpu_torch.data.nwp_base import NWPProduct
from skyrim_tpu_torch.data.transport import http_exists
from skyrim_tpu_torch.data.vocab import GFS_VOCAB
from skyrim_tpu_torch.field import Field

BUCKET_URL = "https://noaa-gfs-bdp-pds.s3.amazonaws.com"


def gfs_key(init: datetime.datetime, step: int) -> str:
    """Object key (reference gfs.py key convention)."""
    return (
        f"gfs.{init:%Y%m%d}/{init:%H}/atmos/gfs.t{init:%H}z.pgrb2.0p25.f{step:03d}"
    )


class GFSModel(NWPProduct):
    product = "gfs"
    vocabulary = GFS_VOCAB

    def __init__(self, channels, **kwargs):
        super().__init__(channels, **kwargs)
        self._index_cache: dict[str, dict] = {}

    def _index(self, init: datetime.datetime, step: int) -> dict:
        key = gfs_key(init, step)
        if key not in self._index_cache:
            text = self.transport(f"{BUCKET_URL}/{key}.idx").decode()
            self._index_cache[key] = parse_idx(text)
        return self._index_cache[key]

    def fetch_channel(self, channel: str, init: datetime.datetime, step: int) -> np.ndarray:
        entry = self.vocabulary[channel]
        index = self._index(init, step)
        e = lookup(index, entry.provider_id, entry.levtype)
        url = f"{BUCKET_URL}/{gfs_key(init, step)}"
        raw = self._cached_fetch(
            f"{url}#{e.offset}",
            lambda: self.transport(url, offset=e.offset,
                                   length=e.length or MAX_BYTE_SIZE),
        )
        msg = grib.decode_message(raw)
        vals = to_canonical_grid(msg.values.astype(np.float32), msg.lat, msg.lon)
        return entry.modifier(vals)

    def available(self, init: datetime.datetime) -> bool:
        return http_exists(f"{BUCKET_URL}/{gfs_key(init, 0)}.idx")


class GFSSource(ICSource):
    """earth2mip-style DataSource adapter: GFS analysis (f000) as IC."""

    name = "gfs"

    def __init__(self, channel_names, grid=None, **kwargs):
        super().__init__(channel_names)
        self.client = GFSModel(channel_names, **kwargs)

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        fields = []
        for i in range(n_history):
            t = time - (n_history - 1 - i) * time_step
            init = t.replace(hour=(t.hour // 6) * 6, minute=0, second=0, microsecond=0)
            step = int((t - init).total_seconds() // 3600)
            fields.append(self.client.fetch_dataarray(init, [step]))
        return Field.concat(fields, "time")

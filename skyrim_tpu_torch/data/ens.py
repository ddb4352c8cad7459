"""ECMWF ENS (51-member ensemble) open-data fetcher.

Re-implements the reference's ENS client (skyrim/libs/nwp/ens.py):
1 control (``cf``) + 50 perturbed (``pf``) members on the ``enfo``
stream, reduced 9-level vocabulary, member axis prepended to the
canonical contract → (number, time, channel, lat, lon)
(reference ens.py:305-361).

The port's copy of skyrim_tpu/data/ens.py; its live CLI
``main()`` is not ported.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np

from skyrim_tpu_torch.data.ic import ICSource
from skyrim_tpu_torch.data.ifs import _ECMWFProduct
from skyrim_tpu_torch.data.vocab import ENS_VOCAB
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.grid import GRID_721x1440
from skyrim_tpu_torch.utils.logging import logger

N_MEMBERS = 51  # 1 cf + 50 pf (reference ens.py:122-128)


class ENSModel(_ECMWFProduct):
    product = "ens"
    vocabulary = ENS_VOCAB
    stream_kind = "ef"

    def __init__(self, channels, members: Sequence[int] | None = None, **kwargs):
        super().__init__(channels, **kwargs)
        self.members = list(members) if members is not None else list(range(N_MEMBERS))

    def _key(self, init: datetime.datetime, step: int) -> str:
        return (
            f"{init:%Y%m%d}/{init:%H}z/ifs/0p25/enfo/"
            f"{init:%Y%m%d%H%M%S}-{step}h-enfo-ef.grib2"
        )

    def fetch_channel(self, channel, init, step):
        # control member for the plain product surface
        return self._fetch_message(channel, init, step, number=None)

    def fetch_members(
        self, init: datetime.datetime, steps: Sequence[int]
    ) -> Field:
        """(number, time, channel, lat, lon) for all requested members."""
        grid = GRID_721x1440
        fields = []
        for m in self.members:
            try:
                member = self._fetch_member(init, steps, m)
            except Exception as e:  # drop failing members (reference ens.py:291-296)
                logger.warning("ENS member %d failed: %s", m, e)
                continue
            fields.append(member)
        # leading ensemble dim named "number" (reference ens.py:361)
        return Field.concat(fields, "number")

    def _fetch_member(self, init, steps, number: int) -> Field:
        grid = GRID_721x1440
        H, W = grid.shape
        out = np.full((len(steps), len(self.channels), H, W), np.nan, np.float32)
        for si, step in enumerate(steps):
            for ci, ch in enumerate(self.channels):
                # member 0 = control (cf) carries no number in the index
                num = None if number == 0 else number
                out[si, ci] = self._fetch_message(ch, init, step, number=num)
        times = [init + datetime.timedelta(hours=int(s)) for s in steps]
        return Field.from_canonical(
            out, times, self.channels, grid.lat, grid.lon,
            attrs={"source": "ens", "member": number},
        )


class ENSSource(ICSource):
    """Control-member analysis as IC."""

    name = "ens"

    def __init__(self, channel_names, grid=None, **kwargs):
        super().__init__(channel_names)
        self.client = ENSModel(channel_names, **kwargs)

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        fields = []
        for i in range(n_history):
            t = time - (n_history - 1 - i) * time_step
            init = t.replace(hour=(t.hour // 6) * 6, minute=0, second=0, microsecond=0)
            step = int((t - init).total_seconds() // 3600)
            fields.append(self.client.fetch_dataarray(init, [step]))
        return Field.concat(fields, "time")

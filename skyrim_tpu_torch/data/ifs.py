"""ECMWF IFS HRES open-data fetcher.

Re-implements the reference's IFS client (skyrim/libs/nwp/ifs.py) using
the open-data bucket's HTTPS endpoint and its JSON-lines ``.index``
sidecars for byte-range access (the reference used the
``ecmwf.opendata`` client; same data path, no SDK needed).  Key naming
covers the post-2024-02 layout including the ``scda`` cycle for 06/18z
(reference skyrim/libs/nwp/README.md, ic/ifs.py:21-35).

The port's copy of skyrim_tpu/data/ifs.py; its live CLI
``main()`` is not ported.
"""

from __future__ import annotations

import datetime

import numpy as np

from skyrim_tpu_torch.data import grib
from skyrim_tpu_torch.data.regrid import to_canonical_grid
from skyrim_tpu_torch.data.ic import ICSource
from skyrim_tpu_torch.data.idx import ecmwf_lookup, parse_ecmwf_index
from skyrim_tpu_torch.data.nwp_base import NWPProduct
from skyrim_tpu_torch.utils.logging import logger
from skyrim_tpu_torch.data.transport import http_exists
from skyrim_tpu_torch.data.vocab import IFS_VOCAB
from skyrim_tpu_torch.field import Field

BUCKET_URL = "https://ecmwf-forecasts.s3.eu-central-1.amazonaws.com"

#: first date with 0.25° open data (reference ic/ifs.py:111-112)
MIN_DATE_0P25 = datetime.datetime(2024, 3, 6)


def ifs_stream(init_hour: int) -> str:
    """00/12z → 'oper'; 06/18z → 'scda' (reference ic/ifs.py:26-30)."""
    return "oper" if init_hour in (0, 12) else "scda"


def ifs_key(init: datetime.datetime, step: int, stream: str | None = None,
            kind: str = "fc") -> str:
    stream = stream or ifs_stream(init.hour)
    return (
        f"{init:%Y%m%d}/{init:%H}z/ifs/0p25/{stream}/"
        f"{init:%Y%m%d%H%M%S}-{step}h-{stream}-{kind}.grib2"
    )


class _ECMWFProduct(NWPProduct):
    """Shared IFS/ENS fetch plan over ECMWF .index sidecars."""

    stream_kind = "fc"

    def __init__(self, channels, **kwargs):
        super().__init__(channels, **kwargs)
        self._index_cache: dict[str, list] = {}

    def _key(self, init: datetime.datetime, step: int) -> str:
        return ifs_key(init, step, kind=self.stream_kind)

    def _index(self, init: datetime.datetime, step: int) -> list[dict]:
        key = self._key(init, step)
        if key not in self._index_cache:
            text = self.transport(
                f"{BUCKET_URL}/{key.replace('.grib2', '.index')}"
            ).decode()
            self._index_cache[key] = parse_ecmwf_index(text)
        return self._index_cache[key]

    def _fetch_message(
        self, channel: str, init: datetime.datetime, step: int,
        number: int | None = None, level: str | None = None,
    ) -> np.ndarray:
        entry = self.vocabulary[channel]
        want_level = level if level is not None else (entry.level or None)
        try:
            e = ecmwf_lookup(
                self._index(init, step), entry.provider_id, entry.levtype,
                want_level, number,
            )
        except KeyError:
            if level is None and entry.levtype == "pl" and entry.level:
                return self._interp_missing_level(
                    channel, init, step, number
                )
            raise
        url = f"{BUCKET_URL}/{self._key(init, step)}"
        raw = self._cached_fetch(
            f"{url}#{e['_offset']}#{number}",
            lambda: self.transport(url, offset=e["_offset"], length=e["_length"]),
        )
        msg = grib.decode_message(raw)
        vals = msg.values.astype(np.float32)
        if msg.lon_first < 0:
            # open-data files are -180..180; roll to 0..360 (reference
            # ifs.py:551-553)
            vals = np.roll(vals, vals.shape[1] // 2, axis=1)
        # 0.4°-beta (or any non-canonical) sources land on 0.25° here
        # (reference ic/ifs.py:161-170 re-interp with extrapolation)
        lon = np.arange(0.0, 360.0, 360.0 / vals.shape[1])
        vals = to_canonical_grid(vals, msg.lat, lon)
        return entry.modifier(vals)

    def _interp_missing_level(
        self, channel: str, init: datetime.datetime, step: int,
        number: int | None,
    ) -> np.ndarray:
        """Interpolate a pressure level the product does not publish from
        the two nearest available levels of the same parameter (linear in
        hPa, edge extrapolation — reference ic/ifs.py:38-51)."""
        from skyrim_tpu_torch.data.regrid import interp_pressure_levels

        entry = self.vocabulary[channel]
        target = float(entry.level)
        avail = sorted({
            float(x["levelist"])
            for x in self._index(init, step)
            if x.get("param") == entry.provider_id
            and x.get("levtype") == "pl"
            and x.get("levelist") not in (None, "")
        })
        if len(avail) < 2:
            raise KeyError(
                f"{channel}: level {entry.level} absent and <2 other "
                f"levels of {entry.provider_id} available to interpolate"
            )
        below = [l for l in avail if l <= target]
        above = [l for l in avail if l >= target]
        # bracket when possible, else the two nearest (extrapolation)
        if below and above:
            l0, l1 = below[-1], above[0]
        else:
            pair = sorted(avail, key=lambda l: abs(l - target))[:2]
            l0, l1 = sorted(pair)
        logger.warning(
            "%s: level %s not published; interpolating from %g/%g hPa",
            channel, entry.level, l0, l1,
        )
        fmt = lambda l: str(int(l)) if float(l).is_integer() else str(l)
        stack = np.stack([
            self._fetch_message(channel, init, step, number, level=fmt(l))
            for l in (l0, l1)
        ])
        out = interp_pressure_levels(
            stack, np.asarray([l0, l1]), np.asarray([target])
        )[0]
        return out

    def available(self, init: datetime.datetime) -> bool:
        key = self._key(init, 0).replace(".grib2", ".index")
        return http_exists(f"{BUCKET_URL}/{key}")


class IFSModel(_ECMWFProduct):
    product = "ifs"
    vocabulary = IFS_VOCAB

    def fetch_channel(self, channel, init, step):
        if init < MIN_DATE_0P25:
            raise ValueError(
                f"0.25° IFS open data starts {MIN_DATE_0P25:%Y-%m-%d}"
            )
        return self._fetch_message(channel, init, step)


class IFSSource(ICSource):
    """AWS-IFS 0h-analysis IC source (reference skyrim/libs/ic/ifs.py)."""

    name = "ifs"

    def __init__(self, channel_names, grid=None, **kwargs):
        super().__init__(channel_names)
        self.client = IFSModel(channel_names, **kwargs)

    def fetch(self, time, n_history=1, time_step=datetime.timedelta(hours=6)) -> Field:
        fields = []
        for i in range(n_history):
            t = time - (n_history - 1 - i) * time_step
            init = t.replace(hour=(t.hour // 6) * 6, minute=0, second=0, microsecond=0)
            step = int((t - init).total_seconds() // 3600)
            fields.append(self.client.fetch_dataarray(init, [step]))
        return Field.concat(fields, "time")


def main(argv: list[str] | None = None, transport=None) -> None:
    """The live CLI (skyrim_tpu/data/ifs.py main): fetch a forecast and save
    it.  ``transport`` replaces the HTTP transport (tests)."""
    import argparse

    p = argparse.ArgumentParser("python -m skyrim_tpu_torch.data.ifs")
    p.add_argument("--date", required=True)
    p.add_argument("--time", default="0000")
    p.add_argument("--lead_time", type=int, default=24)
    p.add_argument("--channels", default="u10m,v10m,t2m")
    p.add_argument("--output_dir", default="outputs")
    args = p.parse_args(argv)
    kw = {} if transport is None else {"transport": transport}
    model = IFSModel(args.channels.split(","), **kw)
    _, path = model.predict(
        args.date, args.time, args.lead_time, save=True,
        save_config={"output_dir": args.output_dir},
    )
    print(path)


if __name__ == "__main__":
    main()

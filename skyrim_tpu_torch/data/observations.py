"""Station observations via the Meteostat bulk endpoints (reference
skyrim/libs/benchmark/observations.py: nearest-station hourly obs with
``o_``-prefixed ecmwf-style names and km/h → m/s conversion).

Without the meteostat SDK, this client reads the same
public bulk data (JSON station directory + gzipped hourly CSVs) through
the injectable transport.

The port's copy of skyrim_tpu/data/observations.py; pandas is imported
inside ``observe``, so the module imports without it.
"""

from __future__ import annotations

import datetime
import gzip
import io
import json
import math

from skyrim_tpu_torch.data.transport import http_get

BULK_URL = "https://bulk.meteostat.net/v2"

#: meteostat hourly column → o_-prefixed canonical name
#: (reference observations.py:8-42)
COLUMN_MAP = {
    "temp": "o_t2m",
    "dwpt": "o_d2m",
    "rhum": "o_r2m",
    "prcp": "o_tp",
    "wdir": "o_wdir10",
    "wspd": "o_si10",  # km/h in meteostat; converted to m/s
    "pres": "o_msl",
}
HOURLY_COLUMNS = [
    "date", "hour", "temp", "dwpt", "rhum", "prcp", "snow", "wdir",
    "wspd", "wpgt", "pres", "tsun", "coco",
]  # fmt: skip


def _haversine_km(lat1, lon1, lat2, lon2):
    r = 6371.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))


_STATIONS_CACHE: list[dict] | None = None


def get_stations(transport=http_get) -> list[dict]:
    global _STATIONS_CACHE
    if _STATIONS_CACHE is None:
        raw = transport(f"{BULK_URL}/stations/lite.json.gz")
        _STATIONS_CACHE = json.loads(gzip.decompress(raw).decode())
    return _STATIONS_CACHE


def get_closest_station(lat: float, lon: float, transport=http_get) -> dict:
    """Nearest station by great-circle distance."""
    stations = get_stations(transport)
    best, best_d = None, float("inf")
    for s in stations:
        loc = s.get("location", {})
        d = _haversine_km(lat, lon, loc.get("latitude", 1e9), loc.get("longitude", 1e9))
        if d < best_d:
            best, best_d = s, d
    if best is None:
        raise RuntimeError("no stations available")
    return {**best, "distance_km": best_d}


def observe(
    lat: float,
    lon: float,
    start: datetime.datetime,
    end: datetime.datetime,
    transport=http_get,
) -> pd.DataFrame:
    """Hourly observations from the nearest station, canonical names,
    wind speed in m/s (reference observations.py:8-42)."""
    import pandas as pd

    station = get_closest_station(lat, lon, transport)
    sid = station["id"]
    raw = transport(f"{BULK_URL}/hourly/{sid}.csv.gz")
    df = pd.read_csv(
        io.BytesIO(gzip.decompress(raw)), names=HOURLY_COLUMNS, header=None
    )
    ts = pd.to_datetime(df["date"]) + pd.to_timedelta(df["hour"], unit="h")
    df = df.set_index(ts).loc[start:end]
    df = df[[c for c in COLUMN_MAP if c in df.columns]].rename(columns=COLUMN_MAP)
    if "o_si10" in df.columns:
        df["o_si10"] = df["o_si10"] / 3.6  # km/h → m/s
    df.attrs["station"] = station
    return df

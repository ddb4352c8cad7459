"""Open-Meteo point-forecast client (reference
skyrim/libs/benchmark/openmeteo.py): archive forecasts, previous-runs
forecasts, and multi-model comparison at a point, returned as pandas
DataFrames with the om↔ecmwf variable mapping.  Uses stdlib HTTP via
the injectable transport (no requests-like SDK).

The port's copy of skyrim_tpu/data/openmeteo.py; pandas is imported
inside the functions that build frames, so the module imports without it.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Sequence

from skyrim_tpu_torch.data.transport import http_get

#: open-meteo name ↔ canonical/ecmwf-style name (reference openmeteo.py:7-26)
VARIABLE_MAP = {
    "temperature_2m": "t2m",
    "dew_point_2m": "d2m",
    "surface_pressure": "sp",
    "pressure_msl": "msl",
    "wind_speed_10m": "si10",
    "wind_direction_10m": "wdir10",
    "wind_speed_100m": "si100",
    "precipitation": "tp",
}
INV_VARIABLE_MAP = {v: k for k, v in VARIABLE_MAP.items()}

ARCHIVE_URL = "https://historical-forecast-api.open-meteo.com/v1/forecast"
PREVIOUS_RUNS_URL = "https://previous-runs-api.open-meteo.com/v1/forecast"

DEFAULT_VARS = ("t2m", "msl", "si10")


def _request(url: str, params: dict, transport=http_get) -> dict:
    query = "&".join(
        f"{k}={','.join(v) if isinstance(v, (list, tuple)) else v}"
        for k, v in params.items()
    )
    return json.loads(transport(f"{url}?{query}").decode())


def _to_frame(payload: dict, suffix_strip: str | None = None) -> pd.DataFrame:
    import pandas as pd

    hourly = payload["hourly"]
    times = pd.to_datetime(hourly.pop("time"))
    df = pd.DataFrame(hourly, index=times)
    rename = {}
    for col in df.columns:
        base = col.split("_previous_day")[0] if suffix_strip else col
        if base in VARIABLE_MAP:
            rename[col] = VARIABLE_MAP[base] + (
                col[len(base):].replace("_previous_day", "-") if suffix_strip else ""
            )
    return df.rename(columns=rename)


@lru_cache(maxsize=128)
def forecast(
    lat: float,
    lon: float,
    start_date: str,  # YYYY-MM-DD
    end_date: str,
    variables: tuple = DEFAULT_VARS,
    model: str = "ecmwf_ifs",
    transport=http_get,
) -> pd.DataFrame:
    """Archived point forecast (reference openmeteo.py:50-81).

    model ∈ {ecmwf_ifs, era5, era5_land, gfs_global, ...}
    """
    params = {
        "latitude": lat,
        "longitude": lon,
        "start_date": start_date,
        "end_date": end_date,
        "hourly": [INV_VARIABLE_MAP.get(v, v) for v in variables],
        "models": model,
    }
    return _to_frame(_request(ARCHIVE_URL, params, transport))


@lru_cache(maxsize=128)
def forecast_past(
    lat: float,
    lon: float,
    past_days: int = 5,
    variables: tuple = DEFAULT_VARS,
    model: str = "ecmwf_ifs025",
) -> pd.DataFrame:
    """Previous model runs (≤ 7 days back, reference openmeteo.py:84-119)."""
    if past_days > 7:
        raise ValueError("previous-runs API serves at most 7 days back")
    om_vars = []
    for v in variables:
        base = INV_VARIABLE_MAP.get(v, v)
        om_vars.extend([base] + [f"{base}_previous_day{d}" for d in range(1, past_days + 1)])
    params = {
        "latitude": lat,
        "longitude": lon,
        "past_days": past_days,
        "hourly": om_vars,
        "models": model,
    }
    return _to_frame(_request(PREVIOUS_RUNS_URL, params), suffix_strip="_previous_day")


def forecast_multimodel(
    lat: float,
    lon: float,
    start_date: str,
    end_date: str,
    variables: tuple = DEFAULT_VARS,
    models: Sequence[str] = ("ecmwf_ifs", "gfs_global"),
) -> dict[str, pd.DataFrame]:
    """Side-by-side model comparison (reference openmeteo.py:122-130)."""
    return {
        m: forecast(lat, lon, start_date, end_date, tuple(variables), m)
        for m in models
    }

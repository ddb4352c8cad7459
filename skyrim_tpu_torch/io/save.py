"""Forecast persistence: ids, filenames, local NetCDF.

The port's copy of the local-NetCDF part of skyrim_tpu/io/save.py:
base58 forecast ids, ``{model}__{ic_source}__{start}__{pred}.nc``
filenames and ``save_forecast``/``load_forecast``.  Zarr, S3 and
HuggingFace targets are not ported yet and raise.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from dataclasses import dataclass, field as _field
from pathlib import Path
from typing import Callable

from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.netcdf import read_netcdf, write_netcdf
from skyrim_tpu_torch.utils.logging import logger

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"

LOCAL_CACHE = os.environ.get(
    "SKYRIM_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "skyrim_tpu")
)
OUTPUT_DIR = os.environ.get("SKYRIM_OUTPUT_DIR", str(Path.cwd() / "outputs"))


def _b58encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n:
        n, r = divmod(n, 58)
        out.append(_B58_ALPHABET[r])
    # preserve leading zero bytes as '1's (standard base58)
    pad = len(data) - len(data.lstrip(b"\0"))
    return "1" * pad + "".join(reversed(out))


def generate_forecast_id(length: int = 10) -> str:
    """base58(sha256(utcnow()))[:length]."""
    digest = hashlib.sha256(
        datetime.datetime.now(datetime.timezone.utc).isoformat().encode()
    ).digest()
    return _b58encode(digest)[:length]


@dataclass
class SaveConfig:
    forecast_id: str = _field(default_factory=generate_forecast_id)
    output_dir: str = OUTPUT_DIR
    file_type: str | None = None  # only "netcdf" is ported
    filter_vars: tuple[str, ...] = ()
    mapping_func: Callable[[Field], Field] | None = None


def generate_filename(
    model_name: str,
    start_time: datetime.datetime,
    pred_time: datetime.datetime,
    ic_source: str,
    suffix: str = ".nc",
) -> str:
    """``{model}__{source}__{start}__{pred}{suffix}``."""
    return (
        f"{model_name}__{ic_source}__"
        f"{start_time.strftime('%Y%m%d_%H:%M')}__"
        f"{pred_time.strftime('%Y%m%d_%H:%M')}{suffix}"
    )


def save_forecast(
    forecast: Field,
    model_name: str,
    start_time: datetime.datetime,
    pred_time: datetime.datetime,
    ic_source: str,
    config: SaveConfig | dict | None = None,
) -> str:
    """Persist one forecast step as local NetCDF; returns the path."""
    if config is None:
        config = SaveConfig()
    elif isinstance(config, dict):
        config = SaveConfig(**config)

    out_dir = config.output_dir.rstrip("/")
    if "://" in out_dir or config.file_type not in (None, "netcdf"):
        raise NotImplementedError(
            "only local NetCDF output is ported; zarr, s3:// and hf:// wait"
        )
    if config.filter_vars:
        forecast = forecast.sel(channel=list(config.filter_vars))
    if config.mapping_func is not None:
        forecast = config.mapping_func(forecast)
    forecast = forecast.assign_attrs(
        model=model_name, ic_source=ic_source, forecast_id=config.forecast_id
    )

    filename = generate_filename(model_name, start_time, pred_time, ic_source)
    target_dir = Path(out_dir) / config.forecast_id
    target_dir.mkdir(parents=True, exist_ok=True)
    target = target_dir / filename
    write_netcdf(forecast, target)
    logger.success("saved %s", target)
    return str(target)


def load_forecast(path: str) -> Field:
    """Read a saved NetCDF forecast back into a Field."""
    p = str(path)
    if "://" in p or p.rstrip("/").endswith(".zarr") or Path(p).is_dir():
        raise NotImplementedError("only local NetCDF input is ported")
    return read_netcdf(p)

"""Forecast persistence: ids, filenames, and target dispatch (port of
skyrim_tpu/io/save.py).

Base58 forecast ids, ``{model}__{ic_source}__{start}__{pred}``
filenames, and dispatch by target: local NetCDF or Zarr, any fsspec URL
(``s3://``, ``gs://``, ``memory://``; remote targets default to Zarr),
and ``hf://`` HuggingFace zipped Zarr.  fsspec and huggingface_hub are
imported only where a target needs them.

``stream_save_forecast`` is the production output path: the rollout
runs on the card while a writer thread compresses and writes the frames
already copied to the host, with an optional float16 cast and a channel
subset applied on the card before the copy.
"""

from __future__ import annotations

import datetime
import hashlib
import io
import os
import shutil
import zipfile
from dataclasses import dataclass, field as _field
from pathlib import Path
from typing import Callable

import numpy as np

from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io.netcdf import read_netcdf, write_netcdf, write_netcdf_bytes
from skyrim_tpu_torch.io.zarrlite import ZarrStore, open_store, read_zarr
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
    file_type: str | None = None  # "netcdf" | "zarr"; None → infer from target
    filter_vars: tuple[str, ...] = ()
    mapping_func: Callable[[Field], Field] | None = None
    zarr_store_config: dict = _field(default_factory=dict)


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


def _is_remote(target: str) -> bool:
    return "://" in target


def save_forecast(
    forecast: Field,
    model_name: str,
    start_time: datetime.datetime,
    pred_time: datetime.datetime,
    ic_source: str,
    config: SaveConfig | dict | None = None,
) -> str:
    """Persist one forecast step; returns the output path/URL.  A Zarr
    target is created by the first step and appended to (along time) by
    the next."""
    if config is None:
        config = SaveConfig()
    elif isinstance(config, dict):
        config = SaveConfig(**config)

    if config.filter_vars:
        forecast = forecast.sel(channel=list(config.filter_vars))
    if config.mapping_func is not None:
        forecast = config.mapping_func(forecast)
    forecast = forecast.assign_attrs(
        model=model_name, ic_source=ic_source, forecast_id=config.forecast_id
    )

    out_dir = config.output_dir.rstrip("/")
    file_type = config.file_type or ("zarr" if _is_remote(out_dir) else "netcdf")

    if out_dir.startswith("hf://"):
        return _save_hf(forecast, out_dir, config)

    if file_type == "zarr":
        target = f"{out_dir}/{config.forecast_id}.zarr"
        zs = ZarrStore(open_store(target, **config.zarr_store_config))
        if zs.exists():
            zs.append_field(forecast, append_dim="time")
            logger.debug("appended to zarr store %s", target)
        else:
            zs.write_field(forecast)
            logger.success("created zarr store %s", target)
        return target

    filename = generate_filename(model_name, start_time, pred_time, ic_source)
    if _is_remote(out_dir):
        import fsspec

        target = f"{out_dir}/{config.forecast_id}/{filename}"
        with fsspec.open(target, "wb") as fh:
            fh.write(write_netcdf_bytes(forecast))
        logger.success("uploaded %s", target)
        return target

    target_dir = Path(out_dir) / config.forecast_id
    target_dir.mkdir(parents=True, exist_ok=True)
    target = target_dir / filename
    write_netcdf(forecast, target)
    logger.success("saved %s", target)
    return str(target)


def stream_save_forecast(
    model,
    params,
    ic: np.ndarray,
    start_time: datetime.datetime,
    n_steps: int,
    ic_source: str = "file",
    config: SaveConfig | dict | None = None,
    save_dtype: str = "float32",
    zlib_level: int = 1,
    writer_threads: int | None = None,
) -> str:
    """IC → streaming rollout → one Zarr store, appended step by step.

    Three stages overlap:

    - the card computes step k+1 (``rollout.stream_rollout``),
    - step k's frame is copied to pinned host memory on a side stream,
    - a writer thread compresses and writes step k−1 (the chunks of one
      step compressed in parallel over ``writer_threads``; zlib releases
      the GIL).

    ``config.filter_vars`` selects channels and ``save_dtype="float16"``
    casts, both on the card before the copy, so the dropped channels and
    bytes never cross to the host.  The queue between the rollout and the
    writer holds two frames: each frame is its own pinned buffer, held by
    the writer until written, so the card's next copies never land in a
    frame that is still being written.  A writer failure stops the
    rollout and is raised here after the writer has ended.  Returns the
    store's path once every step is written and the store consolidated.
    """
    import queue
    import threading

    import torch

    from skyrim_tpu_torch.rollout import rollout_times, stream_rollout

    if config is None:
        config = SaveConfig()
    elif isinstance(config, dict):
        config = SaveConfig(**config)
    np_dtype = np.dtype(save_dtype)
    transfer = torch.float16 if np_dtype == np.float16 else None
    if writer_threads is None:
        writer_threads = min(32, max(4, (os.cpu_count() or 4) - 2))

    out_dir = config.output_dir.rstrip("/")
    target = f"{out_dir}/{config.forecast_id}.zarr"
    zs = ZarrStore(open_store(target, **config.zarr_store_config), level=zlib_level, workers=writer_threads)

    times = rollout_times(start_time, model.time_step, n_steps)
    if config.filter_vars:
        all_chans = list(model.channels)
        channel_idx = tuple(all_chans.index(v) for v in config.filter_vars)
        out_channels = list(config.filter_vars)
    else:
        channel_idx = None
        out_channels = list(model.channels)
    nchan = len(out_channels)
    q: queue.Queue = queue.Queue(maxsize=2)  # bounds the host frames in flight
    err: list[BaseException] = []

    def writer():
        try:
            first = True
            while True:
                item = q.get()
                if item is None:
                    return
                t, frame = item
                f = Field.from_canonical(
                    frame[None].astype(np_dtype, copy=False),
                    [t], out_channels, model.grid.lat, model.grid.lon,
                    attrs={"model": model.name, "ic_source": ic_source,
                           "forecast_id": config.forecast_id},
                )
                if first:
                    # channel-chunked layout: appends compress in parallel
                    zs.write_field(f, channel_chunk=max(1, nchan // writer_threads))
                    first = False
                else:
                    zs.append_field(f)
        except BaseException as e:  # raised to the caller below
            err.append(e)

    th = threading.Thread(target=writer, daemon=True)

    def put(item) -> bool:
        """Queue an item; False once the writer has ended (a full queue
        would otherwise wait for it forever)."""
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if not th.is_alive():
                    return False

    state = model.init_state(params, ic, start_time=start_time)
    th.start()
    try:
        for t, frame in zip(
            times, stream_rollout(model, params, state, n_steps,
                                  transfer_dtype=transfer, channel_idx=channel_idx)
        ):
            if err or not put((t, frame)):
                break
    finally:
        put(None)
        th.join()
    if err:
        raise err[0]
    zs.consolidate()
    logger.success("streamed %d steps to %s", n_steps, target)
    return target


def _save_hf(forecast: Field, out_dir: str, config: SaveConfig) -> str:
    """hf://org/repo/path → zipped Zarr uploaded via huggingface_hub."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is required for hf:// targets but is not installed"
        ) from e
    parts = out_dir[len("hf://") :].split("/")
    repo_id = "/".join(parts[:2])
    sub = "/".join(parts[2:])
    tmp = Path(LOCAL_CACHE) / "hf_upload" / f"{config.forecast_id}.zarr"
    if tmp.exists():
        shutil.rmtree(tmp)
    ZarrStore(open_store(tmp)).write_field(forecast)
    zip_path = tmp.with_suffix(".zarr.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for p in tmp.rglob("*"):
            if p.is_file():
                zf.write(p, p.relative_to(tmp))
    path_in_repo = f"{sub}/{config.forecast_id}.zarr.zip".lstrip("/")
    HfApi().upload_file(
        path_or_fileobj=str(zip_path),
        path_in_repo=path_in_repo,
        repo_id=repo_id,
        repo_type="dataset",
    )
    return f"hf://{repo_id}/{path_in_repo}"


def remote_forecast_exists(target: str, **storage_options) -> bool:
    """Whether a forecast already exists at a (remote) prefix."""
    try:
        store = open_store(target, **storage_options)
        return bool(store.list_prefix(""))
    except Exception:
        return False


def load_forecast(path: str) -> Field:
    """Read a saved forecast (NetCDF file or Zarr store, local or at an
    fsspec URL) back into a Field."""
    p = str(path)
    if p.rstrip("/").endswith(".zarr"):
        return read_zarr(p)
    if not _is_remote(p):
        return read_zarr(p) if Path(p).is_dir() else read_netcdf(p)
    import fsspec

    with fsspec.open(p, "rb") as fh:
        return read_netcdf(io.BytesIO(fh.read()))


def read_forecast(zarr_store_path: str, forecast_id: str, **storage_options) -> Field:
    """A forecast's Zarr store under ``zarr_store_path``, by its id."""
    return read_zarr(f"{zarr_store_path.rstrip('/')}/{forecast_id}.zarr", **storage_options)

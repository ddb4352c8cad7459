"""Autoregressive rollout engine (port of skyrim_tpu/rollout.py).

- ``scan_rollout``: the N-step rollout as a loop whose state never
  leaves the device; returns all outputs stacked on the device.
- ``stream_rollout``: a host generator for forecast production.  On a
  CUDA device step k's output is copied to pinned host memory on a side
  stream while step k+1 computes, so the copy never serializes the loop;
  a channel subset and a narrower dtype are applied on the device first,
  so the copy moves fewer bytes.

Both run on the model's device.  ``perturb_initial_condition`` and
``estimate_pressure_hpa`` are host helpers on numpy ICs.
"""

from __future__ import annotations

import datetime
from typing import Iterator

import numpy as np
import torch

from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.models.base import ModelState, Params, PrognosticModel
from skyrim_tpu_torch.utils.logging import logger


@torch.no_grad()
def scan_rollout(
    model: PrognosticModel, params: Params, state: ModelState, n_steps: int
) -> tuple[ModelState, torch.Tensor]:
    """Run n_steps fully on the device; returns (final_state, outputs
    (>= n_steps, C, H, W)) — models with frames_out > 1 may overshoot."""
    ys = []
    for _ in range(-(-n_steps // model.frames_out)):
        state, y = model.advance(params, state)
        ys.append(y)
    return state, torch.cat(ys, dim=0)


@torch.no_grad()
def stream_rollout(
    model: PrognosticModel,
    params: Params,
    state: ModelState,
    n_steps: int,
    transfer_dtype: torch.dtype | None = None,
    channel_idx: tuple[int, ...] | None = None,
) -> Iterator[np.ndarray]:
    """Yield each step's output (C, H, W) as numpy, overlapping the
    device→host copy of step k with the compute of step k+1.

    ``channel_idx`` (channel positions) selects the transferred subset
    and ``transfer_dtype`` (e.g. ``torch.float16``) casts it, both on the
    device before the copy: the device→host bytes shrink by C_sel/C and
    by the narrower type, for sinks that keep only those."""
    device = state.x.device
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    idx = None if channel_idx is None else torch.as_tensor(channel_idx, dtype=torch.long, device=device)
    emitted = 0
    pending = None

    def drain(item):
        nonlocal emitted
        host, done = item
        if done is not None:
            done.synchronize()
        for frame in host.numpy():
            if emitted < n_steps:
                emitted += 1
                yield frame

    for _ in range(-(-n_steps // model.frames_out)):
        state, y = model.advance(params, state)
        if idx is not None:
            y = y.index_select(1, idx)
        if transfer_dtype is not None:
            y = y.to(transfer_dtype)
        if copy_stream is None:
            item = (y, None)
        else:
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            copy_stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(copy_stream):
                host.copy_(y, non_blocking=True)
                y.record_stream(copy_stream)
                done = torch.cuda.Event()
                done.record(copy_stream)
            item = (host, done)
        if pending is not None:
            yield from drain(pending)
        pending = item
    if pending is not None:
        yield from drain(pending)


def initial_condition_from_field(model: PrognosticModel, ic: Field) -> np.ndarray:
    """The last n_history frames in the model's channel order."""
    f = ic.sel(channel=list(model.channels))
    f = f.transpose("time", "channel", "lat", "lon")
    n = min(model.n_history, f.sizes["time"])
    return f.data[-n:].astype(np.float32)


def rollout_times(
    start_time: datetime.datetime, time_step: datetime.timedelta, n_steps: int
) -> list[datetime.datetime]:
    return [start_time + (i + 1) * time_step for i in range(n_steps)]


def outputs_to_field(
    model: PrognosticModel,
    outputs,
    start_time: datetime.datetime,
    include_ic: np.ndarray | None = None,
) -> Field:
    """Stack rollout outputs (n, C, H, W) into a canonical Field; with
    ``include_ic`` (C, H, W) prepended at t=start_time."""
    if torch.is_tensor(outputs):
        outputs = outputs.cpu().numpy()
    outputs = np.asarray(outputs)
    times = rollout_times(start_time, model.time_step, outputs.shape[0])
    if include_ic is not None:
        outputs = np.concatenate([np.asarray(include_ic)[None], outputs], axis=0)
        times = [start_time] + times
    return Field.from_canonical(
        outputs, times, model.channels, model.grid.lat, model.grid.lon,
        attrs={"model": model.name},
    )


def perturb_initial_condition(
    ic: np.ndarray,
    model: PrognosticModel,
    channel: str,
    lat: float,
    lon: float,
    value: float,
    mode: str = "set",
) -> np.ndarray:
    """Point-edit a channel at the nearest grid cell (the "simulate extreme
    weather" hook).  mode: "set" replaces, "add" offsets, "scale"
    multiplies."""
    ic = np.array(ic, copy=True)
    c = list(model.channels).index(channel)
    i, j = model.grid.nearest_index(lat, lon)
    sl = (Ellipsis, c, i, j) if ic.ndim == 4 else (c, i, j)
    if mode == "set":
        ic[sl] = value
    elif mode == "add":
        ic[sl] = ic[sl] + value
    elif mode == "scale":
        ic[sl] = ic[sl] * value
    else:
        raise ValueError(f"unknown mode {mode!r}")
    logger.debug("perturbed %s at (%.2f, %.2f) mode=%s", channel, lat, lon, mode)
    return ic


def estimate_pressure_hpa(elevation_m: float) -> float:
    """Barometric pressure at elevation (standard atmosphere)."""
    p0, t0, lapse, g, M, R = 1013.25, 288.15, 0.0065, 9.80665, 0.0289644, 8.3144598
    return p0 * (1 - lapse * elevation_m / t0) ** (g * M / (R * lapse))

"""Autoregressive rollout engine (port of skyrim_tpu/rollout.py).

- ``scan_rollout``: the N-step rollout as a loop whose state never
  leaves the device; returns all outputs stacked on the device.
- ``stream_rollout``: a host generator for forecast production.  On a
  CUDA device step k's output is copied to pinned host memory on a side
  stream while step k+1 computes, so the copy never serializes the loop.

Both run on the model's device.
"""

from __future__ import annotations

import datetime
from typing import Iterator

import numpy as np
import torch

from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.models.base import ModelState, Params, PrognosticModel


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
) -> Iterator[np.ndarray]:
    """Yield each step's output (C, H, W) as numpy, overlapping the
    device→host copy of step k with the compute of step k+1."""
    device = state.x.device
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
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

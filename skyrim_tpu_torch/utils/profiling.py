"""Tracing/profiling hooks (port of skyrim_tpu/utils/profiling.py).

- ``trace(dir)``: a ``torch.profiler`` trace of the host and the card
  (CPU and CUDA activities), written as a Chrome trace into ``dir``
  (chrome://tracing, Perfetto)
- ``annotate(name)``: a named region inside a trace, also an NVTX range
  on the card's timeline
- ``StepTimer``: per-step wall-time stats for rollout loops; ``force``
  waits for the card before the clock is read
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

from skyrim_tpu_torch.utils.logging import logger


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str = "skyrim_trace"):
    """Profile the block; the Chrome trace goes to ``log_dir/trace.json``.
    Yields the profiler (its ``key_averages()`` hold the op table)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region context: a ``record_function`` range in the trace, and an
    NVTX range where a card is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Collects per-step wall times; ``force`` waits for a tensor's device."""

    def __init__(self, name: str = "step"):
        self.name = name
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def force(self, tensor) -> float:
        """Wait for ``tensor``'s device and return its mean as a float."""
        if tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)
        return float(tensor.float().mean())

    @property
    def stats(self) -> dict:
        if not self.times:
            return {}
        return {
            "n": len(self.times),
            "mean_s": statistics.fmean(self.times),
            "min_s": min(self.times),
            "max_s": max(self.times),
        }

    def log(self):
        s = self.stats
        if s:
            logger.info(
                "%s: n=%d mean=%.3fs min=%.3fs max=%.3fs",
                self.name, s["n"], s["mean_s"], s["min_s"], s["max_s"],
            )

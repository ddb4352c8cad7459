"""Wall-clock timing helpers (port of skyrim_tpu/utils/timing.py).

The log lines are the JAX module's.  Work on a card is queued, not done,
when a call returns: where the timed function returns a CUDA tensor (or a
tuple, list or dict holding one) the card is synchronised before the clock
stops, and ``log_time`` synchronises every card before it stops.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager

import torch

from skyrim_tpu_torch.utils.logging import logger


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (nested tuples, lists, dicts)."""
    if torch.is_tensor(obj):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    return out


def synchronize(result=None):
    """Wait for the cards that hold the tensors of ``result``; returns it."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def timeit(fn):
    """Decorator logging the wall time of each call at DEBUG level."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        result = synchronize(fn(*args, **kwargs))
        logger.debug("%s took %.3fs", fn.__qualname__, time.perf_counter() - start)
        return result

    return wrapper


class Timer:
    """Accumulating timer usable as a context manager.

    >>> t = Timer()
    >>> with t:
    ...     do_work()
    >>> t.elapsed  # seconds
    """

    def __init__(self):
        self.elapsed = 0.0
        self.count = 0
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._start
        self.count += 1
        self._start = None
        return False

    @property
    def mean(self) -> float:
        return self.elapsed / max(self.count, 1)


@contextmanager
def log_time(label: str):
    """Log ``label: <s>s`` for the block, the cards' queued work included."""
    start = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    logger.info("%s: %.3fs", label, time.perf_counter() - start)

"""Tracing hooks (port of skyrim_tpu/utils/profiling.py).

- ``trace(dir)``: a ``torch.profiler`` trace of the host and the card
  (CPU and CUDA activities), written as a Chrome trace into ``dir``
  (chrome://tracing, Perfetto)
- ``annotate(name, nbytes=0, device=None)``: the port's span.  While a
  ``torch.profiler`` session records, it opens a host range of that name
  in the trace and keeps a ``Span`` record in memory; otherwise it costs
  one flag check and records nothing
- ``spans()``: the records of the newest profiling session

The profiler's own start hook is wrapped so that each session's start
clears the earlier records; a session keeps one record (and on a CUDA
device two events) a span until the next one starts, as the profiler keeps
its own events.  Records are stamped on the profiler's own host clock (Unix-epoch ns, the
clock of the trace's events), so a record lines up with its range and
with the card's events in the same trace.  A span given a CUDA device (or
a tensor on one) also records a pair of timing events on the current
stream at entry and exit; ``Span.device_ms`` resolves them when read,
after the caller has synchronised.  Spans opened while the current stream
captures a CUDA graph record nothing.  A span's parent is the innermost
span open on its own thread: on CUDA, autograd runs the backward on a
thread of its own, so kernel spans inside ``loss.backward()`` (remat's
recompute) have no parent.

The port's spans, each at a layer boundary (``nbytes`` the bytes it moves):

====================================  =========================================  ==========
span                                  where                                      ``nbytes``
====================================  =========================================  ==========
``skyrim.model.advance``              ``rollout.stream_rollout``, one a step     —
``skyrim.rollout.stage``              ``stream_rollout``: the pinned buffer and  —
                                      the side-stream copy issued
``skyrim.init_state.upload``          ``models/base.py`` ``init_state``          the IC
``skyrim.K1`` … ``skyrim.K14``        ``ops/cost.py`` ``kernel``, outermost      —
                                      call only, on the call's device
``skyrim.train.upload``               ``Trainer.train_step``: the pair's copies  the pair
``skyrim.train.forward``              ``Trainer.loss``, on the trainer's device  —
``skyrim.train.backward``             ``loss.backward()``, on the device         —
``skyrim.train.update``               ``Trainer.update``, on the device          —
====================================  =========================================  ==========
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

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


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One span: its name, host interval (profiler-clock ns), thread (``threading.get_ident``),
    enclosing span on that thread, counted bytes and, on a CUDA device, its timing events."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Span | None
    nbytes: int
    events: tuple | None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Device-timeline ms from the span's entry to its exit (None
        without a CUDA device); read after the device has synchronised."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


_records: list[Span] = []
_open = threading.local()  # .stack: each thread's open spans, innermost last


def _session_start(_start=_autograd_profiler._run_on_profiler_start):
    """The profiler's start hook (every ``torch.profiler`` session calls it):
    the new session's records start afresh."""
    _records.clear()
    _start()


_autograd_profiler._run_on_profiler_start = _session_start


def spans() -> list[Span]:
    """The spans of the newest profiling session, in the order opened."""
    return list(_records)


class _Off:
    """The span while no profiler records: nothing happens."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


_streams: dict[tuple, torch.cuda.Stream] = {}  # (stream id, device index, device type) → its Stream


def _current_stream(index: int) -> torch.cuda.Stream:
    """The current stream of CUDA device ``index``, its Python object made
    once (``torch.cuda.current_stream`` makes a new one each call)."""
    key = torch._C._cuda_getCurrentStream(index)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _On:
    __slots__ = ("record", "range", "stream")

    def __init__(self, name: str, nbytes: int, device_index: int):
        self.stream = _current_stream(device_index) if device_index >= 0 else None
        events = None
        if self.stream is not None:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.record = Span(name, 0, 0, threading.get_ident(), None, int(nbytes), events)
        # a host range of the function scope: unlike record_function's user
        # scope, it leaves no mirror range on the card's timeline
        self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        rec = self.record
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec.parent = stack[-1] if stack else None
        stack.append(rec)
        _records.append(rec)
        self.range.__enter__()
        if rec.events is not None:
            rec.events[0].record(self.stream)
        rec.start_ns = time.time_ns()  # stamped inside the range, as the profiler stamps it
        return rec

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record(self.stream)
        self.range.__exit__(None, None, None)
        _open.stack.pop()
        return False


def annotate(name: str, nbytes: int = 0, device=None):
    """A span named ``name`` around the block, counting ``nbytes``; with
    ``device`` (a device or a tensor) on CUDA it also times the block on
    that device's current stream.  Records only while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.cuda.is_initialized() and torch._C._cuda_isCurrentStreamCapturing():
        return _OFF
    index = -1
    if torch.is_tensor(device):
        index = device.get_device()
    elif device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()
    return _On(name, nbytes, index)

"""What the port records itself: the spans and counters that
``skyrim_tpu_torch.utils.profiling.annotate`` keeps while a profiler
records, read after a traced window (the newest profiling session's).

Host times are the records' own (the profiler's clock); device times are
each span's pair of CUDA events, resolved here after the harness has
synchronised, and None where a span had none (the CPU dry path).  Every
reader gives None where nothing was recorded: an untraced run, another
traffic kind, or a port that records no such span.
"""

from __future__ import annotations


def records(run, kind: str, name: str, prefix: bool = False) -> list | None:
    """The window's finished spans called ``name`` (or starting with it,
    with ``prefix``) in a traced run of traffic ``kind``; None if none."""
    if not run.trace or run.traffic["kind"] != kind or not run.steps:
        return None
    try:
        from skyrim_tpu_torch.utils.profiling import spans
    except ImportError:  # a port that keeps no records
        return None
    got = [s for s in spans() if (s.name.startswith(name) if prefix else s.name == name) and s.end_ns]
    return got or None


def host_ms_per_step(run, kind: str, name: str) -> float | None:
    recs = records(run, kind, name)
    return None if recs is None else sum(s.end_ns - s.start_ns for s in recs) * 1e-6 / run.steps


def device_ms_per_step(run, kind: str, name: str, prefix: bool = False) -> float | None:
    recs = records(run, kind, name, prefix)
    if recs is None:
        return None
    ms = [s.device_ms for s in recs]
    return None if None in ms else sum(ms) / run.steps


def gbps(run, kind: str, name: str) -> float | None:
    """Σ bytes counted over Σ host seconds of the spans, in GB/s."""
    recs = records(run, kind, name)
    if recs is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in recs)
    return sum(s.nbytes for s in recs) / ns if ns > 0 else None

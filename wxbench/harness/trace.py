"""The traced window: ``torch.profiler`` over the card's kernels, copies and
the host's ops, reduced to what the metric readers and ``breakdown`` read.

- busy: the union of the device events' intervals inside the window (the
  ``wx.window`` range that the harness opens around it);
- each kernel's owner: the innermost benchmark span (``wx.<label>``,
  ``harness.spans``) open on the host when it was launched, by the launch
  call's correlation with the kernel, else by the host op it ran under;
- ``breakdown``: the ten device operations that took most time, and the ten
  longest idle gaps named by what the host was doing in them (the
  innermost benchmark span and host op open at the gap's middle).
"""

from __future__ import annotations

import bisect
import dataclasses
import time

NAME_MAX = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict  # span label (None: under no span) → device seconds of kernels
    breakdown: dict


def warm(run) -> None:
    """Start the profiler once in set-up, so that the window does not pay
    for its first start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=_activities(run)):
        torch.zeros(1, device=run.torch_device).add_(1)
        if run.device != "cpu":
            torch.cuda.synchronize()


def _activities(run):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device != "cpu" else [])


def start(run):
    from torch.profiler import profile, record_function

    for calls in (*run.calls.values(), *run.counters.values()):
        calls.clear()
    prof = profile(activities=_activities(run))
    prof.__enter__()
    window = record_function("wx.window")
    window.__enter__()
    run.state["_window_range"] = window
    run.state["_t_trace"] = time.perf_counter()
    return prof


def stop(run, prof) -> Trace:
    import torch

    if run.device != "cpu":
        torch.cuda.synchronize()  # the window's launches all run inside its range
    run.state.pop("_window_range").__exit__(None, None, None)
    prof.__exit__(None, None, None)
    t0 = time.perf_counter()
    tr = reduce(prof.profiler.kineto_results.events())
    run.state["trace_reduce_s"] = time.perf_counter() - t0
    return tr


def _innermost(starts, items, t):
    """The latest-starting (start, end, name) of ``items`` (sorted by start)
    that contains t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        s, e, name = items[j][:3]
        if s <= t <= e:
            return items[j]
    return None


def reduce(events) -> Trace:
    from torch.autograd import DeviceType

    window = None
    spans, host_ops, launches, op_start, device = [], [], {}, {}, []
    main_thread = None
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            if name.startswith("wx."):  # a span's mirror on the device's timeline, not an operation
                continue
            device.append((s, end, name, e.correlation_id(), e.linked_correlation_id()))
            continue
        if name == "wx.window":
            window, main_thread = (s, end), e.start_thread_id()
        elif name.startswith("wx."):
            spans.append((s, end, name[3:]))
        elif name.startswith("cu"):  # a CUDA runtime or driver call: cudaLaunchKernel, cuLaunchKernelEx, ...
            launches[e.correlation_id()] = s
        else:
            op_start[e.correlation_id()] = s
            host_ops.append((s, end, name, e.start_thread_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no wx.window range")
    w0, w1 = window
    spans.sort()
    span_starts = [s for s, _, _ in spans]
    kernel_s, totals, busy_iv = {}, {}, []
    for s, end, name, corr, linked in device:
        if end <= w0 or s >= w1:
            continue
        busy_iv.append((max(s, w0), min(end, w1)))
        dur = end - s
        key = name[:NAME_MAX]
        totals[key] = totals.get(key, 0) + dur
        if name.startswith(("Memcpy", "Memset")):  # the copy engine's, not a kernel
            continue
        t_launch = launches.get(corr, op_start.get(linked))
        owner = _innermost(span_starts, spans, t_launch) if t_launch is not None else None
        label = owner[2] if owner else None
        kernel_s[label] = kernel_s.get(label, 0.0) + dur * 1e-9
    merged = _merge(busy_iv)
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    gaps.sort(reverse=True)
    main_ops = sorted((s, e, n) for s, e, n, th in host_ops if th == main_thread)
    main_starts = [s for s, _, _ in main_ops]
    idle = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        sp = _innermost(span_starts, spans, mid)
        op = _innermost(main_starts, main_ops, mid)
        idle.append([f"{'wx.' + sp[2] if sp else 'python'} / {op[2][:NAME_MAX] if op else '-'}", length * 1e-9])
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=(w1 - w0) * 1e-9,
        busy_s=busy * 1e-9,
        kernel_s=kernel_s,
        breakdown={"device_ops": [[n, ns * 1e-9] for n, ns in top], "idle_gaps": idle},
    )


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out

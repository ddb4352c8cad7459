"""Per-op device-time breakdown for a model step (port of
skyrim_tpu/utils/op_stats.py, on ``torch.profiler``).

The JAX module reduces an xprof trace of a jitted step to a per-HLO-op
self-time table.  Here ``torch.profiler`` traces the steps with the CUDA
activity and the table is built from the card's own events, one per kernel
launch: their time is self time (a kernel has no children), so no wrapper
is counted twice — the CPU ops that launched them carry the same time as
``device_time_total`` and are left out.  Without a card the CPU ops' self
times take their place.  Beside the table: the device's busy time (the
union of the events' intervals on its timeline) and its idle share of the
steps' host wall time.

Usage::

    python -m skyrim_tpu_torch.utils.op_stats pangu [n_steps] [top_k] [--device cpu]
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch


class OpStats(NamedTuple):
    #: (self_us_per_step, fraction, total_us_per_step, name), by self time
    rows: list
    #: the rows' self time per step, µs
    total_us: float
    #: the union of the events' intervals per step, µs
    busy_us: float
    #: host wall time per step, µs
    wall_us: float

    @property
    def idle_share(self) -> float:
        return 1 - self.busy_us / self.wall_us if self.wall_us > 0 else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def collect_op_stats(step_fn, args=(), n_steps: int = 3, logdir: str | None = None, device="cuda",
                     warmup: int = 1) -> OpStats:
    """Run ``step_fn(*args)`` ``warmup`` times, then ``n_steps`` times under
    ``torch.profiler``; returns ``OpStats``.  ``device`` is where the steps
    run: ``"cuda"`` tables the card's kernels, ``"cpu"`` the CPU ops.
    ``logdir``: where to write the Chrome trace, if given."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        step_fn(*args)
    _sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step_fn(*args)
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    if logdir:
        import os

        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    excl: dict[str, float] = {}
    tot: dict[str, float] = {}
    spans = []
    for e in prof.events():
        if e.device_type != kind:
            continue
        s = e.self_device_time_total if cuda else e.self_cpu_time_total
        t = e.device_time_total if cuda else e.cpu_time_total
        excl[e.name] = excl.get(e.name, 0.0) + s
        tot[e.name] = tot.get(e.name, 0.0) + t
        spans.append((e.time_range.start, e.time_range.end))
    total = sum(excl.values())
    rows = sorted(((excl[n] / n_steps, excl[n] / total if total else 0.0, tot[n] / n_steps, n) for n in excl),
                  reverse=True)
    return OpStats(rows, total / n_steps, _union_us(spans) / n_steps, wall_us / n_steps)


def main(argv: list[str]) -> None:
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.utils.device import resolve_device

    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    name = argv[0] if argv else "pangu"
    n_steps = int(argv[1]) if len(argv) > 1 else 3
    top_k = int(argv[2]) if len(argv) > 2 else 40
    dev = resolve_device(device)
    model = MODELS[name](device=dev)
    params = model.init_params()
    state = model.init_state(params, torch.zeros(model.state_shape[1:]))

    stats = collect_op_stats(lambda: model.advance(params, state), (), n_steps, device=dev)
    print(
        f"{name}: {stats.total_us:.0f} us/step device EXCLUSIVE self-time "
        f"(busy {stats.busy_us:.0f} us, wall {stats.wall_us:.0f} us, idle share {stats.idle_share:.3f}), "
        f"top {top_k} ops:"
    )
    for excl, frac, tot, nm in stats.rows[:top_k]:
        wrap = f" (span {tot:.0f} us)" if tot > 1.5 * max(excl, 1.0) else ""
        print(f"{excl:10.0f} us {100 * frac:5.1f}%  {nm[:110]}{wrap}")


if __name__ == "__main__":
    main(sys.argv[1:])

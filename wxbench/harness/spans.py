"""Spans around the port's entry points, from the benchmark's side.

In a traced run each name that a metric's ``SPANS`` lists,
``(module, attribute, label)``, is replaced where the port's modules look
it up (``skyrim_tpu_torch.models.pangu.fused_swin_block``, or a method
such as ``skyrim_tpu_torch.finetune.trainer.Trainer.update``) by a wrapper
that opens ``torch.profiler.record_function("wx.<label>")`` around the
call and records the call's counted work (``harness.counts``).  A fourth
element ``"timed"`` also synchronises the device before and after the call
and records its host-clock seconds in ``run.counters["<label>_s"]``.
Untraced runs call the port untouched.
"""

from __future__ import annotations

import functools
import importlib
import time

from wxbench.harness import counts


def _owner(module: str, attr: str):
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


def install(run, targets) -> None:
    from torch.profiler import record_function

    run.state.setdefault("_spans", [])
    seen = {(m, a) for m, a, _, _ in run.state["_spans"]}
    import torch

    for module, attr, label, *opts in targets:
        if (module, attr) in seen:
            continue
        seen.add((module, attr))
        owner, name = _owner(module, attr)
        fn = getattr(owner, name)
        tag = "wx." + label
        calls = run.calls.setdefault(label, [])
        timed = "timed" in opts and run.device != "cpu"
        times = run.counters.setdefault(label + "_s", [])

        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, _tag=tag, _label=label, _calls=calls, _timed=timed, _times=times, **kwargs):
            _calls.append(counts.call_cost(_label, args, kwargs))
            if _timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with record_function(_tag):
                out = _fn(*args, **kwargs)
            if _timed:
                torch.cuda.synchronize()
                _times.append(time.perf_counter() - t0)
            return out

        setattr(owner, name, wrapped)
        run.state["_spans"].append((module, attr, label, fn))


def uninstall(run) -> None:
    for module, attr, _, fn in run.state.pop("_spans", []):
        owner, name = _owner(module, attr)
        setattr(owner, name, fn)

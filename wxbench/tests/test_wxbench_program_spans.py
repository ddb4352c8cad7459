"""The readers of the port's own spans and counters (``harness/program_spans.py``
and the nine metrics it serves), on the CPU.

- Through the harness's CPU dry path with ``--trace 1``, a forecast cell
  prints ``enqueue_ms.forecast``, ``stage_ms.forecast`` and
  ``h2d_gbps.forecast`` and a finetune cell ``upload_ms.train`` and
  ``h2d_gbps.train``, each positive; neither prints a device-timeline
  metric (``kernels_ms.forecast``, ``fwd_ms.train``, ``bwd_ms.train``,
  ``opt_ms.train``): the CPU has no device timeline.
- Each reader gives None, and raises nothing, where there is nothing to
  read: an untraced run, another traffic kind, or a port that keeps no
  span records (the readers must run on a checkout that predates them).
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_wxbench_harness import BENCH, ROOT, _tiny_pangu, run_dry  # noqa: E402

NEW = {
    "forecast_10d": (("enqueue_ms.forecast", "stage_ms.forecast", "h2d_gbps.forecast"), ("kernels_ms.forecast",)),
    "finetune_b1": (("upload_ms.train", "h2d_gbps.train"), ("fwd_ms.train", "bwd_ms.train", "opt_ms.train")),
}
ALL = [m for host, device in NEW.values() for m in host + device]


@pytest.mark.parametrize("traffic", sorted(NEW))
def test_traced_dry_run_prints_the_host_clock_metrics(tmp_path, traffic):
    bench, cell, _ = _tiny_pangu(tmp_path, traffic)
    rc, line, err = run_dry(bench, cell, seconds=5.0, trace=1)  # a few steps in the window on a busy host too
    assert rc == 0, err[-3000:]
    host, device = NEW[traffic]
    for name in host:
        assert name in line["metrics"] and line["metrics"][name]["value"] > 0, (name, line["metrics"])
    assert not set(device) & set(line["metrics"])
    units = {m["name"]: m["unit"] for m in json.loads(bench.read_text())["per_layer"]}
    assert all(line["metrics"][n]["unit"] == units[n] for n in host)


def _run(kind: str, trace: bool = True, steps: int = 4):
    return types.SimpleNamespace(trace=trace, traffic={"kind": kind}, steps=steps)


@pytest.mark.parametrize("name", ALL)
def test_reader_reads_nothing_where_nothing_was_recorded(name, monkeypatch):
    from wxbench.harness import core

    reader = core.load_metric(ROOT, name)
    kind = "forecast" if name.endswith(".forecast") else "finetune"
    other = "finetune" if kind == "forecast" else "forecast"
    assert reader.read(_run(kind, trace=False)) is None
    assert reader.read(_run(other)) is None
    # a port without span records, as the parent of this benchmark's readers has
    import skyrim_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "spans")
    assert reader.read(_run(kind)) is None


def test_the_nine_metrics_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(ALL) <= set(per_layer)
    for name in ALL:
        m = per_layer[name]
        assert m["source"] == ("program_counter" if name.startswith("h2d_") else "program_span")
        assert all(c.endswith("forecast_10d" if name.endswith(".forecast") else "finetune_b1") for c in m["workloads"])

"""The benchmark's driver loop, run by ``wxbench/run.py``.

Everything that belongs to one configuration, traffic mix, metric or cell
is found by name from ``BENCHMARK.json``:

- ``configs``' ``file``: the configuration's sizes; its ``family`` names
  ``wxbench/families/<family>.py`` (the port's model built at those sizes,
  weights drawn on the device, the plain reference's step);
- ``wxbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the general generator ``wxbench/drivers/<kind>.py``;
- ``wxbench/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None (nothing to read), with the spans it needs in
  ``SPANS``;
- ``wxbench/limits/<cell>.json``: the limit of each number that ``correct``
  compares, with the readings it was set from.

A run: set-up (model, weights, the traffic's pools, warm-up) → the window
of ``--seconds`` (under ``torch.profiler`` with ``--trace 1``) → the peak
memory → the program's state freed → the comparison with the reference →
the metrics → the guard against JAX → one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # wxbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "skyrim_tpu")


class Run:
    """What one run knows: its cell, inputs, timings, counters and trace,
    handed to the drivers, families and metric readers."""

    def __init__(self, args, bench: dict, root: Path):
        self.args = args
        self.root = root
        self.bench = bench
        self.cell = _entry(bench["workloads"], args.workload, "workload")
        self.config_entry = _entry(bench["configs"], self.cell["config"], "configuration")
        self.cfg = json.loads(_resolve(root, self.config_entry["file"]).read_text())
        self.traffic = json.loads(_find(root, "traffic", self.cell["traffic"] + ".json").read_text())
        limits = _find(root, "limits", args.workload + ".json", required=False)
        self.limits = json.loads(limits.read_text())["limits"] if limits else {}
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = args.device
        self.family = importlib.import_module(f"wxbench.families.{self.cfg['family']}")
        self.driver = importlib.import_module(f"wxbench.drivers.{self.traffic['kind']}")
        self.counters: dict[str, list[float]] = {}  # host-clock readings by name
        self.calls: dict[str, list[dict]] = {}  # each wrapped entry point's calls in the window
        self.steps = 0  # steps (forecast steps or optimizer steps) completed in the window
        self.window_s = float(self.seconds)
        self.profile = None  # harness.trace.Trace of the traced window
        self.checks: dict[str, dict] = {}
        self.state: dict = {}  # the driver's own
        self.phases: list[tuple[str, float]] = []  # set-up phases and their seconds
        self._t_phase = time.time()

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (host clock, device synchronised)."""
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()
        now = time.time()
        self.phases.append((name, now - self._t_phase))
        self._t_phase = now

    def metric_names(self, kind: str) -> list[dict]:
        """This cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
        return [m for m in self.bench[kind] if "workloads" not in m or self.args.workload in m["workloads"]]


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"wxbench: no {what} named {name!r} in BENCHMARK.json")


def _resolve(root: Path, rel: str) -> Path:
    p = (root / rel).resolve()
    if not p.is_relative_to(root.resolve()):
        raise SystemExit(f"wxbench: {rel!r} leads out of the checkout")
    return p


def _find(root: Path, folder: str, name: str, required: bool = True) -> Path | None:
    """``wxbench/<folder>/<name>`` beside the BENCHMARK.json in use, else the
    harness's own."""
    for base in (root / "wxbench", HERE):
        p = base / folder / name
        if p.exists():
            return p
    if required:
        raise SystemExit(f"wxbench: no {folder}/{name}")
    return None


def load_metric(root: Path, name: str):
    path = _find(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"wxbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv):
    ap = argparse.ArgumentParser(prog="wxbench/run.py", description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU dry path of the tests, and an alternative BENCHMARK.json for them
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--benchmark", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def device_report(run: Run, torch) -> dict:
    if run.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(run.cell["chips"]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def main(argv, t_process: float) -> int:
    args = parse(argv)
    root = Path(args.benchmark).resolve().parent if args.benchmark else HERE.parent
    bench_path = Path(args.benchmark) if args.benchmark else root / "BENCHMARK.json"
    if not bench_path.exists():
        print(f"wxbench: no BENCHMARK.json at {bench_path}", file=sys.stderr)
        return 2
    bench = json.loads(bench_path.read_text())
    import torch

    t_torch = time.time()

    if args.device != "cpu":
        chips = _entry(bench["workloads"], args.workload, "workload")["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"wxbench: the cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 3
    try:
        import skyrim_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"wxbench: the port skyrim_tpu_torch is not in this checkout ({e})", file=sys.stderr)
        return 4

    from wxbench.harness import spans, trace

    run = Run(args, bench, root)
    run.phases.append(("interpreter and torch", t_torch - t_process))
    run._t_phase = t_torch
    run.torch_device = torch.device(args.device)
    readers = {m["name"]: load_metric(root, m["name"]) for m in run.metric_names("per_layer" if run.trace else "end_to_end")
               if m["name"] != "setup_s"}
    run.driver.setup(run)
    if run.trace:
        spans.install(run, [s for r in readers.values() for s in getattr(r, "SPANS", ())])
        trace.warm(run)
        run.phase("profiler")
    _sync(run, torch)
    setup_s = time.time() - t_process
    prof = trace.start(run) if run.trace else None
    run.driver.window(run)
    _sync(run, torch)
    if prof is not None:
        run.profile = trace.stop(run, prof)
        spans.uninstall(run)
    device = device_report(run, torch)
    run.driver.release(run)
    if run.device != "cpu":
        torch.cuda.empty_cache()
    run.driver.check(run)
    correct = bool(run.checks) and all(c["value"] <= c["limit"] for c in run.checks.values())

    metrics = {}
    for m in run.metric_names("per_layer" if run.trace else "end_to_end"):
        value = setup_s if m["name"] == "setup_s" else readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"wxbench: the run loaded {', '.join(bad)}: the benchmark may not run JAX or its package",
              file=sys.stderr)
        return 5
    # a failed step raises and ends the run: none is left to count
    line = {"correct": correct, "attempted": run.state.get("attempted", run.steps), "failed": 0,
            "metrics": metrics, "device": device}
    if run.profile is not None:
        device |= {"busy_s": run.profile.busy_s, "window_s": run.profile.window_s}
        line["breakdown"] = run.profile.breakdown
    line["checks"] = run.checks
    print("setup " + ", ".join(f"{n} {s:.3f} s" for n, s in run.phases), file=sys.stderr)
    print(f"window {run.steps} steps, the last done at {run.state.get('last_step_s', 0.0):.3f} s"
          + (f"; trace reduced in {run.state['trace_reduce_s']:.1f} s" if "trace_reduce_s" in run.state else ""),
          file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _sync(run, torch):
    if run.device != "cpu":
        torch.cuda.synchronize()

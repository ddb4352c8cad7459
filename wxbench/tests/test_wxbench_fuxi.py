"""The FuXi cell's files through the harness's CPU dry path: a small FuXi
configuration added as a new configuration file and entries only, beside
``fuxi.forecast_15d`` (``test_wxbench_harness.py`` does the same for Pangu),
runs with ``correct`` true, and planted faults in the timed path
(``fuxi_faults.py``) turn it false."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WX = ROOT / "wxbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "fuxi.forecast_15d"


def _tiny_fuxi(tmp_path: Path) -> tuple[Path, str]:
    """A copy of BENCHMARK.json in ``tmp_path`` with a small FuXi (two blocks
    at C 64 with two heads of 32, three stages of one step) on the cell's
    traffic, added as entries only, and the cell's limits."""
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((WX / "configs" / "fuxi.json").read_text())
    cfg.update(name="tinyfuxi", lat=49, lon=96, in_channels=6, embed_dim=64, depth=2, num_heads=2, stage_steps=1)
    (tmp_path / "wxbench" / "configs").mkdir(parents=True)
    (tmp_path / "wxbench" / "configs" / "tinyfuxi.json").write_text(json.dumps(cfg))
    cell = "tinyfuxi.forecast_15d"
    bench["configs"].append({"name": "tinyfuxi", "source": "a small FuXi", "file": "wxbench/configs/tinyfuxi.json",
                             "reduced": ["lat", "lon", "in_channels", "embed_dim", "depth", "num_heads", "stage_steps"],
                             "why": "the CPU dry path"})
    bench["workloads"].append({"name": cell, "config": "tinyfuxi", "traffic": "forecast_15d", "chips": 1,
                               "why": "dry path"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "wxbench" / "limits").mkdir()
    (tmp_path / "wxbench" / "limits" / f"{cell}.json").write_text((WX / "limits" / f"{CELL}.json").read_text())
    return tmp_path / "BENCHMARK.json", cell


def run_dry(bench: Path, cell: str, seconds: float = 2.0, trace: int = 0, fault: str | None = None):
    cmd = [sys.executable, str(WX / "tests" / "fuxi_faults.py"), str(bench), cell, str(seconds), str(trace),
           fault or "-"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=bench.parent)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_small_run_is_correct(tmp_path, trace):
    bench, cell = _tiny_fuxi(tmp_path)
    rc, line, err = run_dry(bench, cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    added = json.loads(bench.read_text())
    names = {m["name"] for m in added["per_layer" if trace else "end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names and line["metrics"]


@pytest.mark.parametrize("fault", ["unnormalised", "altered"])
def test_planted_fault_is_not_correct(tmp_path, fault):
    bench, cell = _tiny_fuxi(tmp_path)
    rc, line, err = run_dry(bench, cell, fault=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]

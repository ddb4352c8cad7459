"""The benchmark's guards and its data-driven harness, on the CPU.

- nothing under ``wxbench/`` imports JAX, flax or the JAX package, by top-level
  name compared whole (the port ``skyrim_tpu_torch`` begins with the JAX
  package's name); the references import nothing of the port either;
- ``BENCHMARK.json`` keeps to the contract's names, units and keys;
- every cell's configuration, family, traffic, driver, metric readers and
  limits are found by name;
- a cell added as a new configuration file and entries runs through the
  harness's CPU dry path with no other edit, and prints the result line;
- planted faults in the timed path turn ``correct`` false (``faults.py``).
"""

from __future__ import annotations

import ast
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WX = ROOT / "wxbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "skyrim_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(WX.rglob("*.py")), ids=lambda p: str(p.relative_to(WX)))
def test_no_jax_imports(path):
    assert not (_imports(path) & FORBIDDEN), f"{path} imports {_imports(path) & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((WX / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    assert "skyrim_tpu_torch" not in _imports(path)


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["wxbench"] and BENCH["command"] == ["python3", "wxbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    for group in (metric_names, cells, [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("wxbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roof" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(cell in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    from wxbench.harness import core

    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert cfg["name"] == w["config"] and sorted(cfg["reduced"]) == sorted(cfg_entry["reduced"])
    fam = importlib.import_module(f"wxbench.families.{cfg['family']}")
    traffic = json.loads((WX / "traffic" / f"{w['traffic']}.json").read_text())
    driver = importlib.import_module(f"wxbench.drivers.{traffic['kind']}")
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, fn))
    assert hasattr(fam, "build") and hasattr(fam, "forward_flops")
    limits = json.loads((WX / "limits" / f"{cell}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s" and cell in m.get("workloads", [cell]):
            assert callable(core.load_metric(ROOT, m["name"]).read)


def _tiny_pangu(tmp_path: Path, traffic: str) -> tuple[Path, str]:
    """A copy of BENCHMARK.json in ``tmp_path`` with a new small Pangu
    configuration file and one cell on it, added as entries only."""
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((WX / "configs" / "pangu.json").read_text())
    cfg.update(name="tiny", lat=49, lon=96, embed_dim=16, depths=[2, 2, 2, 2], num_heads=[2, 2, 2, 2])
    (tmp_path / "wxbench" / "configs").mkdir(parents=True)
    (tmp_path / "wxbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    cell = f"tiny.{traffic}"
    bench["configs"].append({"name": "tiny", "source": "a small Pangu", "file": "wxbench/configs/tiny.json",
                             "reduced": ["lat", "lon"], "why": "the CPU dry path"})
    bench["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic, "chips": 1, "why": "dry path"})
    kind = json.loads((WX / "traffic" / f"{traffic}.json").read_text())["kind"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(c.endswith(f".{traffic}") for c in m["workloads"]):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "wxbench" / "limits").mkdir()
    limits = WX / "limits" / f"pangu.{traffic}.json"
    (tmp_path / "wxbench" / "limits" / f"{cell}.json").write_text(limits.read_text())
    return tmp_path / "BENCHMARK.json", cell, kind


def run_dry(bench: Path, cell: str, seconds: float = 2.0, trace: int = 0, fault: str | None = None):
    """Run the harness on the CPU in a fresh process, optionally with a
    planted fault; returns (rc, result, stderr)."""
    cmd = [sys.executable, str(WX / "tests" / "faults.py"), str(bench), cell, str(seconds), str(trace), fault or "-"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=bench.parent)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


@pytest.mark.parametrize("traffic,trace", [("forecast_10d", 0), ("forecast_10d", 1), ("finetune_b1", 0)])
def test_new_cell_runs_through_the_dry_path(tmp_path, traffic, trace):
    bench, cell, kind = _tiny_pangu(tmp_path, traffic)
    rc, line, err = run_dry(bench, cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(line)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    added = json.loads(bench.read_text())
    names = {m["name"] for m in added["per_layer" if trace else "end_to_end"] if cell in m.get("workloads", [cell])}
    # device metrics are not read on the CPU; every other metric of the cell is there
    assert set(line["metrics"]) <= names and line["metrics"]
    assert all(c["limit"] > 0 for c in line["checks"].values())
    assert err.rstrip().splitlines()[-1].startswith("check ")
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line


@pytest.mark.parametrize("traffic,fault", [("forecast_10d", "unchanged"), ("forecast_10d", "altered"),
                                           ("finetune_b1", "update_skipped"), ("finetune_b1", "loss_altered")])
def test_planted_fault_is_not_correct(tmp_path, traffic, fault):
    """The run's own comparison, at the small size under the cell's limits,
    refuses each fault the cell can have (one chip and batch 1: no exchange
    between chips, no half batch)."""
    bench, cell, _ = _tiny_pangu(tmp_path, traffic)
    rc, line, err = run_dry(bench, cell, fault=fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("traffic", ["forecast_10d", "finetune_b1"])
def test_sound_small_run_is_correct(tmp_path, traffic):
    bench, cell, _ = _tiny_pangu(tmp_path, traffic)
    rc, line, err = run_dry(bench, cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]


def test_a_run_that_loads_jax_prints_no_result(tmp_path):
    bench, cell, _ = _tiny_pangu(tmp_path, "forecast_10d")
    rc, line, err = run_dry(bench, cell, fault="jax_loaded")
    assert rc != 0 and line is None and "jax" in err


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result, a non-zero exit."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(WX, tmp_path / "wxbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "wxbench/run.py", "--workload", "pangu.forecast_10d", "--seed", "1",
                        "--seconds", "1", "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]

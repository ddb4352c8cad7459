"""The readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

For one cell, on the card, in one process, for each seed: the cell's
set-up, a short window at the cell's load (for a forecast cell long enough
for the first forecast's forty steps and the reservoir's; a finetune cell's
checked steps are its set-up), the program's state freed, then the
driver's ``readings``: every number that ``correct`` compares, for the
program and, on the first ``--control-seeds`` seeds, for the control (the
f32 reference in float8 e4m3, the nearest precision below the
configurations' bf16, in the program's place).

    python3 wxbench/calibrate.py --workload pangu.forecast_10d --seconds 6 --seeds 1 2 3 [--control-seeds 3]

Prints one JSON line a seed and a summary (each number's per-seed worst, its
largest and smallest), also written to
``chiprun_out/wxbench/calibrate_<cell>.json``.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv):
    import argparse
    import json

    import torch

    from wxbench.harness import core

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3, help="how many of the seeds also read the control")
    a = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    rows = []
    for i, seed in enumerate(a.seeds):
        t0 = time.time()
        args = core.parse(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds)])
        run = core.Run(args, bench, ROOT)
        run.torch_device = torch.device("cuda")
        run.driver.setup(run)
        run.driver.window(run)
        torch.cuda.synchronize()
        run.driver.release(run)
        torch.cuda.empty_cache()
        r = run.driver.readings(run, i < a.control_seeds)
        row = {"seed": seed, "steps_in_window": run.steps, "seconds": time.time() - t0, **r}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run
        torch.cuda.empty_cache()
    keys = [k for k in rows[0] if isinstance(rows[0][k], list) and k != "steps"]
    summary = {"workload": a.workload, "card": torch.cuda.get_device_name(0)}
    for k in keys:
        per_seed = [max(r[k]) for r in rows if r[k]]  # a run reads the worst of its checked steps
        summary[k] = {"per_seed_max": per_seed, "max": max(per_seed) if per_seed else None,
                      "min": min(per_seed) if per_seed else None}
    print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out" / "wxbench"
    try:
        out.mkdir(parents=True, exist_ok=True)
        (out / f"calibrate_{a.workload}.json").write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    except OSError:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

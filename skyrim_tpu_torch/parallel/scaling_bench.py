"""Scaling-efficiency harness: grid-points/s across mesh sizes (port of
skyrim_tpu/parallel/scaling_bench.py).

For each size n, n rank processes of this module (the port's one process
a rank, as ``mp_worker``) join a process group through a ``file://``
rendezvous, build a ``(1, 1, n)`` ``Mesh`` and time the sharded rollout
(``sharding.sharded_scan_rollout``, the lon axis sharded); rank 0 reports.
The launcher prints one JSON line:

    python -m skyrim_tpu_torch.parallel.scaling_bench --model pangu --steps 8 [--tiny] [--device cpu]

Ranks that outnumber the cards share them: ``time_sliced`` is then true
in each result and at the top, and the "efficiency" printed measures the
sharing, not scaling.  On the CPU the ranks share the host's cores, which
is always so.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from skyrim_tpu_torch.utils.logging import logger

REPO = Path(__file__).resolve().parents[2]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_sliced(world: int, device: torch.device) -> bool:
    """Whether ``world`` ranks on ``device``'s kind share one device."""
    return device.type == "cpu" or world > torch.cuda.device_count()


def bench_mesh(model, params, mesh, n_steps: int) -> dict:
    """Best of 3 timed sharded rollouts of ``n_steps`` on ``mesh`` (after one
    untimed), every rank calling it alike."""
    import torch.distributed as dist

    from skyrim_tpu_torch.parallel.sharding import shard_state, sharded_scan_rollout

    run = sharded_scan_rollout(model, mesh, n_steps)
    x0 = np.zeros(model.state_shape, np.float32)
    grouped = mesh.size > 1

    def once() -> float:
        state = shard_state(mesh, model.init_state(params, x0))
        _sync(mesh.device)
        if grouped:
            dist.barrier()
        t0 = time.perf_counter()
        _, ys = run(params, state)
        float(ys.float().mean())  # the outputs on the host: the rollout has ended
        if grouped:
            dist.barrier()
        return time.perf_counter() - t0

    once()
    best = min(once() for _ in range(3))
    H, W = model.grid.shape
    gps = H * W * len(model.channels) * n_steps / best
    return {"devices": mesh.size, "wall_s": round(best, 4), "grid_points_per_s": round(gps, 1),
            "mode": run.mode, "grid": [H, W], "time_sliced": time_sliced(mesh.size, mesh.device)}


def add_efficiency(results: list[dict]) -> list[dict]:
    """Annotate each entry with scaling efficiency vs the first entry:
    (gps_N / gps_base) / (N / base_devices) — 1.0 is linear scaling."""
    if not results:
        return results
    base = results[0]
    for r in results[1:]:
        r["scaling_efficiency"] = round(
            (r["grid_points_per_s"] / base["grid_points_per_s"]) / (r["devices"] / base["devices"]), 3)
    return results


def _tiny_model(name: str, device="cuda"):
    """Reduced-config model per family, for runs on the CPU."""
    if name == "pangu":
        from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

        return PanguModel("pangu6", cfg=PanguConfig(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1),
                                                    num_heads=(2, 2, 2, 2)), device=device)
    if name == "fourcastnet_v2":
        from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig

        return FourCastNetV2Model(SFNOConfig(lat=65, lon=128, in_channels=5, embed_dim=32, num_layers=2,
                                             scale_factor=4), device=device)
    if name == "fourcastnet":
        from skyrim_tpu_torch.models.afno import AFNOConfig, FourCastNetModel

        return FourCastNetModel(AFNOConfig(lat=64, lon=128, in_channels=5, patch=8, embed_dim=32, depth=2,
                                           num_blocks=4), device=device)
    raise KeyError(f"no tiny config for {name!r}")


def _model(name: str, tiny: bool, device):
    if tiny:
        return _tiny_model(name, device)
    from skyrim_tpu_torch.models import MODELS

    return MODELS[name](device=device)


def _rank_main(args) -> int:
    """One rank of a launch: the mesh over every rank, the bench, rank 0's
    result written to ``args.out``."""
    import torch.distributed as dist

    from skyrim_tpu_torch.parallel.mesh import make_mesh, maybe_initialize_distributed, process_count

    maybe_initialize_distributed(device=args.device)
    mesh = make_mesh(dp=1, lat=1, lon=process_count(), device=args.device)
    model = _model(args.model, args.tiny, mesh.device)
    # seed-0 parameters, drawn on the card where the ranks run on one (the same on every rank)
    params = model.init_params(torch.Generator(device=mesh.device.type).manual_seed(0))
    r = bench_mesh(model, params, mesh, args.steps)
    if mesh.rank == 0:
        Path(args.out).write_text(json.dumps(r))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def launch(world: int, model: str, n_steps: int, tiny: bool, device: str, timeout_s: float = 600) -> dict:
    """Run ``world`` ranks of this module; returns rank 0's result.  Raises
    with the failed ranks' output if one fails or the launch times out."""
    with tempfile.TemporaryDirectory(prefix="skyrim_scaling_") as tmp:
        out = Path(tmp) / "result.json"
        env = dict(os.environ, SKYRIM_COORDINATOR=f"file://{Path(tmp) / 'rendezvous'}",
                   SKYRIM_NUM_PROCESSES=str(world),
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = env.get("OMP_NUM_THREADS", "1")
        argv = [sys.executable, "-m", "skyrim_tpu_torch.parallel.scaling_bench", "--rank", "--model", model,
                "--steps", str(n_steps), "--device", device, "--out", str(out)] + (["--tiny"] if tiny else [])
        procs = []
        for r in range(world):
            log = open(Path(tmp) / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(argv, cwd=REPO, env=dict(env, SKYRIM_PROCESS_ID=str(r)), stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout_s
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"scaling_bench on {world} ranks failed:\n" + "\n".join(
                f"--- rank {r} ---\n{(Path(tmp) / f'rank{r}.log').read_text()[-3000:]}" for r in failed))
        return json.loads(out.read_text())


def run_scaling(model: str, sizes: list[int], n_steps: int, tiny: bool = False, device: str = "cuda") -> list[dict]:
    results = []
    for size in sizes:
        r = launch(size, model, n_steps, tiny, device)
        results.append(r)
        logger.success("mesh lon=%d: %s", size, r)
    return add_efficiency(results)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("python -m skyrim_tpu_torch.parallel.scaling_bench")
    p.add_argument("--model", default="fourcastnet_v2")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--sizes", default="")
    p.add_argument("--tiny", action="store_true", help="reduced config (CPU development runs)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--json-out", default="", help="also write the result JSON to this path")
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank:
        return _rank_main(args)

    from skyrim_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 2
    sizes = [int(s) for s in args.sizes.split(",") if s] or [s for s in (1, 2, 4, 8) if s <= max(n, 1)]
    results = run_scaling(args.model, sizes, args.steps, args.tiny, args.device)
    sliced = any(r["time_sliced"] for r in results)
    out = {
        "model": args.model,
        "tiny_config": args.tiny,
        "grid": results[0]["grid"],
        "steps": args.steps,
        "platform": dev.type,
        "device_kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "time_sliced": sliced,
        "note": ("ranks share devices (more ranks than cards, or the host's cores): the efficiency measures "
                 "that sharing, not scaling") if sliced else "",
        "results": results,
    }
    line = json.dumps(out)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

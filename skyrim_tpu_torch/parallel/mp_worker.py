"""One rank of a global mesh (port of skyrim_tpu/parallel/mp_worker.py).

N processes, one rank each, join one process group through
``maybe_initialize_distributed``, build ONE mesh over all of them and run
(a) a cross-rank sum and (b) a tiny lon-sharded Pangu stepped by
``sharded_advance`` over ``lon = world``, whose window-cover ring crosses
every process boundary, held to the same model stepped on one process.

Launch (each rank; the ranks meet at the coordinator):

    SKYRIM_COORDINATOR=127.0.0.1:<port> SKYRIM_NUM_PROCESSES=2 \\
    SKYRIM_PROCESS_ID=<r> python -m skyrim_tpu_torch.parallel.mp_worker --device cpu

``--device`` is the card by default (``utils/device.py``); ranks that
share a card exchange through host memory over gloo.  Prints
``mp_worker rank=R ... ok`` per check; exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import sys

#: the sharded steps' largest scale-normalised error, a step
TOL = 1e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from skyrim_tpu_torch.parallel.mesh import AXES, make_mesh, maybe_initialize_distributed, process_count

    maybe_initialize_distributed(device=args.device)
    n = process_count()
    mesh = make_mesh(dp=1, lat=1, lon=n, device=args.device)
    rank = mesh.rank
    print(f"mp_worker rank={rank} procs={n} backend={mesh.backend} device={mesh.device} ok", flush=True)

    # (a) cross-rank reduction: each rank holds one row of x
    x = np.arange(float(n * 3)).reshape(n, 3)
    total = torch.tensor(x[mesh.coords[AXES.lon]].sum(), dtype=torch.float64)
    if n > 1:
        dist.all_reduce(total)
    expect = float(x.sum())
    if float(total) != expect:
        print(f"mp_worker rank={rank} psum {float(total)} != {expect}", flush=True)
        return 1
    print(f"mp_worker rank={rank} psum({expect}) ok", flush=True)

    # (b) tiny Pangu, lon ring over every rank
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
    from skyrim_tpu_torch.parallel.sharding import gather, leaf_spec, shard_state, sharded_advance

    cfg = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
    model = PanguModel("pangu6", cfg=cfg, device=mesh.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)  # masks that differ by column, so a wrong cut shows
    params["consts"] = torch.randn(params["consts"].shape, generator=gen).to(mesh.device)
    ic = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)  # the same on every rank

    advance = sharded_advance(model, mesh)
    state = shard_state(mesh, model.init_state(params, ic))
    local = model.init_state(params, ic)
    worst = 0.0
    for _ in range(args.steps):
        state, y = advance(params, state)
        local, ly = model.advance(params, local)
        y = gather(mesh, y, leaf_spec(mesh, tuple(ly.shape)))
        a, b = ly.float(), y.float()
        worst = max(worst, float((a - b).abs().max() / (a.abs().mean() + 1e-6)))
    mv, lv = float(y.float().mean()), float(ly.float().mean())
    ok = bool(np.isfinite(mv)) and mv != 0.0 and worst <= TOL
    print(f"mp_worker rank={rank} sharded_advance mode={advance.mode} mesh=lon{n} steps={args.steps} "
          f"mean={mv:.4e} parity(local)={lv:.4e} err={worst:.3g} {'ok' if ok else 'MISMATCH'}", flush=True)
    if n > 1:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

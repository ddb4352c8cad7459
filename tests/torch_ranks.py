"""Rank programs of the port's multi-device tests, and their launcher.

tests/test_torch_parallel.py and tests/test_torch_sharded.py start each
program once (``launch``): ``world`` processes of this file, one rank each,
join a gloo group over the CPU through a ``file://`` rendezvous and run
every case of that program; each rank saves its results to
``<workdir>/<program>/rank<r>.pt``.  The tests compute the JAX references
in their own process.  This file imports no JAX.

Every rank runs single-threaded (tier-1 runs six test workers at once);
a launch has a wall-clock limit and the group a collective timeout, so
a hung rank fails its test instead of the suite.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 110  # the whole launch, every rank
GROUP_TIMEOUT_S = 60  # a collective or the rendezvous

# --- the cases (the tests import these tables) ---------------------------------------

RING_EXTENTS = ((2, 3), (5, 0), (0, 7), (11, 18))  # left, right at n 4, Wl 6
RING_SHIFTS = (-5, -1, 0, 3, 6)
BLOCK_SHIFTS = ((0, 0, 0), (1, 3, 6), (0, 2, 6))
BLOCK_GEOMETRY = dict(Z=2, H=6, C=8, window=(2, 6, 12), heads=2)
# global lon tokens: 24 (JAX's case: a cover is the whole ring), 72 (covers cut
# from the ring, window-aligned chunks at n 2 and 18-token chunks at n 4, as at
# Pangu's full width)
BLOCK_WIDTHS = (24, 72)
# (mesh, halo_lat, halo_lon): both axes exchanged, and each one-rank axis handled locally
HALO_CASES = (((1, 2, 2), 1, 0), ((1, 2, 2), 0, 2), ((1, 1, 4), 1, 0), ((1, 4, 1), 0, 2))
HALO_SHAPE = (16, 16)
SPEC_SHAPES = ((2, 69, 49, 96), (1, 4, 19, 36), (2, 7, 721, 1440), (3, 5, 65, 128), (5, 9), (8,),
               (2, 1, 3, 17, 32))
SPEC_BASES = ((None, None, "lat", "lon"), ("dp", None, None, "lat", "lon"), ("lon",))
FAULTS = ("wrong_neighbour", "cover_offset")  # planted in manual_swin_block at n 4, shift (1, 3, 6)
FAMILY_NAMES = ("dlwp", "fengwu", "fourcastnet", "fourcastnet_v2", "fuxi", "fuxi_v2", "graphcast", "pangu")
ENSEMBLE_MEMBERS = (2, 3)  # split over dp; 3 does not divide, so every dp rank runs all


def family(name: str):
    """The port's counterpart of tests/parallel/test_all_models_sharded.py's
    FAMILIES entry ``name``, on the CPU."""
    cpu = dict(device="cpu")
    if name == "pangu":
        from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

        return PanguModel("pangu", cfg=PanguConfig(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1),
                                                   num_heads=(2, 2, 2, 2)), **cpu)
    if name == "fourcastnet":
        from skyrim_tpu_torch.models.afno import AFNOConfig, FourCastNetModel

        return FourCastNetModel(AFNOConfig(lat=64, lon=128, in_channels=5, patch=8, embed_dim=32, depth=2,
                                           num_blocks=4), **cpu)
    if name == "fourcastnet_v2":
        from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig

        return FourCastNetV2Model(SFNOConfig(lat=65, lon=128, in_channels=5, embed_dim=32, num_layers=2,
                                             scale_factor=4), **cpu)
    if name in ("fuxi", "fuxi_v2"):
        from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

        return FuXiModel(FuXiConfig(lat=49, lon=96, in_channels=6, embed_dim=32, depth=2, num_heads=2,
                                    stage_steps=2, n_stages=3, attn_v2=name == "fuxi_v2"), **cpu)
    if name == "fengwu":
        from skyrim_tpu_torch.models.fengwu import FengWuConfig, FengWuModel

        return FengWuModel(FengWuConfig(lat=49, lon=96, levels=3, surface_channels=2, level_vars=2, modal_dim=8,
                                        fuser_dim=24, depth=2, num_heads=2), **cpu)
    if name == "graphcast":
        from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

        return GraphCastModel(GraphCastConfig(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2,
                                              mesh_refinements=2), **cpu)
    if name == "dlwp":
        from skyrim_tpu_torch.models.dlwp import DLWPModel

        return DLWPModel(face_size=16, features=(8, 16), **cpu)
    raise KeyError(name)


# --- the launcher ---------------------------------------------------------------------


def run_ranks(argv: list, world: int, workdir: Path) -> list[str]:
    """Run ``python argv`` as ``world`` ranks that meet at a ``file://``
    rendezvous in ``workdir``; returns each rank's output.  Raises with the
    output of the failed ranks if one exits non-zero or the launch outlasts
    LAUNCH_TIMEOUT_S (every rank is then killed)."""
    workdir = Path(workdir)
    env = dict(os.environ, SKYRIM_COORDINATOR=f"file://{workdir / 'rendezvous'}", SKYRIM_NUM_PROCESSES=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, *argv], cwd=REPO, env=dict(env, SKYRIM_PROCESS_ID=str(r)),
                                       stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
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
    logs = [(workdir / f"rank{r}.log").read_text() for r in range(world)]
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{argv} on {world} ranks failed:\n" + "\n".join(
            f"--- rank {r} (exit {procs[r][0].returncode}) ---\n{logs[r][-3000:]}" for r in failed))
    return logs


def launch(program: str, world: int, workdir: Path) -> list:
    """Run ``program`` of this file on ``world`` ranks, reading its inputs
    from ``workdir``; returns each rank's results.  The launch's rendezvous,
    logs and results go to ``workdir/<program>``, so one set of inputs
    serves several programs."""
    rundir = Path(workdir) / program
    rundir.mkdir()
    run_ranks([__file__, program, str(workdir)], world, rundir)
    return [torch.load(rundir / f"rank{r}.pt", weights_only=False) for r in range(world)]


# --- the programs ---------------------------------------------------------------------


def _block_args(w):
    return (w["ln1"], w["qkv"], w["bias"], w["mask"], w["proj"], w["ln2"], w["mlp"])


def _blocks(mesh, inputs, out, faults=False):
    """manual_swin_block at every BLOCK_WIDTHS width and BLOCK_SHIFTS shift on
    this world's lon ring, gathered; rank 0 also runs the port's reference.
    With ``faults``, each of FAULTS planted at shift (1, 3, 6)."""
    from skyrim_tpu_torch.parallel import fused_shard as FS
    from skyrim_tpu_torch.parallel.sharding import gather, shard

    g = BLOCK_GEOMETRY
    n = mesh.shape["lon"]
    spec = (None, None, "lon", None)

    def block(w, shift):
        with FS.lon_manual(mesh):
            y = FS.manual_swin_block(shard(mesh, w["x"], spec), *_block_args(w), g["window"], g["heads"], shift)
        return gather(mesh, y, spec)

    for W in BLOCK_WIDTHS:
        for shift in BLOCK_SHIFTS:
            w = inputs["blocks"][W, shift]
            out[("block", n, W, shift)] = block(w, shift)
            if mesh.rank == 0:
                out[("block_ref", n, W, shift)] = FS.reference_manual_swin_block(
                    w["x"], *_block_args(w), g["window"], g["heads"], shift)
        if not faults:
            continue
        w = inputs["blocks"][W, (1, 3, 6)]
        real_exchange, real_offset = FS.ring_exchange, FS.cover_offset
        for fault in FAULTS:
            if fault == "wrong_neighbour":  # every halo from the other side of the ring
                FS.ring_exchange = lambda m, axis, sends: real_exchange(m, axis, [(t, -h) for t, h in sends])
            else:  # the cover one token off
                FS.cover_offset = lambda start, s2, ww: (real_offset(start, s2, ww) + 1) % ww
            try:
                out[("fault", W, fault)] = block(w, (1, 3, 6))
            finally:
                FS.ring_exchange, FS.cover_offset = real_exchange, real_offset


def program_parallel(workdir: Path) -> dict:
    """The ring, halo, mesh and block cases of this world (2 or 4 ranks)."""
    from skyrim_tpu_torch.parallel import fused_shard as FS
    from skyrim_tpu_torch.parallel.halo import halo_pad
    from skyrim_tpu_torch.parallel.mesh import AXES, make_mesh, process_count
    from skyrim_tpu_torch.parallel.sharding import compatible_spec, gather, shard

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    world = process_count()
    out = {}
    ring = make_mesh(1, 1, world, device="cpu")
    _blocks(ring, inputs, out, faults=world == 4)
    if world != 4:
        return out

    wild = make_mesh(dp=2, lat=-1, lon=1, device="cpu")
    out["wildcard"] = dict(wild.shape)
    for sizes in ((3, 1, 1), (-1, -1, 1), (2, 3, -1)):
        try:
            make_mesh(*sizes, device="cpu")
            out[("mesh_error", sizes)] = None
        except ValueError as e:
            out[("mesh_error", sizes)] = str(e)
    grid = make_mesh(2, 1, 2, device="cpu")
    out["coords"], out["members"] = grid.coords, grid.members
    for shape in SPEC_SHAPES:
        for base in SPEC_BASES:
            out[("spec", shape, base)] = compatible_spec(shape, grid, base)

    # the ring ops at n 4, Wl 6, on one row of 24 lon tokens
    x = torch.arange(24, dtype=torch.float32).reshape(1, 24)
    with FS.lon_manual(ring):
        xl = shard(ring, x, (None, AXES.lon))
        for left, right in RING_EXTENTS:
            ext = FS.ring_extend(xl, left, right, axis=1)
            out[("ring_extend", left, right)] = gather(ring, ext.contiguous(), (None, AXES.lon))
        for s in RING_SHIFTS:
            out[("ring_roll", s)] = gather(ring, FS.ring_roll(xl, s, axis=1).contiguous(), (None, AXES.lon))
        g = torch.arange(3 * 24, dtype=torch.float32).reshape(3, 24)
        out["local_lon_slice"] = gather(ring, FS.local_lon_slice(g, axis=-1).contiguous(), (None, AXES.lon))
    assert FS.local_lon_slice(g, axis=-1) is g  # outside a region: the array itself

    meshes = {}
    H, W = HALO_SHAPE
    field = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    for sizes, hl, hw in HALO_CASES:
        mesh = meshes[sizes] = meshes.get(sizes) or make_mesh(*sizes, device="cpu")
        padded = halo_pad(shard(mesh, field, (AXES.lat, AXES.lon)), mesh, halo_lat=hl, halo_lon=hw)
        out[("halo", sizes, hl, hw)] = gather(mesh, padded, (AXES.lat, AXES.lon))
    return out


def program_families(workdir: Path) -> dict:
    """The eight families over (2, 1, 2) in f32."""
    from skyrim_tpu_torch.parallel.mesh import make_mesh
    from skyrim_tpu_torch.parallel.sharding import gather, leaf_spec, shard_state, sharded_scan_rollout

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_mesh(2, 1, 2, device="cpu")
    out = {}
    for name in FAMILY_NAMES:
        model = family(name)
        model.compute_dtype = torch.float32
        params = torch.load(workdir / f"params_{name}.pt", weights_only=False)
        run = sharded_scan_rollout(model, mesh, n_steps=2)
        _, ys = run(params, shard_state(mesh, model.init_state(params, inputs["x0"][name])))
        ys = gather(mesh, ys, leaf_spec(mesh, (*ys.shape[:-2], *model.grid.shape)))
        out[("family", name)] = (run.mode, ys if mesh.rank == 0 else None)
    return out


def program_ensembles(workdir: Path) -> dict:
    """dp_ensemble_rollout and ic_ensemble_forecast of the tiny Pangu over
    (2, 1, 2) and without a mesh."""
    from skyrim_tpu_torch.core.ic_ensemble import ic_ensemble_forecast
    from skyrim_tpu_torch.parallel.mesh import make_mesh
    from skyrim_tpu_torch.parallel.sharding import dp_ensemble_rollout

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_mesh(2, 1, 2, device="cpu")
    out = {}
    model = family("pangu")
    params = torch.load(workdir / "params_pangu.pt", weights_only=False)
    for b in ENSEMBLE_MEMBERS:
        ics = inputs["members"][:b]
        out[("dp_ensemble", b)] = (dp_ensemble_rollout(model, mesh, 2)(params, ics),
                                   dp_ensemble_rollout(model, None, 2)(params, ics))
    kw = dict(n_steps=2, n_members=2, perturb_scale=0.05, ic_source="synthetic",
              model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    t0 = inputs["start"]
    meshed = ic_ensemble_forecast("pangu", t0, mesh=mesh, **kw)
    alone = ic_ensemble_forecast("pangu", t0, **kw)
    out["ic_ensemble"] = (meshed.data, alone.data, meshed.dims == alone.dims and meshed.attrs == alone.attrs)
    return out


PROGRAMS = {"parallel": program_parallel, "families": program_families, "ensembles": program_ensembles}


def main() -> int:
    import torch.distributed as dist

    from skyrim_tpu_torch.parallel.mesh import maybe_initialize_distributed

    program, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = PROGRAMS[program](workdir)
    torch.save(out, workdir / program / f"rank{dist.get_rank()}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (skyrim_tpu_torch) on one card and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. build every kernel from skyrim_tpu_torch/csrc (one nvcc per source,
     all at once) and print the seconds;
  3. each kernel at the full-width Pangu shapes in bf16 (K1 at stage 1 and
     stage 2, shifted, and its window attention alone with a strong earth
     bias; K2 at both shapes; K3; K4) against its plain PyTorch version on
     the card, timed with CUDA events beside the plain version and, for
     K2, torch.roll;
  4. the main path: GlobalModel("pangu", ic_source="synthetic") at
     721x1440 and full width with seeded random weights, a 4-step
     forecast with every launch count set to 0 just before and read just
     after (16 K1, 16 K2, 1 K3, 1 K4 per forward); then rollout(save=True)
     for 2 steps into a temporary directory and a reload of the files;
  5. the small test configuration on the card (kernels) against the CPU
     (plain versions).

Prints {"kernels": [...]} on a line of its own, then as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, on
any failure, without a CUDA device, or outside a checkout of the repo.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
# kernel vs plain on the card: bf16 rounding of intermediates (the residual
# stream above all) and summation order differ, so elementwise
# |kernel - plain| <= 2e-2 * std(plain) + 2 bf16 ulps of max|plain|
# (2 * 2**-8 * max|plain|); the roll is exact
TOL_STD, TOL_ULPS = 2e-2, 2 * 2.0**-8
# K1's window attention alone: its earth bias is drawn at 0.5 (as in
# tests/test_torch_ops.py), so a missing or misindexed bias table moves the
# output well past the same tolerance, measured on the attention output itself
ATTN_BIAS_SCALE = 0.5
# small config, card vs CPU over a 4-step rollout: the golden tolerance of
# tests/test_golden.py (3e-2 * std for mean and spread, 10x for single values)
GOLDEN = 3e-2


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, out, ref, name: str, exact: bool = False) -> float:
    out, ref = out.float(), ref.float()
    check(tuple(out.shape) == tuple(ref.shape), f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = (out - ref).abs()
    max_err = float(err.max())
    if exact:
        check(max_err == 0.0, f"{name}: not exact, max err {max_err}")
    else:
        tol = TOL_STD * ref.std() + TOL_ULPS * ref.abs().max()
        check(bool((err <= tol).all()), f"{name}: max err {max_err:.4g} over tolerance (std {float(ref.std()):.4g})")
    return max_err


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_checks(torch, g) -> tuple[list[dict], dict]:
    """Phase 3: every kernel at its main-path shapes against its plain version.
    Returns the kernels' rows and the max errors of the attention-alone checks."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops import roll as RL
    from skyrim_tpu_torch.ops.windows import shift_attention_mask, window_partition, window_reverse

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    window = (2, 6, 12)
    wlen = 144
    rows = []
    attn_err = {}
    stages = (("stage 1/4", (8, 186, 360, 192, 6, 181)), ("stage 2/3", (8, 96, 180, 384, 12, 91)))

    # K1 at both Pangu widths, shifted blocks (mask on every stage)
    for stage, (Z, H, Wd, C, heads, valid_h) in stages:
        nz, nh, nw = Z // 2, H // 6, Wd // 12
        hidden = 4 * C
        mask = torch.from_numpy(shift_attention_mask((Z, H, Wd), window, (1, 3, 6), (Z, valid_h, Wd))).to(dev)

        # the window attention alone, all nz*nh bias types, bias at 0.5
        qkv = randn(Z, H, Wd, 3 * C, dtype=bf16)
        bias = randn(nz * nh, heads, wlen, wlen, scale=ATTN_BIAS_SCALE)
        out = FB.window_attention(qkv, bias, mask, window, heads)
        torch.cuda.synchronize()
        ref = window_reverse(
            FB.reference_window_attention_qkv(window_partition(qkv, window), bias, mask, nw, heads),
            window, (Z, H, Wd),
        )
        attn_err[stage] = compare(torch, out, ref, f"K1 window attention {stage}")
        del qkv, bias, out, ref
        torch.cuda.empty_cache()

        x = randn(Z, H, Wd, C, dtype=bf16)
        args = (
            x,
            (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)),
            randn(nz * nh, heads, wlen, wlen, scale=0.02),
            mask,
            (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)),
            (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1),
             randn(hidden, C, scale=hidden**-0.5), randn(C, scale=0.1)),
        )
        out = FB.fused_swin_block(*args, window, heads)
        torch.cuda.synchronize()
        ref = FB.reference_swin_block(*args, window, heads)
        err = compare(torch, out, ref, f"K1 {stage}")
        del out, ref
        N = Z * H * Wd
        flops = 2 * N * C * (4 * C + 2 * hidden) + 4 * (nz * nh * nw) * heads * wlen * wlen * (C // heads)
        nbytes = 2 * N * C * 2 + 2 * C * (4 * C + 2 * hidden) + args[3].numel() * 4 + args[4].numel() * 4
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(
            name=f"K1 fused_swin_block {stage} {tuple(x.shape)}", shape=tuple(x.shape),
            route="cuda", source="skyrim_tpu_torch/csrc/fused_block.cu+gemm.cu",
            replaces="skyrim_tpu/ops/fused_block.py:202", max_abs_err=err,
            ms=time_ms(torch, lambda: FB.fused_swin_block(*args, window, heads), 10),
            plain_ms=time_ms(torch, lambda: FB.reference_swin_block(*args, window, heads), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        del args, x, mask
        torch.cuda.empty_cache()

    # K2 at both Pangu widths (the shifted blocks' frame change)
    s = (1, 3, 6)
    for stage, (Z, H, Wd, C, _, _) in stages:
        x = randn(Z, H, Wd, C, dtype=bf16)
        err = compare(torch, RL.roll3d(x, s), RL.plain_roll3d(x, s), f"K2 roll3d {stage}", exact=True)
        b_ms, b_by = bound(0, 2 * x.numel() * 2)
        rows.append(dict(
            name=f"K2 roll3d {stage} {tuple(x.shape)}", shape=tuple(x.shape), route="cuda",
            source="skyrim_tpu_torch/csrc/roll.cu", replaces="skyrim_tpu/ops/roll.py:34", max_abs_err=err,
            ms=time_ms(torch, lambda: RL.roll3d(x, s), 20),
            plain_ms=time_ms(torch, lambda: RL.plain_roll3d(x, s), 20),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda: torch.roll(x, (-1, -3, -6), (0, 1, 2)), 20),
        ))
        del x

    # K3: (8, 182, 360, 192) -> (8, 91, 180, 384)
    C, Co = 192, 384
    x = randn(8, 182, 360, C, dtype=bf16)
    ln = (1 + randn(4 * C, scale=0.1), randn(4 * C, scale=0.1))
    wb = (randn(4 * C, Co, scale=(4 * C) ** -0.5), randn(Co, scale=0.1))
    err = compare(torch, RS.fused_downsample(x, ln, wb), RS.reference_downsample(x, ln, wb), "K3 fused_downsample")
    M = 8 * 91 * 180
    b_ms, b_by = bound(2 * M * 4 * C * Co, x.numel() * 2 + M * Co * 2 + 4 * C * Co * 2)
    rows.append(dict(
        name="K3 fused_downsample (8, 182, 360, 192)", shape=None, route="cuda",
        source="skyrim_tpu_torch/csrc/resample.cu+gemm.cu",
        replaces="skyrim_tpu/ops/resample.py:111", max_abs_err=err,
        ms=time_ms(torch, lambda: RS.fused_downsample(x, ln, wb), 20),
        plain_ms=time_ms(torch, lambda: RS.reference_downsample(x, ln, wb), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del x

    # K4: (8, 91, 180, 384) -> (8, 182, 360, 192)
    x = randn(8, 91, 180, Co, dtype=bf16)
    wb = (randn(Co, 4 * C, scale=Co**-0.5), randn(4 * C, scale=0.1))
    ln = (1 + randn(C, scale=0.1), randn(C, scale=0.1))
    err = compare(torch, RS.fused_upsample(x, wb, ln), RS.reference_upsample(x, wb, ln), "K4 fused_upsample")
    b_ms, b_by = bound(2 * M * Co * 4 * C, x.numel() * 2 + M * 4 * C * 2 + Co * 4 * C * 2)
    rows.append(dict(
        name="K4 fused_upsample (8, 91, 180, 384)", shape=None, route="cuda",
        source="skyrim_tpu_torch/csrc/resample.cu+gemm.cu",
        replaces="skyrim_tpu/ops/resample.py:220", max_abs_err=err,
        ms=time_ms(torch, lambda: RS.fused_upsample(x, wb, ln), 20),
        plain_ms=time_ms(torch, lambda: RS.reference_upsample(x, wb, ln), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del x
    torch.cuda.empty_cache()
    return rows, attn_err


def counters():
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops import roll as RL
    from skyrim_tpu_torch.ops.gemm import gemm

    return {"K1": FB.fused_swin_block, "K2": RL.roll3d, "K3": RS.fused_downsample,
            "K4": RS.fused_upsample, "gemm": gemm}


BY_SHAPE = ("K1", "K2")  # kernels that run at both block widths


def reset_counts() -> None:
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    for k in BY_SHAPE:
        fns[k].launches_by_shape.clear()


def main_path(torch) -> dict:
    """Phase 4: the full-width Pangu forecast through GlobalModel."""
    import numpy as np

    from skyrim_tpu_torch.core import GlobalModel
    from skyrim_tpu_torch.io import SaveConfig, load_forecast

    t0 = time.perf_counter()
    gm = GlobalModel("pangu", ic_source="synthetic", seed=0, device="cuda")
    setup_s = time.perf_counter() - t0
    start = datetime.datetime(2024, 1, 1, 0)
    n_steps = 4

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fc = gm.forecast(start, n_steps=n_steps)
    torch.cuda.synchronize()
    forecast_s = time.perf_counter() - t0
    fns = counters()
    counts = {k: fn.launches for k, fn in fns.items()}
    by_shape = {k: {tuple(s): v for s, v in fns[k].launches_by_shape.items()} for k in BY_SHAPE}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path: forecast of {n_steps} steps in {forecast_s:.2f} s, launches {counts}, "
        f"by shape {by_shape}, peak {peak_gb:.2f} GB allocated")
    expect = {"K1": 16 * n_steps, "K2": 16 * n_steps, "K3": n_steps, "K4": n_steps}
    for k, v in expect.items():
        check(counts[k] == v, f"main path launched {k} {counts[k]} times, expected {v}")
    # per forward: 4 blocks (and rolls) at stage 1/4, 12 at stage 2/3
    expect_shape = {(8, 186, 360, 192): 4 * n_steps, (8, 96, 180, 384): 12 * n_steps}
    for k in BY_SHAPE:
        check(by_shape[k] == expect_shape, f"main path launched {k} by shape {by_shape[k]}, expected {expect_shape}")
    check(fc.data.shape == (n_steps + 1, 69, 721, 1440), f"forecast shape {fc.data.shape}")
    check(bool(np.isfinite(fc.data).all()), "forecast has non-finite values")
    check(float(np.abs(fc.data[1:] - fc.data[:1]).max()) > 0, "forecast did not change the state")

    # per-step device time of the same advance the forecast ran
    model, params = gm.model, gm.params
    state = model.init_state(params, fc.data[0], start_time=start)
    step_ms = []
    for _ in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = model.advance(params, state)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    log(f"main path: per-step ms {['%.2f' % t for t in step_ms]} (step 4 is the 24h net)")
    profile = profile_step(torch, model, params, state)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = SaveConfig(forecast_id="smoke", output_dir=tmp)
        last, paths = gm.rollout(start, n_steps=2, save=True, save_config=cfg)
        check(len(paths) == 2, f"rollout saved {len(paths)} files")
        for i, p in enumerate(paths):
            f = load_forecast(p)
            check(f.data.shape == (1, 69, 721, 1440), f"reloaded {p}: shape {f.data.shape}")
            check(bool(np.isfinite(f.data).all()), f"reloaded {p}: non-finite")
            # the same kernels on the same IC: the saved steps are the forecast's
            diff = float(np.abs(f.data[0] - fc.data[i + 1]).max())
            check(diff <= 1e-3 * float(np.abs(fc.data[i + 1]).max()), f"saved step {i + 1} differs from forecast by {diff}")
        np.testing.assert_array_equal(load_forecast(paths[-1]).data, last.data)
        log(f"main path: rollout saved {[Path(p).name for p in paths]} and reloaded them")
    return dict(counts=counts, by_shape=by_shape, setup_s=setup_s, forecast_s=forecast_s,
                step_ms=step_ms, peak_gb=peak_gb, profile=profile)


def profile_step(torch, model, params, state) -> dict:
    """Device time by kernel over one 6h step, and the device's idle share
    of the step's host wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.advance(params, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key[:80]] = getattr(e, "device_time_total", 0.0) / 1e3
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None, "idle_share": None, "top": []}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"profile: {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {name}")
    idle = 1 - busy_ms / wall_ms
    log(f"profile: step wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share {idle:.3f}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": idle,
            "top": [[n, ms] for n, ms in top]}


def small_config(torch) -> dict:
    """Phase 5: the CPU tests' configuration, card (kernels) vs CPU (plain)."""
    import numpy as np

    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
    from skyrim_tpu_torch.rollout import scan_rollout

    cfg = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
    x = np.random.default_rng(0).normal(size=(69, 49, 96)).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        model = PanguModel("pangu", cfg=cfg, device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        reset_counts()
        _, ys = scan_rollout(model, params, model.init_state(params, x), 4)
        outs[device] = ys.float().cpu().numpy()
        if device == "cuda":
            check(counters()["K1"].launches == 32, "small config did not run K1 on the card")
    worst = 0.0
    for step in range(4):
        ref, out = outs["cpu"][step].astype(np.float64), outs["cuda"][step].astype(np.float64)
        tol = GOLDEN * ref.std()
        d = out - ref
        check(abs(out.mean() - ref.mean()) < tol and abs(out.std() - ref.std()) < tol,
              f"small config step {step + 1}: mean/std differ beyond {tol:.3g}")
        check(float(np.sqrt((d**2).mean())) < tol, f"small config step {step + 1}: rms diff over {tol:.3g}")
        check(float(np.abs(d).max()) < 10 * tol, f"small config step {step + 1}: max diff over {10 * tol:.3g}")
        worst = max(worst, float(np.abs(d).max() / ref.std()))
    log(f"small config: card vs CPU over 4 steps, worst max|diff|/std = {worst:.4f}")
    return dict(worst_max_over_std=worst)


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "skyrim_tpu_torch" / "csrc").is_dir():
        log("chip_smoke: run from the root of a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain references run in full f32
    torch.backends.cudnn.allow_tf32 = False

    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(smi, flush=True)

        # 2. build
        from skyrim_tpu_torch.ops import _build

        build_s = _build.build()
        log(f"build: {len(_build.LIBS)} libraries in {build_s:.1f} s")

        # 3. kernels against their plain versions at full width
        g = torch.Generator(device="cuda").manual_seed(0)
        rows, attn_err = kernel_checks(torch, g)
        log(f"K1 window attention alone, earth bias at {ATTN_BIAS_SCALE}: max_abs_err {attn_err}")
        for r in rows:
            log(f"kernel {r['name']}: ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                f"bound {r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err {r['max_abs_err']:.4g}")

        # 4. the main path
        mp = main_path(torch)
        for r in rows:
            key, shape = r["name"].split()[0], r.pop("shape")
            r["launches"] = mp["by_shape"][key].get(shape, 0) if key in BY_SHAPE else mp["counts"][key]
            check(r["launches"] > 0, f"{r['name']} was not launched on the main path")

        # 5. small configuration, card vs CPU
        small = small_config(torch)
    except Exception as e:  # every failure ends the run without a result
        log(f"chip_smoke: FAILED: {type(e).__name__}: {e}")
        import traceback

        traceback.print_exc()
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "main_path": {k: mp[k] for k in ("setup_s", "forecast_s", "step_ms", "peak_gb", "profile")},
        "small_config": small,
        "attention_alone_max_abs_err": attn_err,
        "build_s": build_s,
    }), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Traffic kind ``forecast``: forecasts back to back, one client, a closed loop.

Each forecast starts from the next IC of a seeded pool made in host memory
at set-up, enters through ``model.init_state(params, ic, start_time=...)``
as ``GlobalModel`` feeds it, and runs ``stream_rollout`` for
``steps_per_forecast`` steps, every output in full carried to pinned host
memory.  The host takes each frame and drops it, as a forecast writer
hands it on.  A step counts when its output is in host memory inside the
window; a forecast cut off at the window's end counts the steps it
finished.

Parameters (``traffic/<name>.json``): ``steps_per_forecast``, ``ic_pool``,
``warmup_steps`` (one forecast of that many steps in set-up, through the
same path), ``start_dates`` (the first IC's date and the days between the
pool's dates), and ``check``: which steps the reference recomputes once
the window has closed.  ``check`` takes the first forecast's first step
(from the IC) and last step, and ``per_forecast`` seeded steps of
``reservoir`` forecasts drawn from the seed among all that the window
reached (a reservoir sample, so a late forecast is as likely as an early
one).  Each checked step is recomputed by the reference from the frames
that the program itself produced before it (the IC for the first), so the
comparison is of one step at a time.
"""

from __future__ import annotations

import collections
import datetime
import time

import numpy as np
import torch

from wxbench.harness import compare, draw


def setup(run) -> None:
    import skyrim_tpu_torch.rollout as rollout

    tr, fam, dev = run.traffic, run.family, run.torch_device
    run.state["rollout"] = rollout
    phase = run.phase
    phase("device query and the port's modules")
    model, params, weights = fam.build(run.cfg, dev, run.seed)
    phase("model and weights")
    run.state.update(model=model, params=params, weights=weights)
    # the IC pool, drawn on the device in the configuration's physical units
    gen = draw.generator(dev, run.seed, "ics")
    mean, std = weights["norm.mean"].to(dev), weights["norm.std"].to(dev)
    n_hist = fam.N_HISTORY
    shape = (n_hist, mean.shape[0], run.cfg["lat"], run.cfg["lon"])
    pool = []
    for _ in range(tr["ic_pool"]):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).mul_(std).add_(mean)
        pool.append(x.cpu().numpy())
    d0 = datetime.datetime.fromisoformat(tr["start_dates"]["first"]).replace(tzinfo=datetime.timezone.utc)
    rng = np.random.default_rng(draw.sub_seed(run.seed, "dates"))
    days = rng.integers(0, tr["start_dates"]["span_days"], tr["ic_pool"])
    phase("IC pool")
    run.state["pool"] = pool
    run.state["dates"] = [d0 + datetime.timedelta(days=int(d)) for d in days]
    # warm-up: one short forecast through the same path, holding as many
    # frames as the check may, so pinned host buffers are grown here
    held = []
    state = model.init_state(params, pool[0], start_time=run.state["dates"][0])
    for frame in rollout.stream_rollout(model, params, state, tr["warmup_steps"]):
        held.append(frame)
    extra = _max_held(tr, fam) - len(held)
    if extra > 0:
        held += [torch.empty(shape[1:], pin_memory=run.device != "cpu").numpy() for _ in range(extra)]
    del held
    phase("warm-up")


def _max_held(tr, fam) -> int:
    """Pinned frames a window may hold at once: the history the check reads,
    two in flight, and each checked step's inputs and output."""
    ck = tr["check"]
    checks = 2 + ck["reservoir"] * ck["per_forecast"]
    return fam.FRAMES_BACK + 2 + checks * (fam.N_HISTORY + 1)


class _Sample:
    """The checked steps of one forecast: step → (input frames, output)."""

    def __init__(self, ic: int, steps: set[int]):
        self.ic, self.steps, self.got = ic, steps, {}


def _steps_to_check(run, f: int, n: int, first: bool) -> set[int]:
    ck = run.traffic["check"]
    if first:
        return {0, n - 1}
    rng = np.random.default_rng(draw.sub_seed(run.seed, f"check/{f}"))
    return set(int(s) for s in rng.choice(n, size=min(ck["per_forecast"], n), replace=False))


def window(run) -> None:
    tr, st, fam = run.traffic, run.state, run.family
    model, params, pool, dates = st["model"], st["params"], st["pool"], st["dates"]
    rollout = st["rollout"]
    n = tr["steps_per_forecast"]
    ck = tr["check"]
    rng = np.random.default_rng(draw.sub_seed(run.seed, "reservoir"))
    latencies, uploads = [], []
    first_sample, reservoir = None, []
    recent = collections.deque(maxlen=fam.FRAMES_BACK)
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    f = 0
    done = False
    trace = run.trace
    while not done:
        ic_i = f % len(pool)
        ic = pool[ic_i]
        if f == 0:
            sample = first_sample = _Sample(ic_i, _steps_to_check(run, f, n, True))
        elif f <= ck["reservoir"]:
            sample = _Sample(ic_i, _steps_to_check(run, f, n, False))
            reservoir.append(sample)
        else:
            j = int(rng.integers(0, f))
            sample = None
            if j < ck["reservoir"]:
                sample = reservoir[j] = _Sample(ic_i, _steps_to_check(run, f, n, False))
        t_prev = time.perf_counter()
        if trace:
            from torch.profiler import record_function

            with record_function("wx.init_state"):
                state = model.init_state(params, ic, start_time=dates[ic_i])
                if run.device != "cpu":
                    torch.cuda.synchronize()
            uploads.append(time.perf_counter() - t_prev)
        else:
            state = model.init_state(params, ic, start_time=dates[ic_i])
        recent.clear()
        gen = rollout.stream_rollout(model, params, state, n)
        for k, frame in enumerate(gen):
            t = time.perf_counter()
            if t > t_end:
                done = True
                break
            latencies.append(t - t_prev)
            t_prev = t
            _ = frame[0, 0, 0]  # the writer takes the frame
            if sample is not None and k in sample.steps:
                # the IC's frames (j < 0: −1 the newest) or the outputs held since
                ins = [ic[j] if j < 0 else recent[j - k] for j in fam.step_inputs(k)]
                sample.got[k] = (ins, frame)
            recent.append(frame)
        gen.close()
        if not done:
            f += 1
    run.steps = len(latencies)
    run.window_s = float(run.seconds)
    st["latencies"] = latencies
    st["attempted"] = len(latencies)
    st["forecasts"] = f
    run.counters["ic_upload_s"] = uploads
    st["samples"] = [s for s in [first_sample, *reservoir] if s is not None and s.got]
    st["last_step_s"] = sum(latencies)


def release(run) -> None:
    st = run.state
    for key in ("model", "params"):
        st.pop(key, None)


def readings(run, control: bool = False) -> dict:
    """Each sampled step recomputed by the f32 reference, the program's
    ``step_err`` against it, and with ``control`` the reference's in float8
    e4m3 in the program's place (``calibrate.py``)."""
    st, fam, dev = run.state, run.family, run.torch_device
    w = {k: v.to(dev) for k, v in st["weights"].items()}
    out = {"program": [], "control": [], "steps": []}
    for s in st["samples"]:
        t_days = _days(st["dates"][s.ic])
        for k, (ins, frame) in sorted(s.got.items()):
            xs = [torch.as_tensor(np.ascontiguousarray(a), device=dev, dtype=torch.float32) for a in ins]
            ref = fam.reference_step(w, run.cfg, k, xs, t_days + k * 0.25)
            base = fam.step_base(xs)
            out["program"].append(compare.step_error(torch.as_tensor(frame, device=dev), ref, w["norm.std"], base))
            if control:
                low = fam.reference_step(w, run.cfg, k, xs, t_days + k * 0.25, "fp8")
                out["control"].append(compare.step_error(low, ref, w["norm.std"], base))
            out["steps"].append(k)
    return out


def check(run) -> None:
    errs = readings(run)["program"]
    run.checks["step_err"] = {"value": max(errs) if errs else float("inf"), "limit": run.limits.get("step_err", 0.0)}


def _days(t: datetime.datetime) -> float:
    return (t - datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo)).total_seconds() / 86400.0

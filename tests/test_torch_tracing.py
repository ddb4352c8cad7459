"""The port's spans (``skyrim_tpu_torch/utils/profiling.py`` ``annotate``) on
the CPU, on a tiny Pangu and a tiny GraphCast.

- Untraced, a span keeps no record and opens no profiler range, and costs
  well under 2 µs on the host.
- Under ``torch.profiler``, 3 ``stream_rollout`` steps record
  ``skyrim.model.advance`` and ``skyrim.rollout.stage`` once a step,
  ``skyrim.init_state.upload`` once with the IC's bytes, and one
  ``skyrim.K*`` span per kernel call, outermost only: the counts equal
  ``ops/cost.py``'s calls, and no kernel span lies inside another.
- One ``Trainer.train_step`` records its upload (the pair's bytes),
  forward, backward and update once each, under no other span.
- Each record's host interval is its profiler range's, within 50 µs (the
  records are stamped on the profiler's clock); ``device_ms`` is None on
  the CPU.
- Every profiling session's start (``trace()``'s too) clears the records,
  back to back sessions included.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from skyrim_tpu_torch.finetune import TrainConfig, Trainer
from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel
from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
from skyrim_tpu_torch.ops import cost
from skyrim_tpu_torch.rollout import stream_rollout
from skyrim_tpu_torch.utils import profiling

STEPS = 3
PANGU = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
GRAPHCAST = GraphCastConfig(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)


def _model(family):
    if family == "pangu":
        return PanguModel("pangu", cfg=PANGU, device="cpu")
    return GraphCastModel(GRAPHCAST, device="cpu")


@pytest.fixture(scope="module", params=["pangu", "graphcast"])
def built(request):
    model = _model(request.param)
    params = model.init_params()
    H, W = model.grid.shape
    ic = np.random.default_rng(0).normal(size=(model.n_history, len(model.channels), H, W)).astype(np.float32)
    return request.param, model, params, ic


def _rollout(model, params, ic, steps=STEPS):
    return list(stream_rollout(model, params, model.init_state(params, ic), steps))


def _traced(model, params, ic):
    """3 steps under the profiler, the kernels' declared calls counted;
    returns (records, the profiler's events by name, the counted calls)."""
    with cost.count_costs() as counted, profile(activities=[ProfilerActivity.CPU]) as prof:
        _rollout(model, params, ic)
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(e)
    return profiling.spans(), events, {k: v[0] for k, v in counted.by_kernel.items()}


def _spy_ranges(monkeypatch):
    """Count every profiler range opened from Python."""
    opened = []
    for owner, attr in ((torch._C._profiler, "_RecordFunctionFast"), (torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function")):
        real = getattr(owner, attr)

        def spy(*a, _real=real, **k):
            opened.append(a)
            return _real(*a, **k)

        monkeypatch.setattr(owner, attr, spy)
    return opened


def test_untraced_spans_keep_nothing_and_open_no_range(built, monkeypatch):
    family, model, params, ic = built
    before = profiling.spans()
    opened = _spy_ranges(monkeypatch)
    _rollout(model, params, ic)
    assert opened == [] and profiling.spans() == before


def test_rollout_records_each_boundary(built):
    family, model, params, ic = built
    records, _, calls = _traced(model, params, ic)
    n = collections.Counter(r.name for r in records)
    assert n["skyrim.model.advance"] == n["skyrim.rollout.stage"] == STEPS
    (upload,) = [r for r in records if r.name == "skyrim.init_state.upload"]
    assert upload.nbytes == ic.nbytes and upload.parent is None
    kernels = {k: v for k, v in n.items() if k.startswith("skyrim.K")}
    assert kernels == {"skyrim." + k: c for k, c in calls.items()}
    if family == "pangu":
        assert kernels["skyrim.K1"] == sum(PANGU.depths) * STEPS
        assert kernels["skyrim.K2"] == 2 * sum(d // 2 for d in PANGU.depths) * STEPS  # in and out of each shifted block
    else:
        assert kernels["skyrim.K7"] == GRAPHCAST.processor_rounds * STEPS
        assert kernels["skyrim.K8"] == kernels["skyrim.K9"] == STEPS
    for r in records:
        if r.name.startswith("skyrim.K"):
            # inside the step, and no kernel span inside another
            assert r.parent is not None and r.parent.name == "skyrim.model.advance"
        assert r.start_ns <= r.end_ns and r.device_ms is None


def test_records_sit_on_the_profilers_clock(built):
    family, model, params, ic = built
    records, events, _ = _traced(model, params, ic)
    by_name = collections.defaultdict(list)
    for r in records:
        by_name[r.name].append(r)
    for name, recs in by_name.items():
        ranges = sorted(events[name], key=lambda e: e.start_ns())
        assert len(ranges) == len(recs), name
        for r, e in zip(recs, ranges):
            assert abs(r.start_ns - e.start_ns()) < 50_000, name
            assert abs(r.end_ns - (e.start_ns() + e.duration_ns())) < 50_000, name


def test_a_new_session_starts_the_records_afresh(built, tmp_path):
    family, model, params, ic = built
    first, _, _ = _traced(model, params, ic)
    _rollout(model, params, ic, 1)  # untraced: the records stay the last session's
    assert profiling.spans() == first
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.spans() == []
        _rollout(model, params, ic)
    second = profiling.spans()
    assert len(second) == len(first) and not set(second) & set(first)
    with profile(activities=[ProfilerActivity.CPU]):  # straight after, no span between
        pass
    assert profiling.spans() == []
    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.spans() == []
        _rollout(model, params, ic, 1)
    assert {r.name for r in profiling.spans()} >= {"skyrim.model.advance", "skyrim.init_state.upload"}


@pytest.mark.parametrize("family", ["pangu", "graphcast"])
def test_train_step_records_its_four_phases(family):
    model = _model(family)
    model.compute_dtype = torch.float32
    trainer = Trainer(model, model.init_params(), TrainConfig(batch_size=1))
    H, W = model.grid.shape
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(1, model.n_history, len(model.channels), H, W)).astype(np.float32)
    ys = rng.normal(size=(1, model.frames_out, len(model.channels), H, W)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(xs, ys)
    top = [r for r in profiling.spans() if r.parent is None]
    assert [r.name for r in top] == ["skyrim.train.upload", "skyrim.train.forward", "skyrim.train.backward",
                                     "skyrim.train.update"]
    assert top[0].nbytes == xs.nbytes + ys.nbytes
    assert all(r.device_ms is None and r.end_ns <= s.start_ns for r, s in zip(top, top[1:]))


def test_an_untraced_span_costs_under_2_us():
    n = 10_000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("skyrim.off", 8):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 2e-6, best

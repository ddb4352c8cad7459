"""The benchmark's plain references and count functions against the port,
on the CPU at small sizes, on the same seeded weights and inputs.

Tolerances, in ``harness.compare.step_error``'s measure (the worst
channel's RMS gap over the output's spread, normalised units):

- the port in float32 against the reference: 1e-4 for Pangu with its patch
  embedding and recovery weights rounded to bf16 in the reference as the
  port keeps them whatever the compute type; 1e-5 for GraphCast (measured
  3e-7);
- the port in its bf16 against the reference: 4e-2, the benchmark's limit
  for the full-size cells (measured 4e-3 to 2.5e-2 at these sizes);
- the fp8 control against the reference: above that limit, by at least 3×
  the bf16 port's reading.

A train step: the port's one step in bf16 against the reference's, loss
within 1e-3 relative, first gradients within 5e-2 and changes within 1e-1
of the worst leaf (``harness.compare.train_numbers``).
"""

from __future__ import annotations

import datetime
import json
from pathlib import Path

import pytest
import torch

from wxbench.families import graphcast as gc_family
from wxbench.families import pangu as pangu_family
from wxbench.harness import compare, counts
from wxbench.reference import graphcast as gc_ref
from wxbench.reference import pangu as pangu_ref

WX = Path(__file__).resolve().parents[1]
PANGU = json.loads((WX / "configs" / "pangu.json").read_text()) | dict(
    lat=49, lon=96, embed_dim=16, depths=[2, 2, 2, 2], num_heads=[2, 2, 2, 2])
GRAPHCAST = json.loads((WX / "configs" / "graphcast.json").read_text()) | dict(
    lat=33, lon=64, latent=32, processor_rounds=2, mesh_refinements=2)
LIMIT = json.loads((WX / "limits" / "pangu.forecast_10d.json").read_text())["limits"]["step_err"]
T0 = datetime.datetime(2023, 5, 3, 9, tzinfo=datetime.timezone.utc)  # not midnight: the forcings matter
DAYS0 = (T0 - datetime.datetime(1970, 1, 1, tzinfo=T0.tzinfo)).total_seconds() / 86400


def _pangu_rollout(dtype, n=4):
    model, params, w = pangu_family.build(PANGU, torch.device("cpu"), 11)
    model.compute_dtype = dtype
    x = torch.randn(1, 69, PANGU["lat"], PANGU["lon"], generator=torch.Generator().manual_seed(3))
    x = x * w["norm.std"] + w["norm.mean"]
    st, outs = model.init_state(params, x), []
    for _ in range(n):
        st, y = model.advance(params, st)
        outs.append(y[0])
    return w, x[0], outs


def _pangu_errors(dtype, quant=None, bf16_patches=False):
    w, x, outs = _pangu_rollout(dtype)
    if bf16_patches:  # the port keeps its patch embedding and recovery in bf16 whatever the compute type
        w = {k: v.bfloat16().float() if "embed_" in k or "recover_" in k else v for k, v in w.items()}
    errs = []
    for k in range(len(outs)):  # steps 0-2 the 6-h net, step 3 the 24-h net from the IC
        j = pangu_ref.step_input(k)
        ref = pangu_ref.forecast_step(w, PANGU, k, x if j < 0 else outs[j])
        got = outs[k] if quant is None else pangu_ref.forecast_step(w, PANGU, k, x if j < 0 else outs[j], quant)
        errs.append(compare.step_error(got, ref, w["norm.std"]))
    return errs


def test_pangu_reference_matches_port_f32():
    assert max(_pangu_errors(torch.float32, bf16_patches=True)) < 1e-4


def test_pangu_port_bf16_within_limit_and_control_outside():
    prog = max(_pangu_errors(torch.bfloat16))
    control = min(_pangu_errors(torch.bfloat16, quant="fp8"))
    assert prog < LIMIT < control and control > 3 * prog


def _graphcast_errors(dtype):
    model, params, w = gc_family.build(GRAPHCAST, torch.device("cpu"), 7)
    model.compute_dtype = dtype
    params = model.prepare_params({k: v for k, v in params.items() if k != "cache"})
    x = torch.randn(2, 83, GRAPHCAST["lat"], GRAPHCAST["lon"], generator=torch.Generator().manual_seed(4))
    x = x * w["norm.std"] + w["norm.mean"]
    st, frames = model.init_state(params, x, start_time=T0), [x[0], x[1]]
    errs = []
    for k in range(3):
        st, y = model.advance(params, st)
        ref = gc_ref.forecast_step(w, GRAPHCAST, torch.stack(frames[k:k + 2]), DAYS0 + 0.25 * k)
        errs.append(compare.step_error(y[0], ref, w["norm.std"], frames[k + 1]))
        frames.append(y[0])
    return errs


def test_graphcast_reference_matches_port_f32():
    assert max(_graphcast_errors(torch.float32)) < 1e-5


def test_graphcast_port_bf16_within_limit():
    assert max(_graphcast_errors(torch.bfloat16)) < LIMIT


def test_train_step_matches_reference():
    from skyrim_tpu_torch.finetune.trainer import Trainer, TrainConfig

    from wxbench.reference import train

    model, params, w = pangu_family.build(PANGU, torch.device("cpu"), 5)
    tc = TrainConfig(batch_size=1, rollout_steps=1, remat=True)
    trainer = Trainer(model, params, tc)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 1, 69, PANGU["lat"], PANGU["lon"], generator=g) * w["norm.std"] + w["norm.mean"]
    y = torch.randn(1, 1, 69, PANGU["lat"], PANGU["lon"], generator=g) * w["norm.std"] + w["norm.mean"]
    loss = float(trainer.train_step(x.numpy(), y.numpy()))
    first = {n.replace("/", "."): trainer.opt.state[p]["exp_avg"] / 0.1 for n, p in trainer.leaves.items()}
    prog = {"losses": [loss], "first_grad": first,
            "params": {n.replace("/", "."): p.detach().clone() for n, p in trainer.leaves.items()}}
    ref = train.run_steps(w, lambda p, a, b: pangu_family.train_loss(p, PANGU, a, b, 1), [(x, y)],
                          tc.learning_rate, tc.weight_decay, tc.grad_clip)
    nums = compare.train_numbers(prog, ref, w)
    assert nums["loss_gap"] < 1e-3 and nums["grad_gap"] < 5e-2 and nums["update_gap"] < 1e-1, nums


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


# (label, args, bound ms in PERF.md §6 at 989 TFLOP/s and 3.35 TB/s)
KERNEL_BOUNDS = [
    ("K1", lambda: (_meta(8, 186, 360, 192), None, (_meta(192, 576), None), _meta(124, 6, 144, 144), None,
                    None, None, (_meta(192, 768), None, _meta(768, 192), None), (2, 6, 12), 6), 0.539),
    ("K1", lambda: (_meta(8, 96, 180, 384), None, (_meta(384, 1152), None), _meta(64, 12, 144, 144), None,
                    None, None, (_meta(384, 1536), None, _meta(1536, 384), None), (2, 6, 12), 12), 0.526),
    ("K6", lambda: (_meta(174, 1038240), (_meta(174, 512), None), (_meta(512, 512), None), None, None, None, True),
     0.737),
    ("K6", lambda: (_meta(1038240, 512), (_meta(512, 512), None), (_meta(512, 512), None), 1, None,
                    _meta(1038240, 512)), 1.101),
    ("K6", lambda: (_meta(1038240, 512), (_meta(1024, 512), None), (_meta(512, 512), None), 1,
                    _meta(1038240, 512), _meta(1038240, 512)), 1.651),
    ("K6", lambda: (_meta(1038240, 512), (_meta(512, 512), None), (_meta(512, 83), None)), 0.640),
    ("K6", lambda: (_meta(40962, 512), (_meta(1024, 512), None), (_meta(512, 512), None), 1, _meta(40962, 512),
                    _meta(40962, 512)), 0.065),
    ("K7", lambda: (_meta(322, 1024, 512), _meta(322, 1024, 512), _meta(322, 176, 512), _meta(322, 1024),
                    None, None, None, None, 176), 0.347),
    ("K8", lambda: (_meta(91, 12, 192, 1536), _meta(721, 1440), _meta(721, 1440, 1536), _meta(721, 1440, 512),
                    None, None, None, 3, 8, 120), 1.780),
    ("K9", lambda: (_meta(721, 1440, 512), _meta(721, 1440, 5120), _meta(103, 9, 10, 1120), None, None, None,
                    10, 144, 7, 160, (_meta(1629780), None)), 0.864),
]


@pytest.mark.parametrize("label,args,bound_ms", KERNEL_BOUNDS, ids=[f"{k[0]}-{i}" for i, k in enumerate(KERNEL_BOUNDS)])
def test_kernel_count_matches_the_bound_column(label, args, bound_ms):
    flops, nbytes = counts.call_cost(label, args(), {})
    assert counts.bound_s(flops, nbytes) * 1e3 == pytest.approx(bound_ms, rel=0.01)


def test_k1_count_at_pangu_stage_one():
    flops, _ = counts.call_cost("K1", KERNEL_BOUNDS[0][1](), {})
    assert flops == pytest.approx(5.33e11, rel=1e-3)


def test_step_flops_cover_the_blocks():
    """A Pangu step's model FLOPs: its 16 window blocks (K1's count) and a few
    percent more for the patch embedding, recovery and resampling."""
    cfg = json.loads((WX / "configs" / "pangu.json").read_text())
    blocks = 4 * counts.call_cost("K1", KERNEL_BOUNDS[0][1](), {})[0] + 12 * counts.call_cost(
        "K1", KERNEL_BOUNDS[1][1](), {})[0]
    assert blocks < pangu_family.forward_flops(cfg) < 1.05 * blocks

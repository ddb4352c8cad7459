"""FuXi on the port: the configuration's sizes into the port's ``FuXiModel``
(the Swin-V2 cascade, all stages resident), weights drawn on the device a
stage at a time, and the plain reference's view of a forecast step
(``reference/fuxi.py``)."""

from __future__ import annotations

import math

import torch

from wxbench.harness import draw
from wxbench.reference import fuxi as ref

N_HISTORY = 2
FRAMES_BACK = 2
KEYS = ("lat", "lon", "in_channels", "embed_dim", "depth", "num_heads", "patch", "n_stages", "stage_steps", "attn_v2")


def port_config(cfg: dict):
    from skyrim_tpu_torch.models.fuxi import FuXiConfig

    return FuXiConfig(**{k: cfg[k] for k in KEYS}, window=tuple(cfg["window"]))


def _drawn(shapes: dict, gen, device) -> dict[str, torch.Tensor]:
    """One stage's leaves by ``draw``'s rule in f32, with a stacked trunk
    kernel's fan-in that of one block (the pairs' axis left out) and the
    logit scales at log 10 (the published initial value) + N(0, 0.1²)."""
    w = draw.draw_leaves(shapes, gen, device)
    for name, t in w.items():
        if name.startswith("pairs.") and name.endswith(".kernel"):
            t.mul_(math.sqrt(t.shape[0]))
        elif name.endswith(".logit_scale"):
            t.add_(math.log(10.0) - 1.0)
    return w


def build(cfg: dict, device, seed: int):
    """(model, params, weights): the port's model and serving tree (every
    stage bf16 at rest, as the port holds them), and the harness's own host
    copy of the drawn bf16 values under ``stage<k>.<path>``."""
    from skyrim_tpu_torch.models.fuxi import FuXiModel

    model = FuXiModel(port_config(cfg), device=device)
    gen = draw.generator(device, seed, "weights")
    weights, stages = {}, []
    for k in range(cfg["n_stages"]):
        net = model.new_net()
        w = _drawn({n: tuple(p.shape) for n, p in net.named_parameters()}, gen, device)
        state = {n: t.to(torch.bfloat16) for n, t in w.items()}
        del w
        net.load_state_dict(state, strict=True, assign=True)
        stages.append(net.eval().requires_grad_(False))
        weights.update({f"stage{k}.{n}": t.cpu() for n, t in state.items()})
    C = cfg["in_channels"]
    extra = draw.draw_leaves({"norm.mean": (C, 1, 1), "norm.std": (C, 1, 1)}, gen, device)
    # physical means N(0, 1) and spreads 0.5 + 2|N(0, 1)| from the leaf rule's N(0, 0.1²)
    extra["norm.mean"].mul_(10.0)
    extra["norm.std"].abs_().mul_(20.0).add_(0.5)
    weights.update({k: v.cpu() for k, v in extra.items()})
    params = {"stages": stages, "norm": {"mean": extra["norm.mean"].clone(), "std": extra["norm.std"].clone()}}
    return model, model.prepare_params(params), weights


def step_inputs(step: int) -> list[int]:
    """The two frames before ``step``, oldest first (−2, −1: the IC's)."""
    return [step - 2, step - 1]


def step_base(inputs):
    """The last input frame: each stage predicts its increment (``compare.step_error``)."""
    return inputs[-1]


def reference_step(weights, cfg, step: int, inputs: list[torch.Tensor], time_days: float, quant=None):
    """The reference's output of ``step``, by the stage the cascade takes there."""
    return ref.forecast_step(weights, cfg, step, torch.stack(inputs), quant)


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one step: the reference's products of one stage counted
    on meta."""
    from torch.utils.flop_counter import FlopCounterMode

    C = cfg["in_channels"]
    w = {f"stage0.{n}": torch.empty(s, device="meta") for n, s in ref.param_shapes(cfg, N_HISTORY).items()}
    w["norm.mean"] = w["norm.std"] = torch.empty(C, 1, 1, device="meta")
    x = torch.empty(N_HISTORY, C, cfg["lat"], cfg["lon"], device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.stage_forward(w, cfg, 0, x)
    return int(fc.get_total_flops())

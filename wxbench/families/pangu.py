"""Pangu-Weather on the port: the configuration's sizes into the port's
``PanguModel``, weights drawn on the device, and the plain reference's
view of a forecast step (``reference/pangu.py``)."""

from __future__ import annotations

import torch

from wxbench.harness import draw
from wxbench.reference import pangu as ref

N_HISTORY = 1
FRAMES_BACK = 4  # a 24-h step reads the output of four steps before


def port_config(cfg: dict):
    from skyrim_tpu_torch.models.pangu import PanguConfig

    keys = ("lat", "lon", "levels", "surface_channels", "level_vars", "const_masks", "embed_dim", "mlp_ratio")
    tuples = ("patch", "window", "depths", "num_heads")
    return PanguConfig(**{k: cfg[k] for k in keys}, **{k: tuple(cfg[k]) for k in tuples})


def channels(cfg: dict) -> int:
    return cfg["levels"] * cfg["level_vars"] + cfg["surface_channels"]


def build(cfg: dict, device, seed: int):
    """(model, params, weights): the port's model and serving tree, and the
    harness's own copy of every drawn tensor under its flax path."""
    from skyrim_tpu_torch.models.pangu import PanguModel, PanguNet

    pcfg = port_config(cfg)
    model = PanguModel(variant=cfg["variant"], cfg=pcfg, device=device)
    gen = draw.generator(device, seed, "weights")
    weights, params = {}, {}
    nets = ("net6", "net24") if cfg["variant"] == "pangu" else ("net6",)
    for net_name in nets:
        with torch.device(device):
            net = PanguNet(pcfg)
        net = net.to(device).eval().requires_grad_(False)
        w = draw.draw_leaves({n: tuple(p.shape) for n, p in net.named_parameters()}, gen, device)
        draw.load_module_(net, w)
        weights.update({f"{net_name}.{n}": t for n, t in w.items()})
        params[net_name] = net
    C = channels(cfg)
    extra = draw.draw_leaves({"norm.mean": (C, 1, 1), "norm.std": (C, 1, 1),
                              "consts": (cfg["const_masks"], cfg["lat"], cfg["lon"])}, gen, device)
    # physical means N(0, 1) and spreads 0.5 + 2|N(0, 1)| from the leaf rule's N(0, 0.1²)
    extra["norm.mean"].mul_(10.0)
    extra["norm.std"].abs_().mul_(20.0).add_(0.5)
    weights.update(extra)
    params["norm"] = {"mean": extra["norm.mean"].clone(), "std": extra["norm.std"].clone()}
    params["consts"] = extra["consts"].clone()
    # the harness's copy waits in host memory, so the card's peak is the program's
    return model, model.prepare_params(params), {k: v.cpu() for k, v in weights.items()}


def step_inputs(step: int) -> list[int]:
    """The earlier steps whose outputs are ``step``'s input (−1: the IC)."""
    return [ref.step_input(step)]


def step_base(inputs):
    """None: a Pangu net predicts the next state whole (``compare.step_error``)."""
    return None


def reference_step(weights, cfg, step: int, inputs: list[torch.Tensor], time_days: float, quant=None):
    """The reference's output of ``step`` from the frames ``step_inputs`` names."""
    (x,) = inputs
    return ref.forecast_step(weights, cfg, step, x, quant)


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one step: the reference's products counted on meta."""
    from torch.utils.flop_counter import FlopCounterMode

    C = channels(cfg)
    w = {n: torch.empty(s, device="meta") for n, s in ref.param_shapes(cfg).items()}
    w["norm.mean"] = w["norm.std"] = torch.empty(C, 1, 1, device="meta")
    w["consts"] = torch.empty(cfg["const_masks"], cfg["lat"], cfg["lon"], device="meta")
    x = torch.empty(C, cfg["lat"], cfg["lon"], device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.net_forward(w, cfg, "net6", x)
    return int(fc.get_total_flops())


def train_loss(w, cfg, xs, ys, rollout_steps: int, quant=None):
    """The trainer's loss in the reference: the mean over the batch of the
    mean squared error of the 6-h net's prediction (remat by block)."""
    total = 0.0
    for x, y in zip(xs, ys):
        sample, state = 0.0, x[-1]
        for k in range(rollout_steps):
            state = ref.net_forward(w, cfg, "net6", state, quant, remat=True)
            sample = sample + torch.mean((state - y[k]) ** 2)
        total = total + sample / rollout_steps
    return total / len(xs)

"""GraphCast on the port: the configuration's sizes into the port's
``GraphCastModel``, weights drawn on the device, and the plain reference's
view of a forecast step (``reference/graphcast.py``)."""

from __future__ import annotations

import torch

from wxbench.harness import draw
from wxbench.reference import graphcast as ref

N_HISTORY = 2
FRAMES_BACK = 2
N_STATIC = 3


def port_config(cfg: dict):
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig

    return GraphCastConfig(**{k: cfg[k] for k in ("lat", "lon", "in_channels", "latent", "processor_rounds",
                                                  "mesh_refinements")})


def n_grid_in(cfg: dict) -> int:
    return N_HISTORY * cfg["in_channels"] + ref.N_FORCINGS + N_STATIC


def build(cfg: dict, device, seed: int):
    """(model, params, weights): the port's model (its graph tables built on
    the host as its constructor does) and serving tree, and the harness's
    own host copy of every drawn tensor under its flax path."""
    from skyrim_tpu_torch.models.graphcast import GraphCastModel

    model = GraphCastModel(cfg=port_config(cfg), device=device)
    gen = draw.generator(device, seed, "weights")
    with torch.device(device):
        net = model.new_net()
    net = net.to(device).eval().requires_grad_(False)
    w = draw.draw_leaves({n: tuple(p.shape) for n, p in net.named_parameters()}, gen, device)
    draw.load_module_(net, w)
    weights = {f"net.{n}": t for n, t in w.items()}
    C = cfg["in_channels"]
    extra = draw.draw_leaves({"norm.mean": (C, 1, 1), "norm.std": (C, 1, 1)}, gen, device)
    # physical means N(0, 1) and spreads 0.5 + 2|N(0, 1)| from the leaf rule's N(0, 0.1²)
    extra["norm.mean"].mul_(10.0)
    extra["norm.std"].abs_().mul_(20.0).add_(0.5)
    weights.update(extra)
    params = {"net": net, "norm": {"mean": extra["norm.mean"].clone(), "std": extra["norm.std"].clone()}}
    return model, model.prepare_params(params), {k: v.cpu() for k, v in weights.items()}


def step_inputs(step: int) -> list[int]:
    """The two frames before ``step``, oldest first (−2, −1: the IC's)."""
    return [step - 2, step - 1]


def step_base(inputs):
    """The last input frame: the net predicts its increment (``compare.step_error``)."""
    return inputs[-1]


def reference_step(weights, cfg, step: int, inputs: list[torch.Tensor], time_days: float, quant=None):
    return ref.forecast_step(weights, cfg, torch.stack(inputs), time_days, quant)


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one step: the reference's products counted on meta, at
    its graph's sizes, without the static terms that every step shares
    (``reference.graphcast.static_terms``: the port computes them once)."""
    from torch.utils.flop_counter import FlopCounterMode

    g = ref.build_graph(cfg["lat"], cfg["lon"], cfg["mesh_refinements"])
    meta = {k: (torch.empty(v.shape, device="meta", dtype=torch.long if v.dtype.kind == "i" else torch.float32)
                if hasattr(v, "shape") and k not in ("lat", "lon") else v) for k, v in g.items()}
    C = cfg["in_channels"]
    w = {n: torch.empty(s, device="meta") for n, s in ref.param_shapes(cfg, n_grid_in(cfg)).items()}
    w["norm.mean"] = w["norm.std"] = torch.empty(C, 1, 1, device="meta")
    x = torch.empty(N_HISTORY, C, cfg["lat"], cfg["lon"], device="meta")
    static = ref.static_terms(w, cfg, meta)
    with FlopCounterMode(display=False) as fc:
        ref.forward(w, cfg, meta, x, 0.0, static=static)
    return int(fc.get_total_flops())

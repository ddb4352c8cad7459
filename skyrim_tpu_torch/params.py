"""Weight bridge: the JAX package's parameter trees → the port's.

The input is the tree the JAX package's ``init_params`` (or a converted
checkpoint) produces, as nested dicts of arrays with flax names —
``net6/PanguBlock_3/EarthAttention3D_0/qkv/kernel`` for Pangu,
``net/round_3/MLP_0/Dense_0/kernel`` for GraphCast — and Dense kernels
(in, out).  The port's modules carry the same names and layouts, so each
leaf maps to one parameter.  Every leaf is consumed exactly once; a
missing, unexpected or misshapen leaf raises.  ``cache`` is skipped: the
model's ``prepare_params`` rebuilds it.
"""

from __future__ import annotations

import numpy as np
import torch

from skyrim_tpu_torch.models.graphcast import GraphCastModel, GraphCastNet
from skyrim_tpu_torch.models.pangu import PanguModel, PanguNet


def flatten(tree: dict, prefix: str = "") -> dict[str, object]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def from_jax(tree: dict, model: PanguModel | GraphCastModel) -> dict:
    """Port parameters for ``model`` from the JAX parameter tree of the same
    model."""
    leaves = {k: v for k, v in flatten(tree).items() if not k.startswith("cache/")}

    def take(key, shape=None):
        if key not in leaves:
            raise KeyError(f"JAX parameter tree has no leaf {key!r}")
        arr = np.asarray(leaves.pop(key), dtype=np.float32)
        if shape is not None and arr.shape != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(shape)}")
        return torch.from_numpy(arr.copy())

    def load(net_name, net):
        state = {
            name: take(f"{net_name}/" + name.replace(".", "/"), p.shape)
            for name, p in net.named_parameters()
        }
        net.load_state_dict(state, strict=True)
        return net.to(model.device).eval().requires_grad_(False)

    params = {}
    if isinstance(model, GraphCastModel):
        params["net"] = load("net", GraphCastNet(model.cfg, model.n_grid_in))
    else:
        for net_name in ("net6", "net24"):
            if any(k.startswith(net_name + "/") for k in leaves):
                params[net_name] = load(net_name, PanguNet(model.cfg))
        params["consts"] = take("consts").to(model.device)
    params["norm"] = {k: take(f"norm/{k}").to(model.device) for k in ("mean", "std")}
    if leaves:
        raise ValueError(f"unconsumed JAX parameter leaves: {sorted(leaves)[:8]}")
    return model.prepare_params(params)

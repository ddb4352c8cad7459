"""Weight bridge: the JAX package's parameter trees → the port's, and back.

The input is the tree the JAX package's ``init_params`` (or a converted
checkpoint) produces, as nested dicts of arrays with flax names —
``net6/PanguBlock_3/EarthAttention3D_0/qkv/kernel`` for Pangu,
``net/round_3/MLP_0/Dense_0/kernel`` for GraphCast,
``net/block_3/filter/w1`` for SFNO, ``net/fuser_3/qkv/kernel`` for
FengWu — and Dense kernels (in, out).  The port's modules carry the same
names and layouts, so each leaf maps to one parameter.  Every leaf is consumed exactly once; a
missing, unexpected or misshapen leaf raises.  ``cache`` is skipped: the
model's ``prepare_params`` rebuilds it.  ``to_tree`` is the inverse: the
port's parameters as that tree with numpy leaves, without ``cache``.
"""

from __future__ import annotations

import numpy as np
import torch

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


def unflatten(leaves: dict) -> dict:
    """{"a/b/c": leaf} → {"a": {"b": {"c": leaf}}}."""
    out: dict = {}
    for path, v in leaves.items():
        *head, leaf = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def to_tree(params: dict) -> dict:
    """The flax-layout tree of the port's parameters (numpy leaves, the
    ``cache`` left out): what ``from_jax`` reads back."""

    def leaves(v, path):
        if isinstance(v, torch.nn.Module):
            return {f"{path}/" + n.replace(".", "/"): p.detach().cpu().numpy().copy() for n, p in v.named_parameters()}
        if isinstance(v, dict):
            return {k: a for key, w in v.items() for k, a in leaves(w, f"{path}/{key}").items()}
        return {path: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v).copy()}

    return unflatten({k: a for key, v in params.items() if key != "cache" for k, a in leaves(v, key).items()})


def from_jax(tree: dict, model) -> dict:
    """Port parameters for ``model`` from the JAX parameter tree of the same
    model: Pangu's ``net6``/``net24`` and ``consts``, every other model's
    ``net`` (its ``new_net()``), and ``norm``."""
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
    if isinstance(model, PanguModel):
        for net_name in ("net6", "net24"):
            if any(k.startswith(net_name + "/") for k in leaves):
                params[net_name] = load(net_name, PanguNet(model.cfg))
        params["consts"] = take("consts").to(model.device)
    else:
        params["net"] = load("net", model.new_net())
    params["norm"] = {k: take(f"norm/{k}").to(model.device) for k in ("mean", "std")}
    if leaves:
        raise ValueError(f"unconsumed JAX parameter leaves: {sorted(leaves)[:8]}")
    return model.prepare_params(params)

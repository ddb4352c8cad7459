"""Weight bridge: the JAX package's parameter trees → the port's, and back.

The input is the tree the JAX package's ``init_params`` (or a converted
checkpoint) produces, as nested dicts (and FuXi's list of stages) of
arrays with flax names —
``net6/PanguBlock_3/EarthAttention3D_0/qkv/kernel`` for Pangu,
``net/round_3/MLP_0/Dense_0/kernel`` for GraphCast,
``net/block_3/filter/w1`` for SFNO, ``net/fuser_3/qkv/kernel`` for
FengWu, ``stages/0/pairs/a/qkv/kernel`` for FuXi — and Dense kernels
(in, out).  The port's modules carry the same names and layouts, so each
leaf maps to one parameter.  Every leaf is consumed exactly once; a
missing, unexpected or misshapen leaf raises.  ``cache`` is skipped: the
model's ``prepare_params`` rebuilds it.  FuXi's stage leaves are bf16 at
rest and load as bf16 without an f32 copy (a bf16 numpy leaf, numpy's
``bfloat16`` extension type as JAX hands it over, is read through its
bits).  ``to_tree`` is the inverse: the port's parameters as that tree
with numpy leaves (CPU tensors for bf16, which numpy lacks), without
``cache``.
"""

from __future__ import annotations

import numpy as np
import torch

from skyrim_tpu_torch.models.fuxi import FuXiModel
from skyrim_tpu_torch.models.pangu import PanguModel, PanguNet
from skyrim_tpu_torch.utils.tree import flatten, unflatten


def as_tensor(v, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A CPU tensor of leaf ``v`` (numpy, bf16 numpy, or a tensor), cast to
    ``dtype`` where given."""
    if torch.is_tensor(v):
        t = v.detach().cpu()
    else:
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def _host(t: torch.Tensor):
    t = t.detach().cpu()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def to_tree(params: dict) -> dict:
    """The flax-layout tree of the port's parameters (numpy leaves, CPU
    tensors for bf16, the ``cache`` left out): what ``from_jax`` reads back."""

    def leaves(v, path):
        if isinstance(v, torch.nn.Module):
            return {f"{path}/" + n.replace(".", "/"): _host(p) for n, p in v.named_parameters()}
        if isinstance(v, (dict, list)):
            items = v.items() if isinstance(v, dict) else enumerate(v)
            return {k: a for key, w in items for k, a in leaves(w, f"{path}/{key}").items()}
        return {path: _host(v) if torch.is_tensor(v) else np.asarray(v).copy()}

    return unflatten({k: a for key, v in params.items() if key != "cache" for k, a in leaves(v, key).items()})


def from_jax(tree: dict, model) -> dict:
    """Port parameters for ``model`` from the JAX parameter tree of the same
    model: Pangu's ``net6``/``net24`` and ``consts``, FuXi's ``stages`` (as
    many as the tree holds), every other model's ``net`` (its
    ``new_net()``), and ``norm``."""
    leaves = {k: v for k, v in flatten(tree).items() if not k.startswith("cache/")}

    def take(key, shape=None, dtype=torch.float32):
        if key not in leaves:
            raise KeyError(f"JAX parameter tree has no leaf {key!r}")
        t = as_tensor(leaves.pop(key), dtype)
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(shape)}")
        return t

    def load(net_name, net):
        state = {
            name: take(f"{net_name}/" + name.replace(".", "/"), p.shape)
            for name, p in net.named_parameters()
        }
        net.load_state_dict(state, strict=True)
        return net.to(model.device).eval().requires_grad_(False)

    def load_stage(prefix):
        """A FuXi stage: each leaf in bf16, moved to the device, assigned to
        the holders of ``new_net`` (meta: no second copy)."""
        net = model.new_net()
        state = {
            name: take(f"{prefix}/" + name.replace(".", "/"), p.shape, p.dtype).to(model.device)
            for name, p in net.named_parameters()
        }
        net.load_state_dict(state, strict=True, assign=True)
        return net.eval()

    params = {}
    if isinstance(model, FuXiModel):
        n = len({k.split("/")[1] for k in leaves if k.startswith("stages/")})
        params["stages"] = [load_stage(f"stages/{s}") for s in range(n)]
    elif isinstance(model, PanguModel):
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

"""Weight storage of the port (the torch counterpart of
skyrim_tpu/weights/registry.py).

Parameters live under ``SKYRIM_WEIGHTS_DIR`` (default
``~/.cache/skyrim_tpu/weights``) in ``<model>/``, the directory where the
JAX package keeps its orbax step directories (named by digits).  The
port's checkpoints are files beside them, ``torch_<step>.pt``: the
flax-layout tree that ``params.from_jax`` reads, its leaves saved as
tensors with ``torch.save`` under their '/'-joined paths (a list's items
under their index), loaded with ``weights_only=True`` as numpy leaves
(bf16 ones stay tensors), without ``params["cache"]``
(``prepare_params`` rebuilds it).  ``load_params`` resolution order, as the JAX package's:

1. the port's newest checkpoint for the model name,
2. a torch state dict staged at ``<root>/<model>.pt``, converted
   (weights/convert.py) and saved as a checkpoint,
3. a random initialization from a seed, logged loudly (offline
   environments cannot download the reference checkpoints).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from skyrim_tpu_torch.io.save import LOCAL_CACHE
from skyrim_tpu_torch.params import as_tensor, flatten, from_jax, to_tree, unflatten
from skyrim_tpu_torch.utils.logging import logger

_CHECKPOINT = re.compile(r"torch_(\d+)\.pt")


def checkpoint_dir(model_name: str) -> Path:
    root = os.environ.get("SKYRIM_WEIGHTS_DIR", os.path.join(LOCAL_CACHE, "weights"))
    return Path(root) / model_name


def save_checkpoint(model_name: str, params: dict, step: int = 0) -> str:
    """Save a flax-layout tree of arrays, or the port's parameters (their
    ``params.to_tree``), as ``torch_<step>.pt``; returns the path."""
    leaves = {k: as_tensor(v) for k, v in flatten(to_tree(params)).items()}
    path = checkpoint_dir(model_name) / f"torch_{step}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(leaves, path)
    logger.success("saved checkpoint %s", path)
    return str(path)


def load_checkpoint(model_name: str, step: int | None = None) -> dict:
    """The saved tree (numpy leaves) of ``step``, the newest by default."""
    base = checkpoint_dir(model_name)
    steps = sorted(int(m.group(1)) for p in base.glob("torch_*.pt") if (m := _CHECKPOINT.fullmatch(p.name)))
    if not steps:
        raise FileNotFoundError(f"no torch checkpoints under {base}")
    step = steps[-1] if step is None else step
    leaves = torch.load(base / f"torch_{step}.pt", map_location="cpu", weights_only=True)
    logger.info("restored %s checkpoint step %d", model_name, step)
    return unflatten({k: v if v.dtype == torch.bfloat16 else v.numpy() for k, v in leaves.items()})


def load_params(model, seed: int = 0, allow_init: bool = True) -> dict:
    """Parameters for a port model instance, in the order above."""
    try:
        return from_jax(load_checkpoint(model.name), model)
    except FileNotFoundError:
        pass
    staged = checkpoint_dir(model.name).with_suffix(".pt")
    if staged.exists():
        from skyrim_tpu_torch.weights.convert import convert_torch_file

        tree = convert_torch_file(model, staged)
        save_checkpoint(model.name, tree)
        return from_jax(tree, model)
    if not allow_init:
        raise FileNotFoundError(
            f"no weights for {model.name!r}; set SKYRIM_WEIGHTS_DIR or stage a torch file at {staged}"
        )
    logger.warning(
        "no pretrained weights for %r — using random initialization "
        "(seed %d; outputs are not meteorologically meaningful)", model.name, seed
    )
    return model.init_params(torch.Generator().manual_seed(seed))

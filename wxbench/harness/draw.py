"""Seeded inputs: weights drawn on the device in a few large calls, and
sub-seeds for each purpose, so one ``--seed`` fixes every input of a run.

Each weight leaf is a slice of one normal draw per group of leaves, scaled
by its name as flax initialises the published models, with non-zero
biases and LayerNorm parameters so that a dropped bias or scale shows:

- ``kernel``: N(0, 1/fan_in), fan_in the product of all but the last axis;
- ``earth_bias`` and other attention bias tables: N(0, 0.02²);
- ``scale``: 1 + N(0, 0.1²); every other leaf (biases): N(0, 0.1²).
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, purpose: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def leaf_std(name: str, shape) -> tuple[float, float]:
    """(offset, std) of the leaf called ``name`` (its last dotted part)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return 0.0, 1.0 / math.sqrt(math.prod(shape[:-1]))
    if leaf.endswith("bias") and leaf != "bias":
        return 0.0, 0.02  # earth_bias, rel_bias: attention bias tables
    if leaf == "scale" or leaf.endswith("_scale"):
        return 1.0, 0.1
    return 0.0, 0.1


@torch.no_grad()
def draw_leaves(shapes: dict[str, tuple], gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    """f32 tensors for ``shapes`` (name → shape), all slices of one draw."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        offset, std = leaf_std(name, shape)
        out[name] = flat[i:i + n].view(shape).mul_(std).add_(offset)
        i += n
    return out


@torch.no_grad()
def load_module_(module: torch.nn.Module, tensors: dict[str, torch.Tensor]) -> None:
    """Copy ``tensors[name]`` into each of the module's parameters."""
    for name, p in module.named_parameters():
        p.copy_(tensors[name])


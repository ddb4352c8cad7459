"""Prognostic model protocol (port of skyrim_tpu/models/base.py).

    state = model.init_state(params, x0, start_time=t0)
    state, y = model.advance(params, state)

``ModelState`` keeps the input history on the model's device and the
step counter as a Python int, so step-dependent control flow (Pangu's
6h/24h choice) needs no device synchronisation.  Parameters stay f32
(FuXi's stages bf16, as the JAX package keeps them); the network runs in
``compute_dtype`` (bf16 by default).  ``apply`` is differentiable in the
leaves that require a gradient (a serving tree's do not; the finetune
trainer's copy's do) and needs no ``params["cache"]``; ``advance`` and the
rollouts run without autograd.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime
import math
from typing import Any, ClassVar

import numpy as np
import torch
from torch import nn

from skyrim_tpu_torch.channels import CHANNEL_SETS
from skyrim_tpu_torch.grid import GRID_721x1440, LatLonGrid

Params = Any


@dataclasses.dataclass
class ModelState:
    """Rollout state.

    x: (n_history, C, H, W) on the model's device — most recent frame last.
    step: advances taken so far.
    generator: random generator for stochastic models (None otherwise).
    time_days: valid time as days since 1970-01-01.
    extra: model-specific state (Pangu's 24h anchor frame).
    """

    x: torch.Tensor
    step: int = 0
    generator: torch.Generator | None = None
    time_days: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "ModelState":
        return dataclasses.replace(self, **changes)


class PrognosticModel(abc.ABC):
    """A global weather model: fixed channel set, grid and time step."""

    name: ClassVar[str]
    channels: tuple[str, ...]
    grid: LatLonGrid = GRID_721x1440
    n_history: int = 1
    #: frames emitted per apply() call
    frames_out: int = 1
    time_step: datetime.timedelta = datetime.timedelta(hours=6)
    #: dtype of the network's activations (parameters stay f32)
    compute_dtype: torch.dtype = torch.bfloat16
    device: torch.device

    @abc.abstractmethod
    def init_params(self, generator: torch.Generator | None = None) -> Params:
        """Randomly initialized parameters (incl. normalization stats)."""

    @abc.abstractmethod
    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """One physics step: x (n_history, C, H, W) → (frames_out, C, H, W),
        in physical units.  Differentiable in every floating leaf of
        ``params`` that requires a gradient; without ``params["cache"]``
        the derived weights are built inline from the leaves."""

    def prepare_params(self, params: Params) -> Params:
        """Attach derived, step-invariant caches under ``params["cache"]``
        (functions of the leaves; ``apply`` rebuilds them inline without)."""
        return params

    def init_state(
        self,
        params: Params,
        x0,
        generator: torch.Generator | None = None,
        start_time: datetime.datetime | None = None,
    ) -> ModelState:
        x0 = torch.as_tensor(np.asarray(x0, np.float32) if not torch.is_tensor(x0) else x0)
        x0 = x0.to(self.device, torch.float32)
        if x0.ndim == 3:
            x0 = x0[None]
        if x0.shape[0] < self.n_history:
            # replicate the earliest frame to fill missing history
            pad = x0[:1].expand(self.n_history - x0.shape[0], *x0.shape[1:])
            x0 = torch.cat([pad, x0], dim=0)
        x0 = x0[-self.n_history :]
        t_days = 0.0
        if start_time is not None:
            epoch = datetime.datetime(1970, 1, 1, tzinfo=start_time.tzinfo)
            t_days = (start_time - epoch).total_seconds() / 86400.0
        return ModelState(x=x0, step=0, generator=generator, time_days=t_days)

    @property
    def _step_days(self) -> float:
        return self.time_step.total_seconds() / 86400.0

    @torch.no_grad()
    def advance(self, params: Params, state: ModelState) -> tuple[ModelState, torch.Tensor]:
        """Default advance: apply + shift the history window, without
        autograd (``apply`` is differentiable; serving is not)."""
        y = self.apply(params, state.x)
        new_x = torch.cat([state.x, y], dim=0)[-self.n_history :]
        return (
            state.replace(
                x=new_x,
                step=state.step + self.frames_out,
                time_days=state.time_days + self.frames_out * self._step_days,
            ),
            y,
        )

    @property
    def in_channel_names(self) -> list[str]:
        return list(self.channels)

    @property
    def out_channel_names(self) -> list[str]:
        return list(self.channels)

    @property
    def state_shape(self) -> tuple[int, int, int, int]:
        return (self.n_history, len(self.channels), *self.grid.shape)

    def param_count(self, params: Params) -> int:
        return _count({k: v for k, v in params.items() if k != "cache"})


def _count(params) -> int:
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(_count(v) for v in params)
    return int(params.numel())


def _truncated_normal(shape, std, generator):
    """N(0, std²) truncated to ±2 std, by inverse CDF (jax's truncated_normal),
    drawn on the generator's device."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    t = torch.empty(shape, device=generator.device).uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    return t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_flax_params_(net: nn.Module, generator: torch.Generator, normal: dict[str, float] | None = None) -> nn.Module:
    """flax's initialisers by leaf name: kernels lecun_normal (truncated,
    fan_in = prod(shape[:-1])), earth_bias and rel_bias
    truncated_normal(0.02), the leaves named in ``normal`` normal(std),
    scales (``scale``, ``*_scale``) ones, the rest (biases, position
    embeddings) zeros.  Draws in sorted flax-path order."""
    normal = normal or {}
    for name, p in sorted(net.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:-1])
            p.copy_(_truncated_normal(p.shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator))
        elif leaf in ("earth_bias", "rel_bias"):
            p.copy_(_truncated_normal(p.shape, 0.02, generator))
        elif leaf in normal:
            p.copy_(torch.randn(p.shape, generator=generator) * normal[leaf])
        elif leaf == "scale" or leaf.endswith("_scale"):
            p.fill_(1.0)
        else:
            p.zero_()
    return net


def make_norm_params(n_channels: int, mean=None, std=None, device="cpu") -> dict:
    """Per-channel normalization stats (C, 1, 1), stored with the params."""
    mean = np.zeros((n_channels,), np.float32) if mean is None else np.asarray(mean, np.float32)
    std = np.ones((n_channels,), np.float32) if std is None else np.asarray(std, np.float32)
    return {
        "mean": torch.as_tensor(mean, device=device)[:, None, None],
        "std": torch.as_tensor(std, device=device)[:, None, None],
    }


def normalize(norm: dict, x: torch.Tensor) -> torch.Tensor:
    return (x - norm["mean"]) / norm["std"]


def denormalize(norm: dict, x: torch.Tensor) -> torch.Tensor:
    return x * norm["std"] + norm["mean"]


def model_channels(name: str) -> tuple[str, ...]:
    """The channels of the model registered as ``name``."""
    return CHANNEL_SETS[name]

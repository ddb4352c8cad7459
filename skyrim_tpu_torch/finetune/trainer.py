"""Finetuning trainer (port of skyrim_tpu/finetune/trainer.py).

One train step is the JAX package's: the mean squared error of the
model's prediction against ``frames_out`` targets, ``rollout_steps`` times
with the history window rolled with the prediction, averaged over the
steps and the batch; gradients clipped by their global norm, then AdamW.

- Gradients: ``model.apply`` runs the kernels forward; each kernel's
  backward replays its plain composition from the inputs it saved
  (``ops/vjp.py``, JAX's custom VJPs), K2's is a K2 launch (``ops/roll.py``).
  ``remat`` wraps ``apply`` in ``torch.utils.checkpoint`` (JAX's
  ``jax.checkpoint``): the forward runs again in the backward and only the
  step's input is kept.
- Clipping is optax's ``clip_by_global_norm``: ``g · max_norm / ‖g‖`` only
  where ``‖g‖ ≥ max_norm`` (not ``clip_grad_norm_``, which divides by
  ``‖g‖ + 1e-6`` and scales whenever the norm exceeds the limit).
- The optimizer is optax's ``adamw(lr, weight_decay=wd)``, which
  ``torch.optim.AdamW`` computes for the same betas, eps and decay when
  every leaf of the JAX tree is a leaf here (the norm stats and Pangu's
  ``consts`` too) and a leaf without a gradient (``net24``, which ``apply``
  never runs) takes a zero gradient: ``torch.optim`` skips a ``None``
  gradient, and with it the leaf's decay and step count, where optax
  applies both.

The trainer owns a copy of the parameters on the model's device (the
card unless the model was made for the CPU), without ``params["cache"]``
(a function of the leaves: ``apply`` then builds the derived weights
inline, and ``prepare_params`` rebuilds the cache after loading), every
floating leaf requiring a gradient.  Checkpoints go through
``weights.registry.save_checkpoint`` as ``torch_<step>.pt`` (rank 0 alone
writes them under a mesh).

Over a ``parallel.mesh.Mesh`` (JAX's ``trainer.py:43-115``: the batch as
``P(dp, None, None, lat, lon)`` through ``compatible_spec``, parameters
and optimizer state replicated):

- the parameters are made rank 0's on every rank (``sharding.replicate``);
- a batch's members are split over ``dp`` where the batch divides by it,
  else every dp rank takes all of them (``compatible_spec`` replicates a
  dim the mesh does not divide);
- the ranks of one ``dp`` index — a spatial group, ``lat`` × ``lon`` of
  them — each compute their members whole, as ``sharding.py``'s ``gather``
  mode serves: redundant compute, the same numbers as JAX's partitioned
  step (ROADMAP.md §3);
- the gradients, flattened into one buffer, are summed over ``dp`` by one
  all-reduce and divided by ``dp`` before the global-norm clip, so the clip
  sees the gradient of the whole batch, as optax does under ``jit``;
- every rank then takes the same clip and AdamW step on the same bits and
  ends the step with identical leaves.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from skyrim_tpu_torch.finetune.dataset import FineTuneDataset
from skyrim_tpu_torch.models.base import PrognosticModel
from skyrim_tpu_torch.quantize import QuantizedTensor
from skyrim_tpu_torch.utils.logging import logger
from skyrim_tpu_torch.weights.registry import save_checkpoint


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    batch_size: int = 1
    n_epochs: int = 1
    rollout_steps: int = 1  # >1 = multi-step (autoregressive) loss
    grad_clip: float = 1.0
    remat: bool = True
    checkpoint_every: int = 0  # steps; 0 = only at end
    seed: int = 0


def named_leaves(params, path: str = "", out: dict | None = None) -> dict[str, torch.Tensor]:
    """Every leaf of a parameter tree by its flax path (``net6/PanguBlock_3/
    EarthAttention3D_0/qkv/kernel``, ``norm/mean``, ``stages/0/…``), the
    names ``params.to_tree`` gives; raises ``ValueError`` on a leaf that
    cannot be trained (an int8-quantized one)."""
    out = {} if out is None else out
    if isinstance(params, nn.Module):
        for n, p in params.named_parameters():
            named_leaves(p, f"{path}/" + n.replace(".", "/"), out)
    elif isinstance(params, dict):
        for k, v in params.items():
            named_leaves(v, f"{path}/{k}" if path else str(k), out)
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            named_leaves(v, f"{path}/{i}", out)
    elif isinstance(params, QuantizedTensor) or (torch.is_tensor(params) and not params.is_floating_point()):
        raise ValueError(
            f"parameter {path} is int8-quantized: a quantized tree cannot be trained; "
            "train the floating-point parameters and quantize after"
        )
    elif torch.is_tensor(params):
        out[path] = params
    else:
        raise ValueError(f"parameter {path} is a {type(params).__name__}, not a tensor")
    return out


class Trainer:
    def __init__(self, model: PrognosticModel, params, config: TrainConfig | None = None, mesh=None):
        self.model = model
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.config = config or TrainConfig()
        self.device = model.device
        # derived step-invariant caches are functions of the leaves, not
        # leaves to learn: without them apply() takes the inline path
        params = {k: v for k, v in params.items() if k != "cache"}
        named_leaves(params)  # refuse a quantized tree before copying it
        self.params = _on_device(copy.deepcopy(params), self.device)
        if self.mesh is not None:
            from skyrim_tpu_torch.parallel.sharding import replicate

            replicate(self.mesh, self.params)
        self.leaves = named_leaves(self.params)
        for p in self.leaves.values():
            p.requires_grad_(True)
        cfg = self.config
        self.opt = torch.optim.AdamW(
            list(self.leaves.values()), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
        self.step_count = 0

    def _apply(self, x):
        if self.config.remat:
            return checkpoint(self.model.apply, self.params, x, use_reentrant=False)
        return self.model.apply(self.params, x)

    def loss(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """The batch's loss, with its graph: xs (B, n_history, C, H, W), ys
        (B, rollout_steps·frames_out, C, H, W) on the trainer's device."""
        cfg, model = self.config, self.model
        fo = model.frames_out
        total = 0.0
        for x, y in zip(xs, ys):
            sample, state = 0.0, x
            for k in range(cfg.rollout_steps):
                pred = self._apply(state)  # (frames_out, C, H, W)
                sample = sample + torch.mean((pred - y[k * fo : (k + 1) * fo]) ** 2)
                state = torch.cat([state, pred], dim=0)[-model.n_history :]
            total = total + sample / cfg.rollout_steps
        return total / len(xs)

    def _members(self, n: int) -> slice:
        """This rank's batch members of ``n``: its ``dp`` slice where ``n``
        divides by ``dp``, else all of them."""
        from skyrim_tpu_torch.parallel.mesh import AXES

        dp = self.mesh.shape[AXES.dp] if self.mesh is not None else 1
        if dp == 1 or n % dp:
            return slice(0, n)
        d = self.mesh.coords[AXES.dp]
        return slice(d * n // dp, (d + 1) * n // dp)

    def _split(self, n: int) -> bool:
        from skyrim_tpu_torch.parallel.mesh import AXES

        return self.mesh is not None and self.mesh.shape[AXES.dp] > 1 and n % self.mesh.shape[AXES.dp] == 0

    def average_gradients(self) -> None:
        """Sum every leaf's gradient over ``dp`` in one all-reduce of a flat
        buffer and divide by ``dp``; leaves without a gradient take zeros."""
        from skyrim_tpu_torch.parallel.mesh import AXES, all_reduce_

        leaves = list(self.leaves.values())
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1).float() for p in leaves])
        all_reduce_(self.mesh, AXES.dp, flat)
        flat /= self.mesh.shape[AXES.dp]
        i = 0
        for p in leaves:
            n = p.numel()
            p.grad.copy_(flat[i:i + n].view_as(p.grad))
            i += n

    def update(self) -> torch.Tensor:
        """Clip the gradients, take the AdamW step and clear the gradients;
        returns the global norm before clipping."""
        norm = self.clip_gradients()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norm

    def clip_gradients(self) -> torch.Tensor:
        """Give every leaf without a gradient a zero one, then scale all by
        ``grad_clip / ‖g‖`` where the global norm ‖g‖ ≥ ``grad_clip``
        (optax's ``clip_by_global_norm``); returns ‖g‖."""
        grads = []
        for p in self.leaves.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        limit = self.config.grad_clip
        scale = torch.where(norm < limit, torch.ones_like(norm), limit / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        return norm

    def train_step(self, xs, ys) -> torch.Tensor:
        """One step on a batch (numpy or tensors), the whole batch given to
        every rank of a mesh; returns the batch's loss."""
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        ys = torch.as_tensor(ys, dtype=torch.float32, device=self.device)
        mine = self._members(len(xs))
        loss = self.loss(xs[mine], ys[mine])
        loss.backward()
        loss = loss.detach()
        if self._split(len(xs)):
            from skyrim_tpu_torch.parallel.mesh import AXES, all_reduce_

            self.average_gradients()
            loss = all_reduce_(self.mesh, AXES.dp, loss.clone()) / self.mesh.shape[AXES.dp]
        self.last_grad_norm = self.update().detach()
        self.step_count += 1
        return loss

    def fit(self, dataset: FineTuneDataset) -> dict:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        history = []
        needed = cfg.rollout_steps * self.model.frames_out
        if dataset.frames_out < needed:
            raise ValueError(
                f"dataset yields {dataset.frames_out} target frames but the rollout loss needs {needed}"
            )
        for epoch in range(cfg.n_epochs):
            t0 = time.perf_counter()
            losses = []
            for xs, ys in dataset.batches(cfg.batch_size, rng):
                losses.append(self.train_step(xs, ys))
                if cfg.checkpoint_every and self.step_count % cfg.checkpoint_every == 0:
                    self.save()
            mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            history.append(mean_loss)
            logger.success(
                "epoch %d: loss=%.5f (%.1fs, %d steps)", epoch, mean_loss, time.perf_counter() - t0, len(losses)
            )
        self.save()
        return {"loss": history, "steps": self.step_count}

    def save(self) -> str | None:
        """The checkpoint's path; under a mesh only rank 0 writes it (None
        elsewhere)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        return save_checkpoint(self.model.name, self.params, self.step_count)


def _on_device(tree, device):
    """The tree's modules and tensors moved to ``device`` (modules in place)."""
    if isinstance(tree, nn.Module):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return tree.to(device)

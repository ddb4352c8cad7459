"""The plain reference of a finetuning step: the mean squared error of the
model's prediction, its gradient by autograd through the plain f32
forward, optax's global-norm clip (scale by clip/‖g‖ where ‖g‖ ≥ clip)
and AdamW with decoupled weight decay, written out.

``run_steps`` takes the initial leaves, a loss function of (leaves, x, y)
and the batches, and returns what the comparison reads: each step's loss,
every leaf's first gradient as the optimizer receives it (after the
clip), and every leaf after the steps.
"""

from __future__ import annotations

import torch

from wxbench.reference.common import exact_f32


def run_steps(leaves0: dict[str, torch.Tensor], loss_fn, batches, lr: float, wd: float, clip: float,
              betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    b1, b2 = betas
    names = list(leaves0)
    p = {n: leaves0[n].detach().clone().float().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, first_grad = [], None
    with exact_f32():
        for t, (x, y) in enumerate(batches, start=1):
            loss = loss_fn(p, x, y)
            grads = torch.autograd.grad(loss, [p[n] for n in names], allow_unused=True)
            g = {n: torch.zeros_like(p[n]) if gr is None else gr.detach() for n, gr in zip(names, grads)}
            losses.append(float(loss.detach()))
            norm = torch.sqrt(sum((gi.double() ** 2).sum() for gi in g.values()))
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            g = {n: gi * scale for n, gi in g.items()}
            if first_grad is None:
                first_grad = g
            with torch.no_grad():
                for n in names:
                    p[n].mul_(1 - lr * wd)
                    m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                    denom = (v[n] / (1 - b2**t)).sqrt_().add_(eps)
                    p[n].addcdiv_(m[n], denom, value=-lr / (1 - b1**t))
    return {"losses": losses, "first_grad": first_grad, "params": {n: t.detach() for n, t in p.items()}}

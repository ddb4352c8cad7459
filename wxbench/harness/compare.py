"""The numbers that ``correct`` compares.

``step_error`` (a forecast step): in the configuration's normalised units
(each channel over its spread), the worst channel's RMS gap between the
program's output and the reference's, over the RMS of what the step
computes in the reference, floored at the median channel's.  What a step
computes is, for a model that predicts the next state whole (Pangu), the
output's deviation from its own mean over the grid; for a model that
predicts an increment of its last frame (GraphCast, ``base`` given), the
increment.  Per channel, so that one channel gone wrong shows; floored at
the median, so that a channel the step leaves nearly flat does not turn
rounding into a large ratio.  (Pangu's increment is no measure: its 24-h
net stepping its own outputs nears a fixed point, where the increment
shrinks and the ratio grows without a fault.  GraphCast's state is no
measure: it grows step by step, and a fault in the increment would shrink
beside it.)
"""

from __future__ import annotations

import torch


def step_error(out: torch.Tensor, ref: torch.Tensor, std: torch.Tensor, base: torch.Tensor | None = None) -> float:
    """out, ref, base: (C, H, W) in physical units; std: (C, 1, 1)."""
    out, ref, std = out.double(), ref.double(), std.double()
    gap = ((out - ref) / std).pow(2).mean(dim=(-2, -1)).sqrt()
    r = ref / std
    r = r - (r.mean(dim=(-2, -1), keepdim=True) if base is None else base.double() / std)
    dev = r.pow(2).mean(dim=(-2, -1)).sqrt()
    return float((gap / torch.maximum(dev, dev.median()).clamp_min(1e-30)).max())



def train_numbers(prog: dict, ref: dict, p0: dict) -> dict[str, float]:
    """The numbers a training cell compares, from each side's step losses,
    first gradients (as the optimizer receives them) and parameters after
    the checked steps, and the drawn parameters ``p0`` (name → tensor):

    - ``loss_gap``: the worst step's |loss − reference's| over the reference's;
    - ``grad_gap``: the worst leaf's gap between the norms of its first
      gradient, over the larger of the reference's norm of that leaf and of
      the median leaf;
    - ``update_gap``: the same of the norms of each leaf's change.

    Elements whose first gradient in the reference is under a thousandth of
    the median leaf's RMS gradient are left out of both norms: they move by
    round-off alone (a key's bias under softmax, a net the loss does not
    reach); a leaf left with no element is left out.
    """
    rms = {n: float(g.double().norm()) / max(g.numel(), 1) ** 0.5 for n, g in ref["first_grad"].items()}
    floor = 1e-3 * _median(list(rms.values()))
    gp, gr, cp, cr = {}, {}, {}, {}
    for n, g in ref["first_grad"].items():
        dev = g.device
        keep = g.abs() >= floor
        if not bool(keep.any()):
            continue
        gr[n] = float(g[keep].double().norm())
        gp[n] = float(prog["first_grad"][n].to(dev)[keep].double().norm())
        start = p0[n].to(dev).double()
        cr[n] = float((ref["params"][n].to(dev).double() - start)[keep].norm())
        cp[n] = float((prog["params"][n].to(dev).double() - start)[keep].norm())
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(gp, gr),
        "update_gap": _leaf_gap(cp, cr),
    }


def _leaf_gap(prog: dict[str, float], ref: dict[str, float]) -> float:
    med = _median(list(ref.values()))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref)


def _median(values) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0

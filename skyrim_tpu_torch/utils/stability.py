"""Full-resolution numerical-stability harness (port of skyrim_tpu/utils/stability.py).

1. ``stability_rollout`` — N full-resolution steps from a climatological
   synthetic IC, with the model's normalization stats set to the SAME
   climatology (data/ic.py ``climatology_stats``), so the net sees ~N(0,1)
   inputs as a trained artifact would.  Each step keeps only its
   normalized-space RMS, max-abs and finite flag, on the device (no output
   is stacked: 40 full-resolution frames would not fit), fetched once at
   the end.

2. ``precision_divergence`` — the same rollout in the production compute
   dtype (bf16, through the kernels) against f32 on the plain PyTorch
   compositions (``ops.vjp.plain_versions``), TF32 off for matmuls and
   cuDNN: per-step relative L2 divergence in normalized space.  This is the
   JAX package's bf16-kernels against ``SKYRIM_NO_PALLAS``-f32-"highest".

JAX scans the steps inside one program; here each step is a call of
``advance``, so there is no scan.  The JAX options ``fp32_pallas``,
``fp32_strip_cache`` and ``fp32_share_cache`` fit an f32 leg into a
16 GiB TPU; the port accepts only their defaults.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from skyrim_tpu_torch.models.base import PrognosticModel, make_norm_params, normalize
from skyrim_tpu_torch.ops.vjp import plain_versions


def climatological_norm(channels, device="cpu") -> dict:
    """Norm params whose stats match data/ic.py's synthetic climatology."""
    from skyrim_tpu_torch.data.ic import climatology_stats

    stats = [climatology_stats(c) for c in channels]
    return make_norm_params(len(channels), mean=[m for m, _ in stats], std=[s for _, s in stats], device=device)


def climatological_params(model: PrognosticModel, generator: torch.Generator | None = None) -> Any:
    """init_params with normalization stats pinned to the climatology."""
    params = dict(model.init_params(generator))
    params["norm"] = climatological_norm(model.channels, device=model.device)
    return params


def synthetic_ic(model: PrognosticModel, when: datetime.datetime | None = None) -> np.ndarray:
    """Climatology-shaped IC at the model's own grid/channels (f32)."""
    from skyrim_tpu_torch.data.ic import SyntheticSource

    when = when or datetime.datetime(2024, 1, 1)
    src = SyntheticSource(list(model.channels), grid=model.grid)
    f = src.fetch(when, n_history=model.n_history, time_step=model.time_step)
    return np.asarray(f.values, np.float32)


def _n_calls(model, n_steps: int) -> int:
    return -(-n_steps // model.frames_out)


def _rel_l2(norm, ya, yb) -> torch.Tensor:
    a = normalize(norm, ya.float())
    b = normalize(norm, yb.float())
    return torch.linalg.vector_norm(a - b) / (torch.linalg.vector_norm(b) + 1e-12)


def _init(model, params, x0):
    return model.init_state(params, torch.as_tensor(np.asarray(x0, np.float32)))


@torch.no_grad()
def stability_rollout(model: PrognosticModel, params: Any, x0: np.ndarray, n_steps: int) -> dict:
    """N steps; returns per-advance-call statistics.

    Keys: ``rms`` (normalized RMS), ``amax`` (normalized max-abs),
    ``finite`` (bool) — ONE ENTRY PER ``advance`` CALL (for a
    frames_out > 1 model each entry covers that call's whole frame
    bundle; ``n_calls`` is the array length, ``n_steps`` the total
    frames advanced).  Summary fields: ``growth_per_step_geo``
    (geometric-mean call-to-call RMS ratio over the second half — the
    monotone-drift detector) and ``all_finite``.
    """
    n_calls = _n_calls(model, n_steps)
    norm = params["norm"]
    state = _init(model, params, x0)
    stats = []
    for _ in range(n_calls):
        state, y = model.advance(params, state)
        yn = normalize(norm, y.float())
        stats.append(torch.stack([torch.sqrt(torch.mean(yn**2)), yn.abs().max(), torch.isfinite(y).all().float()]))
    arr = torch.stack(stats).double().cpu().numpy() if stats else np.zeros((0, 3))
    rms, amax, finite = arr[:, 0], arr[:, 1], arr[:, 2] > 0
    second_half = rms[len(rms) // 2:]
    ratios = second_half[1:] / np.maximum(second_half[:-1], 1e-30)
    growth = float(np.exp(np.mean(np.log(np.maximum(ratios, 1e-30))))) if len(ratios) else 1.0
    return {
        "n_steps": int(n_calls * model.frames_out),
        "n_calls": int(n_calls),
        "rms": [float(v) for v in rms],
        "amax": [float(v) for v in amax],
        "finite": [bool(v) for v in finite],
        "all_finite": bool(np.all(finite)),
        "growth_per_step_geo": growth,
    }


def _with_compute_dtype(model: PrognosticModel, dtype, device=None, **cfg_overrides) -> PrognosticModel:
    """A sibling of ``model`` computing in ``dtype`` (on ``device``, the
    model's own by default).  The port's models read ``compute_dtype`` when
    they run, so a copy with the attribute set serves; ``cfg_overrides``
    are ``dataclasses.replace``'d into the config of a new instance."""
    device = device or model.device
    if cfg_overrides or device != model.device:
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError(f"{type(model).__name__} has no cfg to rebuild on {device}")
        cfg = dataclasses.replace(cfg, **cfg_overrides)
        args = (model.variant,) if hasattr(model, "variant") else ()
        sub = type(model)(*args, cfg=cfg, device=device)
        if sub.grid != model.grid:
            sub.grid = model.grid
    else:
        sub = copy.copy(model)
    sub.compute_dtype = dtype
    return sub


@contextlib.contextmanager
def _full_f32():
    """No TF32 in matmuls or cuDNN inside the block; the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _to_device(tree, device):
    """A copy of the tree on ``device`` (modules copied, not moved)."""
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


@torch.no_grad()
def precision_divergence(
    model: PrognosticModel,
    params: Any,
    x0: np.ndarray,
    n_steps: int,
    make_fp32: Callable[..., PrognosticModel] | None = None,
    fp32_cfg_overrides: dict | None = None,
    fp32_pallas: bool = False,
    sequential: bool = False,
    fp32_device: str | None = None,
    fp32_strip_cache: bool = False,
    fp32_share_cache: bool = False,
) -> dict:
    """Per-step relative L2 between the bf16 rollout through the kernels and
    an f32 rollout on the plain compositions with TF32 off.

    Step by step: two resident states, no output stacks.  The f32 leg's
    derived caches (``params["cache"]``) are rebuilt for the f32 model.

    ``sequential=True`` runs the two legs one after the other, the bf16
    outputs staged on the host, so both legs are never resident at once.
    ``fp32_device`` (e.g. ``"cpu"``, requires ``sequential``) runs the whole
    f32 leg there, its parameters copied: a cross-device truth source.

    ``fp32_pallas``, ``fp32_strip_cache`` and ``fp32_share_cache`` fit the
    JAX package's f32 leg into a 16 GiB TPU; the port takes only their
    default (False) and raises ``ValueError`` otherwise.
    """
    for opt, val in (("fp32_pallas", fp32_pallas), ("fp32_strip_cache", fp32_strip_cache),
                     ("fp32_share_cache", fp32_share_cache)):
        if val:
            raise ValueError(f"{opt} fits the JAX package's f32 leg into a TPU's memory; the port's f32 leg "
                             "runs the plain compositions and takes only its default, False")
    if fp32_device and not sequential:
        raise ValueError("fp32_device requires sequential=True (the legs live on different devices)")
    norm = params["norm"]
    device = torch.device(fp32_device) if fp32_device else model.device
    if make_fp32 is not None:
        model_fp = make_fp32(model, torch.float32)
    else:
        model_fp = _with_compute_dtype(model, torch.float32, device=device, **(fp32_cfg_overrides or {}))
    base = {k: v for k, v in params.items() if k != "cache"}
    if device != model.device:
        base = _to_device(base, device)
    params_fp = model_fp.prepare_params(base)
    n_calls = _n_calls(model, n_steps)

    def fp_leg(state):
        with plain_versions(), _full_f32():
            return model_fp.advance(params_fp, state)

    curve = []
    if sequential:
        sa, bf16_out = _init(model, params, x0), []
        for _ in range(n_calls):
            sa, ya = model.advance(params, sa)
            bf16_out.append(ya.float().cpu())
        del sa
        norm_fp = {k: v.to(device) for k, v in norm.items()}
        sb = _init(model_fp, params_fp, x0)
        for t in range(n_calls):
            sb, yb = fp_leg(sb)
            curve.append(float(_rel_l2(norm_fp, bf16_out[t].to(device), yb)))
        return {"n_steps": n_steps, "rel_l2": curve, "mode": "sequential",
                "fp32_device": fp32_device or "default"}
    sa, sb = _init(model, params, x0), _init(model_fp, params_fp, x0)
    for _ in range(n_calls):
        sa, ya = model.advance(params, sa)
        sb, yb = fp_leg(sb)
        curve.append(float(_rel_l2(norm, ya, yb)))
    return {"n_steps": n_steps, "rel_l2": curve}


@torch.no_grad()
def perturbation_control(model: PrognosticModel, params: Any, x0: np.ndarray, n_steps: int, eps: float = 1e-6) -> dict:
    """fp-identical control: same dtype/kernels, ε-perturbed IC.

    Runs TWO rollouts at the model's production dtype from ``x0`` and
    ``x0 + ε·std·noise`` and reports the per-step relative L2 between
    them in normalized space.  This isolates the model's chaotic
    amplification (Lyapunov growth) from precision error: if the
    bf16-vs-fp32 divergence curve (``precision_divergence``) grows at
    the same rate as this control, the divergence is chaos amplifying
    the initial rounding difference — not accumulating kernel error —
    and the achievable step-N allclose tolerance against any reference
    is bounded below by ε·(growth rate)^N regardless of implementation.
    """
    rng = np.random.default_rng(0)
    x0 = np.asarray(x0, np.float32)
    std = params["norm"]["std"].detach().float().cpu().numpy()
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    x0p = x0 + eps * std.reshape((1, -1) + (1,) * (x0.ndim - 2)) * noise

    norm = params["norm"]
    sa, sb = _init(model, params, x0), _init(model, params, x0p)
    curve = []
    for _ in range(_n_calls(model, n_steps)):
        sa, ya = model.advance(params, sa)
        sb, yb = model.advance(params, sb)
        curve.append(float(_rel_l2(norm, ya, yb)))
    growth = (curve[-1] / max(curve[0], 1e-30)) ** (1.0 / max(len(curve) - 1, 1)) if len(curve) > 1 else 1.0
    # tolerance floor implied at the LAST step for an IC that differs by one
    # bf16 ulp (~4e-3 relative): the curve scales ~linearly in eps above the
    # ulp; below it per-step bf16 rounding dominates, so no upscaling
    implied = float(curve[-1] * min(4e-3 / eps, 1.0)) if curve else None
    return {
        "n_steps": n_steps, "eps": eps, "rel_l2": curve,
        "growth_per_step": float(growth),
        "implied_bf16_floor_last_step": implied,
    }  # fmt: skip


@torch.no_grad()
def delta_decomposition(model: PrognosticModel, params: Any, x0: np.ndarray, n_steps: int) -> dict:
    """Per-step RMS of the state AND of the state increment.

    Separates two benign random-weight behaviors from genuine numerical
    defects: residual models (GraphCast, Pangu), whose increment an
    untrained net dominates with its response to the static inputs
    (random-walk rms² ≈ rms₀² + t·rms_Δ², or linear rms ≈ b·t when it
    converges to a constant pattern), and direct-prediction models (SFNO),
    which contract toward the net's fixed point.

    Returns per-call ``rms`` (state), ``rms_delta`` (increment), the
    random-walk fit residual ``walk_fit_rel_err``, the LINEAR fit
    (``linear_fit_rel_err``, ``linear_slope`` — compare the slope to
    median rms_delta), and ``contraction_ratio`` (mean rms ratio) for
    the decay case.  Small fit residual (≲0.1) identifies the regime.
    """
    norm = params["norm"]
    state = _init(model, params, x0)
    # one frame bundle per advance call (frames_out frames), as the call emits
    prev = normalize(norm, state.x[-1].float())[None].expand(model.frames_out, *state.x.shape[1:])
    stats = []
    for _ in range(_n_calls(model, n_steps)):
        state, y = model.advance(params, state)
        yn = normalize(norm, y.float())
        stats.append(torch.stack([torch.sqrt(torch.mean(yn**2)), torch.sqrt(torch.mean((yn - prev) ** 2))]))
        prev = yn
    arr = torch.stack(stats).double().cpu().numpy()
    rms, rms_d = arr[:, 0], arr[:, 1]
    t = np.arange(1, len(rms) + 1, dtype=float)
    pred = np.sqrt(rms[0] ** 2 + (t - 1) * float(np.median(rms_d**2)))
    fit_err = float(np.linalg.norm(rms - pred) / (np.linalg.norm(rms) + 1e-12))
    ratios = rms[1:] / np.maximum(rms[:-1], 1e-30)
    A = np.vstack([t, np.ones_like(t)]).T
    coef, *_ = np.linalg.lstsq(A, rms, rcond=None)
    lin_err = float(np.linalg.norm(rms - A @ coef) / (np.linalg.norm(rms) + 1e-12))
    return {
        "rms": [float(v) for v in rms],
        "rms_delta": [float(v) for v in rms_d],
        "walk_fit_rel_err": fit_err,
        "linear_fit_rel_err": lin_err,
        "linear_slope": float(coef[0]),
        "contraction_ratio": float(np.mean(ratios)) if len(ratios) else 1.0,
    }


@torch.no_grad()
def params_divergence(model: PrognosticModel, params_a: Any, params_b: Any, x0: np.ndarray, n_steps: int) -> dict:
    """Per-step relative L2 between rollouts of the SAME model under two
    parameter trees (e.g. bf16 vs int8-at-rest weights) — the
    weight-quantization analog of ``precision_divergence``: same compute
    dtype and kernels, only the weights differ."""
    norm = params_a["norm"]
    sa, sb = _init(model, params_a, x0), _init(model, params_b, x0)
    curve = []
    for _ in range(_n_calls(model, n_steps)):
        sa, ya = model.advance(params_a, sa)
        sb, yb = model.advance(params_b, sb)
        curve.append(float(_rel_l2(norm, ya, yb)))
    return {"n_steps": n_steps, "rel_l2": curve}

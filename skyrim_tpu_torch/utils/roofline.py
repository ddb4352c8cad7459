"""Roofline accounting: MFU and %-of-HBM-roof for a model step (port of
skyrim_tpu/utils/roofline.py).

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` counts the library
  ops a step dispatches (matmuls, convolutions, attention), and each kernel
  of the port adds its declared FLOPs (``ops/cost.py``, equal to the JAX
  kernel's ``pl.CostEstimate``), so a kernel's work reads the same whatever
  implements it.
- Bytes: ``utils/op_bytes.py``, every aten op's operands and results plus
  each kernel's declared bytes.  Every loop iteration dispatches its own
  ops, so there is no ``scan_cost_extra`` to add (the JAX module adds it
  because XLA counts a while body once).
- ``floor_bytes``: every parameter byte a step reads once, the state read
  and the output written: a lower bound, from the model's ``floor_params``
  where it has one (FuXi reads one cascade stage a step).
- Peaks per device name, overridable with ``SKYRIM_PEAK_TFLOPS`` and
  ``SKYRIM_PEAK_HBM_GBS``.  The table holds NVIDIA's H100 SXM figures:
  989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM3.  A
  device not in the table with no overrides raises.

MFU = flops / (wall × peak_flops); hbm_roof = bytes / (wall × peak_bw).
A step is at speed-of-light when max(MFU, hbm_roof) → 100%.
"""

from __future__ import annotations

import os

import torch
from torch import nn

# device name substring → (bf16 FLOP/s dense, HBM bytes/s)
_PEAKS = {
    "H100": (989e12, 3.35e12),
}


def device_peaks(device=None) -> tuple[float, float]:
    """(peak_flops, peak_hbm_bytes_per_s) of ``device`` (a name, a
    ``torch.device`` or None for card 0); the environment overrides win."""
    tf = os.environ.get("SKYRIM_PEAK_TFLOPS")
    bw = os.environ.get("SKYRIM_PEAK_HBM_GBS")
    if tf and bw:
        return float(tf) * 1e12, float(bw) * 1e9
    if isinstance(device, str):
        kind = device
    elif torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        kind = torch.cuda.get_device_name(device)
    else:
        kind = str(device or "cpu")
    for key, peaks in _PEAKS.items():
        if key in kind:
            return (
                float(tf) * 1e12 if tf else peaks[0],
                float(bw) * 1e9 if bw else peaks[1],
            )
    raise ValueError(
        f"no peak rates for device {kind!r}: set SKYRIM_PEAK_TFLOPS and SKYRIM_PEAK_HBM_GBS"
    )


def step_cost(model, params, state) -> tuple[float, float]:
    """(flops, bytes_accessed) of one ``advance``: ``FlopCounterMode``'s FLOPs
    plus the kernels' declared ones; ``utils/op_bytes.py``'s bytes."""
    from skyrim_tpu_torch.utils.op_bytes import step_counts

    res = step_counts(model, params, state)
    return float(res["flops"]), float(res["bytes"])


def _tensors(tree, out: list) -> list:
    """The tensors of a parameter tree: a module's parameters and buffers,
    dict and list items, a quantized leaf's int8 values and scales."""
    from skyrim_tpu_torch.quantize import QuantizedTensor

    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, QuantizedTensor):
        out.extend((tree.q, tree.scale))
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def floor_bytes(model, params, state) -> float:
    """Strict LOWER bound on one step's HBM traffic: every resident
    parameter byte read once + the state read and the output written.

    The state counts its tensors (``x`` and ``extra``'s) and its three
    scalars (step, generator, valid time) at 4 bytes each, as the JAX
    package's state holds them as int32, a PRNG key and f32 leaves."""
    sel = getattr(model, "floor_params", None)
    if sel is not None:
        params = sel(params)
    pb = _nbytes(_tensors(params, []))
    sb = _nbytes(_tensors([state.x, state.extra], [])) + 3 * 4
    return float(pb + 2 * sb)


def roofline(
    step_wall_s: float, flops: float, bytes_: float,
    bytes_floor: float | None = None, device=None,
) -> dict:
    """MFU / HBM-roof percentages for a measured step time, under the keys
    of JAX's ``roofline``.  ``bytes_`` is the op-by-op count
    (``utils/op_bytes.py``): ops a compiler would fuse are counted apart,
    so it is an upper bound; ``bytes_floor`` (see :func:`floor_bytes`) is
    the physical lower bound."""
    peak_f, peak_b = device_peaks(device)
    mfu = flops / (step_wall_s * peak_f) if step_wall_s > 0 else 0.0
    hbm_hi = bytes_ / (step_wall_s * peak_b) if step_wall_s > 0 else 0.0
    out = {
        "flops_g": round(flops / 1e9, 1),
        "bytes_gb": round(bytes_ / 2**30, 2),
        "bytes_basis": "torch_dispatch_ops_and_kernel_cost_estimates",
        "mfu_pct": round(100 * mfu, 1),
        "hbm_roof_pct": round(100 * hbm_hi, 1),
        "peak_tflops": round(peak_f / 1e12, 1),
        "peak_hbm_gbs": round(peak_b / 1e9, 1),
    }
    if bytes_floor is not None:
        hbm_lo = bytes_floor / (step_wall_s * peak_b) if step_wall_s > 0 else 0.0
        out["bytes_floor_gb"] = round(bytes_floor / 2**30, 2)
        out["hbm_floor_pct"] = round(100 * hbm_lo, 1)
        out["bound"] = (
            "compute" if mfu >= hbm_hi
            else "memory" if hbm_lo >= mfu
            else "between-bounds"
        )
    else:
        out["bound"] = "compute" if mfu >= hbm_hi else "memory"
    return out


def model_roofline(model, params, state, step_wall_s: float, device=None) -> dict:
    """``roofline`` of one step of ``model``, its FLOPs and bytes counted on
    one ``advance`` from ``state`` (not timed) and the wall given; with the
    counts' parts (``utils/op_bytes.py``'s ``count_step``)."""
    from skyrim_tpu_torch.utils.op_bytes import step_counts

    res = step_counts(model, params, state)
    out = roofline(step_wall_s, res["flops"], res["bytes"], floor_bytes(model, params, state), device=device)
    out.update({k: res[k] for k in ("flops", "bytes", "kernel_flops", "kernel_bytes", "op_flops", "op_bytes",
                                    "kernels", "top_ops")})
    return out


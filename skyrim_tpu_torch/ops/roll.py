"""Single-pass 3-axis cyclic roll for the shifted-window frame change (K2).

Replaces ``skyrim_tpu/ops/roll.py`` ``roll3d``/``shift_roll`` (Pallas body
``_roll_kernel``): ``out[z, h, w] = x[(z+s0)%Z, (h+s1)%H, (w+s2)%W]`` on
(Z, H, W, C), i.e. ``torch.roll(x, (-s0, -s1, -s2), (0, 1, 2))``.

Bound on this card: bytes — one read and one write of the activation
(412 MB at Pangu stage 1 in bf16, ≈ 0.12 ms at 3.35 TB/s).  Design
(csrc/roll.cu): one thread per 16-byte chunk of a token's channels,
coalesced along C and then along the output tokens; the source token
is the output token with the shifts added.

On a CPU tensor ``roll3d`` runs ``plain_roll3d``; on a CUDA tensor it
launches the kernel or raises.  ``roll3d.launches`` counts the kernel's
launches, ``launches_by_shape`` the same by input shape.

Reverse mode as ``skyrim_tpu/ops/roll.py`` ``_roll_bwd``: the gradient of a
roll is the roll of the gradient by the negated shifts, so K2's backward is
a second K2 launch on a CUDA tensor (counted with the forward's) and
``plain_roll3d`` on a CPU one.
"""

from __future__ import annotations

import ctypes

import torch

from skyrim_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def plain_roll3d(x, shifts):
    return torch.roll(x, tuple(-int(s) for s in shifts), (0, 1, 2))


def _lib():
    lib = _build.load("roll")
    lib.skt_roll.argtypes = [_P, _P] + [_I] * 7 + [_P]
    lib.skt_roll.restype = _I
    return lib


def _roll(x: torch.Tensor, shifts) -> torch.Tensor:
    if x.device.type == "cpu":
        return plain_roll3d(x, shifts)
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"roll3d takes a contiguous (Z, H, W, C) tensor, got {tuple(x.shape)}")
    Z, H, Wd, C = x.shape
    row_bytes = C * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"roll3d needs 16-byte token rows, got {row_bytes} bytes")
    s0, s1, s2 = int(shifts[0]) % Z, int(shifts[1]) % H, int(shifts[2]) % Wd
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.skt_roll(
        x.data_ptr(), out.data_ptr(), Z, H, Wd, row_bytes, s0, s1, s2,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "roll3d")
    roll3d.launches += 1
    roll3d.launches_by_shape[x.shape] = roll3d.launches_by_shape.get(x.shape, 0) + 1
    return out


class _Roll3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shifts):
        ctx.shifts = shifts
        return _roll(x, shifts)

    @staticmethod
    def backward(ctx, g):
        return _roll(g.contiguous(), tuple(-int(s) for s in ctx.shifts)), None


def roll3d(x: torch.Tensor, shifts) -> torch.Tensor:
    """``out[z, h, w] = x[(z+s0)%Z, (h+s1)%H, (w+s2)%W]`` on (Z, H, W, C)."""
    return _Roll3d.apply(x, tuple(int(s) for s in shifts))


roll3d.launches = 0
roll3d.launches_by_shape = {}  # Pangu rolls at two block widths


def shift_roll(x, shift, forward: bool):
    """The shifted-window frame change: ``forward`` rolls by −shift, else by +shift."""
    s = tuple(int(v) for v in shift)
    if not any(s):
        return x
    if not forward:
        s = tuple(-v for v in s)
    return roll3d(x, s)

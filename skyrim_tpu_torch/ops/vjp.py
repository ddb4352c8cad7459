"""Reverse mode for the port's kernels, as the JAX package defines it.

The JAX package differentiates each kernel through a ``jax.custom_vjp``
whose forward runs the Pallas kernel and keeps its inputs, and whose
backward runs ``jax.vjp`` of the pure-XLA ``reference_*`` composition on
those inputs (``skyrim_tpu/ops/fused_block.py`` ``_fused_swin_block_bwd``,
``resample.py`` ``_down_bwd``/``_up_bwd``, ``fused_mlp.py`` ``_mlp_bwd``/
``_finish_bwd``, ``graph_kernels.py`` ``_m2g_bwd`` … ``_g2m_tiled_bwd``).
``with_plain_vjp`` is that rule as one ``torch.autograd.Function``: the
forward calls the wrapper's kernel path and saves the tensors it was
given; the backward replays the plain PyTorch version on them under
``torch.enable_grad()`` and hands back ``torch.autograd.grad`` of it.  The
gradient is therefore the plain composition's, whatever the kernel
rounds, and the backward launches no kernel of the port.  K2 is the one
kernel whose backward is itself (``ops/roll.py``).

Arguments may be nested tuples and lists of tensors, ``None`` and Python
values; only the tensors are the Function's inputs.  Integer tensors
(index tables, row plans) and tensors that do not require a gradient
(the shift mask) get none.

``plain_versions()`` makes every wrapper run its plain version on a CUDA
tensor too, launching nothing: the counterpart of the JAX package's
``SKYRIM_NO_PALLAS``, for the stability harness's f32 leg
(``utils/stability.py``).
"""

from __future__ import annotations

import contextlib

import torch

_PLAIN = [0]


@contextlib.contextmanager
def plain_versions():
    """Inside the block every kernel wrapper runs its plain PyTorch version,
    whatever device its tensors are on."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


def plain_only(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: ``t`` on the CPU,
    or inside ``plain_versions()``."""
    return t.device.type == "cpu" or _PLAIN[0] > 0


class _Slot:
    """Where the i-th tensor input sits in the argument skeleton."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _split(a, tensors: list):
    """``a`` with each tensor replaced by its ``_Slot``, the tensors appended
    to ``tensors``.  (A module-level function: a nested recursive one would
    sit in a reference cycle that keeps the tensors alive until the next
    garbage collection.)"""
    if torch.is_tensor(a):
        tensors.append(a)
        return _Slot(len(tensors) - 1)
    if isinstance(a, (tuple, list)):
        return type(a)(_split(v, tensors) for v in a)
    return a


def _join(skeleton, tensors):
    if isinstance(skeleton, _Slot):
        return tensors[skeleton.i]
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_join(v, tensors) for v in skeleton)
    return skeleton


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, skeleton, *tensors):
        ctx.plain, ctx.skeleton = plain, skeleton
        ctx.save_for_backward(*tensors)
        return kernel(*_join(skeleton, tensors))

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*_join(ctx.skeleton, inputs))
            outs = out if isinstance(out, tuple) else (out,)
            wrt = [t for t, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None, None, *[next(got) if n else None for n in need])


def with_plain_vjp(kernel, plain, *args):
    """``kernel(*args)`` forward; backward the gradient of ``plain(*args)``
    on the same inputs.  ``kernel`` and ``plain`` take the same arguments
    and return a tensor or a tuple of tensors of the same shapes and
    dtypes."""
    if _PLAIN[0]:
        return plain(*args)
    tensors = []
    skeleton = _split(args, tensors)
    return _PlainVJP.apply(kernel, plain, skeleton, *tensors)

"""Bytes a model step moves, counted op by op.

The port's counterpart of ``skyrim_tpu/utils/hlo_bytes.py``
(``step_physical_bytes``): there the compiled step's HLO is parsed and each
top-level instruction charged its operands' and result's bytes.  PyTorch has
no HLO; the same intent is kept by running one ``advance`` under a
``TorchDispatchMode`` that sees every aten op the step dispatches:

- an op is charged the bytes of its tensor operands and of its results: each
  tensor's distinct elements (a broadcast operand's stride-0 dims counted
  once) times its element size;
- views and aliases (``func.is_view``: ``view``, ``permute``, ``slice``,
  ``expand`` …, and this module's ``_SKIP_OPS``), metadata queries and
  factory ops (no tensor operand: ``empty``, ``zeros``, ``arange`` …) are
  charged nothing, as hlo_bytes.py's ``_SKIP_OPS`` (:44) skips parameters,
  constants, bitcasts and ``iota``;
- a copy between devices (a table built on the host moved to the card the
  first time a geometry is seen, ``ops/windows.py`` ``mask_tensor``) is
  charged nothing: it crosses the host link, not the device's memory, and
  a step on the CPU makes none;
- each kernel wrapper of the port is charged its declared bytes
  (``ops/cost.py``, equal to the JAX kernel's ``CostEstimate``), and the mode
  is suspended inside it: the ctypes launches on the card dispatch nothing
  but their outputs' allocations, and the plain versions on the CPU
  dispatch ops that are not the kernel's traffic.  A step therefore counts
  the same on the CPU and on the card.

Like the HLO walk, the count charges every intermediate a round trip to
memory: ops that a compiler would fuse are counted apart.  The step has no
loop to multiply (every iteration dispatches its own ops).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from skyrim_tpu_torch.ops import cost as _cost

# ops that return their operand's storage under another shape without
# ``is_view`` set (matmul's reshapes), or wrap a tensor
_SKIP_OPS = {"_unsafe_view", "lift_fresh", "alias", "detach"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements: stride-0 (broadcast) dims count once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


class ByteCounter(TorchDispatchMode):
    """Charges each dispatched aten op its operands' and results' bytes;
    ``total`` and ``by_op`` (op name → [calls, bytes])."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: dict[str, list[int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in tree_flatten((args, kwargs or {}))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if ins and not func.is_view and func.overloadpacket.__name__ not in _SKIP_OPS and \
                len({t.device for t in ins + outs}) == 1:
            b = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
            row = self.by_op.setdefault(func.overloadpacket.__name__, [0, 0])
            row[0] += 1
            row[1] += b
            self.total += b
        return out


@contextlib.contextmanager
def count_step():
    """Count the block's bytes and FLOPs.  Yields a dict filled on exit:
    ``kernel_bytes`` and ``kernel_flops`` (the kernels' declared costs),
    ``op_bytes`` (the aten ops'), ``op_flops`` (``FlopCounterMode``'s count of
    the library ops: matmuls, convolutions, attention), the totals
    ``bytes``/``flops``, ``kernels`` (per kernel name) and ``top_ops``.

    Order, outermost first: ``count_costs`` (a plain counter), then
    ``FlopCounterMode``, then the ``ByteCounter``: the innermost mode sees an
    op first and passes it on to ``FlopCounterMode``; a kernel wrapper
    suspends both."""
    from torch.utils.flop_counter import FlopCounterMode

    res: dict = {}
    bytes_mode = ByteCounter()
    with _cost.count_costs() as kernels:
        flops_mode = FlopCounterMode(display=False)
        with flops_mode, bytes_mode:
            yield res
    op_flops = int(flops_mode.get_total_flops())
    res.update(
        kernel_bytes=kernels.bytes_accessed, kernel_flops=kernels.flops, op_bytes=bytes_mode.total, op_flops=op_flops,
        bytes=kernels.bytes_accessed + bytes_mode.total, flops=kernels.flops + op_flops,
        kernels=kernels.as_dict()["by_kernel"],
        top_ops=sorted(([k, *v] for k, v in bytes_mode.by_op.items()), key=lambda r: -r[2])[:24],
    )


def step_counts(model, params, state) -> dict:
    """``count_step``'s dict for one ``model.advance(params, state)``."""
    with count_step() as res:
        model.advance(params, state)
    return res


def step_physical_bytes(model, params, state) -> int:
    """Bytes one ``model.advance`` moves: the aten ops' plus the kernels'
    declared bytes."""
    return step_counts(model, params, state)["bytes"]

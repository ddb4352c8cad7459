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
kernel whose backward is itself (``ops/roll.py``).  A wrapper may hand a
``replay`` of its own: the plain composition with some of its parts on
kernels that have a backward of their own (K1's attention and LayerNorms
on the card, ``ops/fused_block.py``); the backward then differentiates that
replay.

Arguments may be nested tuples and lists of tensors, ``None`` and Python
values; only the tensors are the Function's inputs.  Integer tensors
(index tables, row plans) and tensors that do not require a gradient
(the shift mask) get none.

A wrapper whose plain composition acts on independent blocks of rows
(K6's rows, K8's and K9's tile rows) passes ``chunks``, a ``RowChunks``:
where the call holds more than ``CHUNK_ROWS`` rows, the backward replays
the composition one chunk of whole blocks at a time, writes each chunk's
input gradients into their rows and sums the gradients of the uncut
inputs (the weights) over the chunks in f32.  Each row's arithmetic is
the whole replay's; only the order of those sums differs from JAX's
backward, which replays the whole composition at once.  A full-width
GraphCast step needs it: a whole replay of K6 over the 4.15 M grid→mesh
edge rows alone holds tens of GB of f32 intermediates.

``plain_versions()`` makes every wrapper run its plain version on a CUDA
tensor too, launching nothing: the counterpart of the JAX package's
``SKYRIM_NO_PALLAS``, for the stability harness's f32 leg
(``utils/stability.py``).  ``plain_forwards()`` keeps the Function but
runs the plain version forward as well (in its chunks) and replays the
plain version, never a wrapper's own ``replay``: the plain path
differentiated as each plain composition under
``torch.utils.checkpoint``, at the kernel path's memory.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

_PLAIN = [0]
_PLAIN_FORWARD = [0]

#: the rows a chunked replay takes at a time: at 512 lanes one f32
#: intermediate of a chunk is 0.5 GB, and a replay holds about a dozen
CHUNK_ROWS = 1 << 18


@contextlib.contextmanager
def plain_versions():
    """Inside the block every kernel wrapper runs its plain PyTorch version,
    whatever device its tensors are on."""
    _PLAIN[0] += 1
    try:
        yield
    finally:
        _PLAIN[0] -= 1


@contextlib.contextmanager
def plain_forwards():
    """Inside the block every wrapper that goes through ``with_plain_vjp``
    computes its plain version forward (in its chunks), launching nothing,
    and keeps only its inputs for the same replay backward."""
    _PLAIN_FORWARD[0] += 1
    try:
        yield
    finally:
        _PLAIN_FORWARD[0] -= 1


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


@dataclasses.dataclass(frozen=True)
class RowChunks:
    """A cut of a call into chunks of whole blocks: ``units`` blocks of
    ``rows`` rows each; ``args`` maps the index of each top-level argument
    that is cut to (dim, its length a block), ``out`` is the output's (dim,
    length a block).  Arguments not named (weights, tables of the whole
    call) go to every chunk whole."""

    units: int
    rows: int
    args: dict
    out: tuple

    def spans(self) -> list[tuple[int, int]]:
        """(first, end) blocks of each chunk, at most ``CHUNK_ROWS`` rows a
        chunk where a block fits."""
        n = max(1, min(self.units, -(-self.units * self.rows // CHUNK_ROWS)))
        step = -(-self.units // n)
        return [(lo, min(lo + step, self.units)) for lo in range(0, self.units, step)]

    @staticmethod
    def _cut(t, dim_len, lo, hi):
        dim, length = dim_len
        start = lo * length
        return t.narrow(dim, start, min(hi * length, t.shape[dim]) - start)

    def cut(self, args, lo, hi) -> tuple:
        return tuple(self._cut(a, self.args[i], lo, hi) if i in self.args and a is not None else a
                     for i, a in enumerate(args))

    def cut_out(self, t, lo, hi):
        return self._cut(t, self.out, lo, hi)

    def run(self, fn, *args):
        """``fn(*args)`` chunk by chunk, the outputs joined."""
        return torch.cat([fn(*self.cut(args, lo, hi)) for lo, hi in self.spans()], dim=self.out[0])


class _PlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, skeleton, chunks, *tensors):
        ctx.plain, ctx.skeleton, ctx.chunks = plain, skeleton, chunks
        ctx.save_for_backward(*tensors)
        return kernel(*_join(skeleton, tensors))

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[4:]
        if ctx.chunks is not None and len(ctx.chunks.spans()) > 1:
            got = _replay_in_chunks(ctx.plain, ctx.skeleton, ctx.chunks, ctx.saved_tensors, need, grads)
            return (None, None, None, None, *got)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*_join(ctx.skeleton, inputs))
            outs = out if isinstance(out, tuple) else (out,)
            wrt = [t for t, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None, None, None, *[next(got) if n else None for n in need])


def _replay_in_chunks(plain, skeleton, chunks, saved, need, grads) -> list:
    """The input gradients of ``plain`` over its chunks (``RowChunks``): a cut
    input's gradient written chunk by chunk into its rows, an uncut one's
    summed over the chunks in f32 and rounded once to its dtype."""
    cut = {skeleton[i].i: dl for i, dl in chunks.args.items() if isinstance(skeleton[i], _Slot)}
    out = [None] * len(saved)
    for j, t in enumerate(saved):
        if need[j] and j in cut:
            out[j] = torch.zeros_like(t)
    args = _join(skeleton, saved)
    for lo, hi in chunks.spans():
        pieces = []
        piece_skeleton = _split(chunks.cut(args, lo, hi), pieces)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(pieces, need)]
            y = plain(*_join(piece_skeleton, inputs))
            ys = y if isinstance(y, tuple) else (y,)
            wrt = [j for j, n in enumerate(need) if n]
            got = torch.autograd.grad(ys, [inputs[j] for j in wrt], [chunks.cut_out(g, lo, hi) for g in grads],
                                      allow_unused=True)
        del y, ys, inputs
        for j, g in zip(wrt, got):
            if g is None:
                continue
            if j in cut:
                chunks._cut(out[j], cut[j], lo, hi).copy_(g)
            elif out[j] is None:
                out[j] = g.float()
            else:
                out[j].add_(g)
        del got
    return [None if g is None else g.to(t.dtype) for g, t in zip(out, saved)]


def with_plain_vjp(kernel, plain, *args, chunks: RowChunks | None = None, replay=None):
    """``kernel(*args)`` forward; backward the gradient of ``plain(*args)``
    on the same inputs, chunk by chunk where ``chunks`` cuts the call into
    more than one, or of ``replay(*args)`` where it is given, outside
    ``plain_forwards()``.  ``kernel``, ``plain`` and ``replay`` take the
    same arguments and return a tensor or a tuple of tensors of the same
    shapes and dtypes (one tensor where ``chunks`` is given)."""
    if _PLAIN[0]:
        return plain(*args)
    if _PLAIN_FORWARD[0]:
        kernel = plain if chunks is None else (lambda *a: chunks.run(plain, *a))
        replay = None
    tensors = []
    skeleton = _split(args, tensors)
    return _PlainVJP.apply(kernel, replay or plain, skeleton, chunks, *tensors)

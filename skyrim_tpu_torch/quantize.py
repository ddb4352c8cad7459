"""Post-training int8 quantization (port of skyrim_tpu/quantize.py).

Two tiers, both on trees of tensors (nested dicts and lists, the
flax-layout trees of ``params.to_tree``):

* **Weight-only int8 at rest** (``quantize_tree``): symmetric scales per
  output channel (the last axis), reduced over every other axis; small or
  1-D leaves (biases, LayerNorm affines, normalisation stats) stay exact.
  A model dequantizes only the part a step uses (``maybe_dequantize``),
  so the other resident parts stay at a byte a weight.
* **int8 × int8 → int32 products** (``int8_dot``) with dynamic symmetric
  per-row activation scales, on ``torch._int_mm``; ``split_dense_int8``
  turns named Dense subtrees into the flat ``{name}_q``/``_scale``/
  ``_bias`` leaves the product consumes, with scales per layer of a
  stacked kernel.

The arithmetic follows the JAX package's order, so the int8 leaves and
scales come out equal: f32 ``amax / 127``, ``round`` (half to even in both
packages), clip to ±127; after the product ``acc.float() * xs * scale``.
"""

from __future__ import annotations

import dataclasses

import torch

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric int8 quantization of one tensor: ``q`` int8 with the
    source shape, ``scale`` f32 broadcastable to it, ``dtype`` the source
    dtype that dequantization restores."""

    q: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype = torch.bfloat16

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * 4


def _symmetric(af: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) of f32 ``af`` with the amax reduced over ``dims``.  The
    division by 127 is by a tensor: PyTorch's CUDA kernels (and XLA under
    ``jit``) turn a division by a Python scalar into a multiply by its
    reciprocal, which moves some scales by an ulp between devices."""
    amax = af.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(af / scale), -127, 127).to(torch.int8), scale


def _column_major(q: torch.Tensor) -> torch.Tensor:
    """q (…, K, N) with the last two axes stored transposed: the layout in
    which cuBLAS runs its int8 product at about the bf16 rate on an H100
    (row-major weights take a kernel 5–7× slower at FuXi's trunk shapes,
    and at some small shapes, K 16 among them, none at all)."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_array(a: torch.Tensor, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-channel int8: q = round(a / s), s = amax/127 along every
    dim except ``axis`` (the output-channel dim of a weight)."""
    dims = tuple(i for i in range(a.ndim) if i != axis % a.ndim)
    q, scale = _symmetric(a.float(), dims)
    return QuantizedTensor(q=q, scale=scale, dtype=a.dtype)


def dequantize_array(qa: QuantizedTensor) -> torch.Tensor:
    return (qa.q.float() * qa.scale).to(qa.dtype)


def _should_quantize(leaf, min_size: int) -> bool:
    return (
        torch.is_tensor(leaf) and leaf.dtype in _FLOATS and leaf.ndim >= 2 and leaf.numel() >= min_size
    )


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_tree(tree, min_size: int = 65536, axis: int = -1):
    """int8-quantize every float tensor leaf of at least 2 dims and
    ``min_size`` elements; the other leaves pass through exact."""
    return _map(lambda a: quantize_array(a, axis) if _should_quantize(a, min_size) else a, tree)


def dequantize_tree(tree):
    """Inverse of :func:`quantize_tree` (lossy: int8 rounding)."""
    return _map(lambda a: dequantize_array(a) if isinstance(a, QuantizedTensor) else a, tree)


def is_quantized(tree) -> bool:
    return any(isinstance(a, QuantizedTensor) for a in _leaves(tree))


def maybe_dequantize(tree):
    """Dequantize if needed: models call this on the part of the tree a step
    uses (one cascade stage), so only that part is ever held in the compute
    dtype."""
    return dequantize_tree(tree) if is_quantized(tree) else tree


def tree_nbytes(tree) -> int:
    """Resident bytes of a (possibly partially quantized) tree."""
    total = 0
    for a in _leaves(tree):
        if isinstance(a, QuantizedTensor):
            total += a.nbytes
        elif torch.is_tensor(a):
            total += a.numel() * a.element_size()
    return total


# --- int8 products with dynamic activation scales ------------------------------


def int8_dot(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x (…, K) f32/bf16 @ quantized w (K, N) → (…, N) in x's dtype.

    Per-row symmetric activation quantization, an int8 × int8 → int32
    product (``torch._int_mm`` on the rows flattened to 2-D, the weight
    column-major: a copy unless it is stored so), rescaled by the row
    scale, then the channel scale.  On CUDA ``torch._int_mm`` takes more
    than 16 rows and K, N multiples of 8; other shapes raise."""
    xf = x.float()
    K, N = w.q.shape
    xq, xs = _symmetric(xf, (-1,))
    a = xq.reshape(-1, K)
    if x.device.type == "cuda" and (a.shape[0] <= 16 or K % 8 or N % 8):
        raise ValueError(
            f"int8_dot on CUDA needs more than 16 rows and K, N multiples of 8 (torch._int_mm); "
            f"got rows {a.shape[0]}, K {K}, N {N}"
        )
    acc = torch._int_mm(a, w.q if w.q.stride(-2) == 1 else _column_major(w.q)).reshape(*x.shape[:-1], N)
    return (acc.float() * xs * w.scale.reshape(1, -1)).to(x.dtype)


def split_dense_int8(tree, names: tuple = ("qkv", "proj", "Dense_0", "Dense_1"), min_size: int = 65536):
    """Split a flax-layout tree for the int8 serving path.

    Named Dense subtrees whose kernels have at least 2 dims and ``min_size``
    elements become flat leaves at the parent: ``{name}_q`` (int8),
    ``{name}_scale`` (f32, reduced over the contraction dim only, so a
    stacked (P, K, N) kernel gets per-layer scales (P, 1, N)) and
    ``{name}_bias`` (exact).  ``{name}_q`` keeps the kernel's shape, stored
    column-major for ``int8_dot``.  Returns ``(rest, int8)``: ``rest`` is
    the tree without those subtrees."""

    def walk(t):
        if not isinstance(t, dict):
            return t, None
        rest, int8 = {}, {}
        for k, v in t.items():
            if (
                k in names and isinstance(v, dict) and "kernel" in v
                and v["kernel"].ndim >= 2 and v["kernel"].numel() >= min_size
            ):
                q, int8[f"{k}_scale"] = _symmetric(v["kernel"].float(), (-2,))
                int8[f"{k}_q"] = _column_major(q)
                if "bias" in v:
                    int8[f"{k}_bias"] = v["bias"]
            else:
                r, i8 = walk(v)
                rest[k] = r
                if i8:
                    int8[k] = i8
        return rest, int8

    return walk(tree)

"""Window attention with earth bias and shift mask (K5, K10, K11).

Replaces ``skyrim_tpu/ops/flash_window_attention.py``: per window and
head, ``softmax(q kᵀ·hd^-½ + bias[type] + mask[z-win, h-win]) v``.

- K5 ``fused_window_attention_4d`` (Pallas body ``_fused_kernel_4d``):
  packed (Z, H, W, 3C) qkv → (Z, H, W, C), window partition and reverse
  inside the kernel; ``EarthAttention3D.forward`` calls it.
- K10 ``fused_window_attention`` (``_fused_kernel``): partitioned packed
  rows (nWin, wlen, 3C) → (nWin, wlen, C).
- K11 ``flash_window_attention`` (``_kernel``): split q, k, v
  (nWin, heads, wlen, hd) → the same.

``bias`` is (n_types, heads, wlen, wlen), one table per (z, lat) window
position shared along the periodic longitude, or 3-D for one table;
``mask`` is (nz, nh, wlen, wlen) additive, or None.  Window t of K10/K11
has type ``t // n_lon_windows`` and mask ``(t // (nh·nw), (t // nw) % nh)``.

The CUDA kernel bodies (csrc/attention.cuh, also K1's attention) take
three token → address maps (csrc/window_attention.cu), so K1, K5, K10
and K11 share whichever body a shape takes; ``attention_body`` chooses it
from the shape alone:

- ``"registers"``, the geometries the models use — Pangu's (wlen 129–144,
  hd ≤ 32) and FuXi's and FengWu's (wlen 65–80, hd 33–64): a warp owns 16
  query rows, the scores stay in the ``mma.sync`` accumulators, softmax in
  f32 registers, ``exp2(s − max)`` cast to bf16 feeds the second product
  from registers; shared memory holds only q, k, v (double-buffered,
  ``cp.async``) and the f32 bias + mask tile, which a block reads once for
  a row of longitude windows.
- ``"shared"``, any other wlen and hd with wlen ≤ 256 after padding to 16
  and ``WLP²·4 + 3·WLP·HDP·2 + WLP·4`` bytes of shared memory (WLP, HDP:
  wlen, hd rounded up to 16) within a block's 227 KB: one block per
  (window, head), scores through a shared-memory tile.

Both divide by the f32 row sums after the second product, one bf16
rounding of each weight apart from the reference, which normalises before
its cast (that order ran 6–7 % slower in the register body on an H100).

Bound on this card: bytes (qkv, output and the f32 bias and mask tables).

On a CPU tensor each wrapper runs its plain version
(``reference_window_attention``/``_qkv``, with ``ops/windows.py`` for
K5), which autograd differentiates; on a CUDA tensor it takes contiguous
bf16, launches the kernel or raises.  The JAX package defines no VJP for
K5, K10 or K11, and no training path reaches them (Pangu, FengWu and
FuXi V1 train through K1), so on a CUDA tensor that requires a gradient
they raise ``NotImplementedError`` rather than return a result cut from
the graph.  ``<wrapper>.launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes

import torch

from skyrim_tpu_torch.ops import _build, cost
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.vjp import plain_only

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reference_window_attention(q, k, v, bias, mask, n_lon_windows):
    """(nWin, heads, wlen, hd) q/k/v → softmax(q kᵀ·scale + bias + mask) v."""
    n_win, heads, wlen, hd = q.shape
    s = torch.einsum("whqd,whkd->whqk", q.float(), k.float()) * (hd**-0.5)
    if bias.ndim == 3:
        bias = bias[None]
    nt = bias.shape[0]
    s = s.reshape(nt, n_win // nt, heads, wlen, wlen) + bias[:, None].float()
    s = s.reshape(n_win, heads, wlen, wlen)
    if mask is not None:
        nz, nh = mask.shape[:2]
        s = s.reshape(nz, nh, n_lon_windows, heads, wlen, wlen) + mask[:, :, None, None]
        s = s.reshape(n_win, heads, wlen, wlen)
    s = torch.softmax(s, dim=-1)
    return torch.einsum("whqk,whkd->whqd", s, v.float()).to(q.dtype)


def reference_window_attention_qkv(qkv, bias, mask, n_lon_windows, heads):
    """Packed (nWin, wlen, 3C) qkv → (nWin, wlen, C)."""
    n_win, wlen, c3 = qkv.shape
    C = c3 // 3
    parts = qkv.reshape(n_win, wlen, 3, heads, C // heads)
    q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
    out = reference_window_attention(q, k, v, bias, mask, n_lon_windows)
    return out.transpose(1, 2).reshape(n_win, wlen, C)


def reference_window_attention_4d(qkv, bias, mask, window, heads):
    """Packed (Z, H, W, 3C) qkv → (Z, H, W, C): partition, attention, reverse."""
    Z, H, Wd, _ = qkv.shape
    out = reference_window_attention_qkv(W.window_partition(qkv, window), bias, mask, Wd // window[2], heads)
    return W.window_reverse(out, window, (Z, H, Wd))


def _tables(bias, mask, n_win, nw, heads, wlen, what):
    """The bias as (n_types, heads, wlen, wlen) and the (nz, nh) of the mask,
    checked against the window count as the reference asserts them."""
    if bias.ndim == 3:
        bias = bias[None]
    n_types = bias.shape[0]
    if tuple(bias.shape[1:]) != (heads, wlen, wlen):
        raise ValueError(f"{what}: bias shape {tuple(bias.shape)} for {heads} heads, wlen {wlen}")
    nz, nh = (1, 1) if mask is None else mask.shape[:2]
    if mask is not None and tuple(mask.shape) != (nz, nh, wlen, wlen):
        raise ValueError(f"{what}: mask shape {tuple(mask.shape)} for wlen {wlen}")
    if n_win != nz * nh * nw and (nz, nh) != (1, 1):
        raise ValueError(f"{what}: windows {n_win} != {nz}x{nh}x{nw}")
    if n_types != 1 and n_win != n_types * nw:
        raise ValueError(f"{what}: windows {n_win} != {n_types} types x {nw} lon windows")
    return bias, n_types, nz * nh


def _lib():
    lib = _build.load("window_attention")
    lib.skt_attention_4d.argtypes = [_P] * 4 + [_I] * 10 + [_F, _I, _P]
    lib.skt_attention_rows.argtypes = [_P] * 4 + [_I] * 8 + [_F, _I, _P]
    lib.skt_attention_split.argtypes = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
    for fn in (lib.skt_attention_4d, lib.skt_attention_rows, lib.skt_attention_split):
        fn.restype = _I
    return lib


BODIES = ("shared", "registers")  # attention::Body in csrc/attention.cuh
# (WLP, largest hd) of the register body's instantiations: hd in (HDP - 32, HDP]
_REGISTER_SHAPES = ((144, 32), (80, 64))


def attention_body(wlen: int, hd: int) -> str:
    """The kernel body a (wlen, hd) window takes, by shape alone:
    ``"registers"`` (scores in registers) for the models' geometries,
    ``"shared"`` (scores in a shared-memory tile) for any other window that
    fits; raises ``ValueError`` for one that no body takes."""
    wlp, hdp = -(-wlen // 16) * 16, -(-hd // 16) * 16
    if any(wlp == w and h - 32 < hd <= h for w, h in _REGISTER_SHAPES):
        return "registers"
    smem = wlp * wlp * 4 + 3 * wlp * hdp * 2 + wlp * 4
    if wlp > 256 or smem > _build.MAX_SMEM:
        shapes = ", ".join(f"wlen {w - 15}-{w} with hd {h - 31}-{h}" for w, h in _REGISTER_SHAPES)
        raise ValueError(
            f"window attention: wlen {wlen}, hd {hd} need {smem} bytes of shared memory for the score tile; "
            f"the register body takes {shapes}, the shared-memory body wlen <= 256 and "
            f"WLP^2*4 + 3*WLP*HDP*2 + WLP*4 <= {_build.MAX_SMEM} (WLP, HDP: wlen, hd rounded up to 16)"
        )
    return "shared"


def _require(what, wlen, hd, *tensors):
    """Raise unless the tensors are contiguous bf16 CUDA tensors and a body
    takes the window; returns whether their rows load 16 bytes at a time, and
    the body's number."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                f"{what} takes contiguous bf16 CUDA tensors, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})"
            )
    body = BODIES.index(attention_body(wlen, hd))
    return int(hd % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)), body


def _f32_tables(bias, mask, device):
    for name, t in (("bias", bias), ("mask", mask)):
        if t is not None and t.device != device:
            raise ValueError(f"window attention: {name} on {t.device}, qkv on {device}")
    bias = bias.detach().to(torch.float32).contiguous()
    mask = mask.detach().to(torch.float32).contiguous() if mask is not None else None
    return bias, mask, (mask.data_ptr() if mask is not None else None)


def _lon_windows(nw, n_types, n_masks):
    """The kernel groups windows by nw only to pick a table; with one bias
    and at most one mask table nw need not divide the window count."""
    return nw if n_types > 1 or n_masks > 1 else 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _refuse_grad(what, *tensors):
    """Raise where the result would need a gradient: the kernel has no
    backward, in the JAX package or here."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no backward (the JAX package defines no VJP for it); finetuning (ROADMAP §1 item 9) "
            "trains window attention through K1 (ops.fused_block.fused_swin_block)"
        )


def attention_4d(qkv, bias, mask, window, heads, lib, fn, what):
    """Check a packed (Z, H, W, 3C) CUDA qkv and launch ``fn`` of ``lib`` on it
    (K5's kernel here, K1's copy of it in ops/fused_block.py)."""
    if qkv.ndim != 4 or qkv.shape[3] % 3:
        raise ValueError(f"{what} takes a packed (Z, H, W, 3C) qkv, got {tuple(qkv.shape)}")
    Z, H, Wd, C3 = qkv.shape
    C = C3 // 3
    wz, wh, ww = window
    if Z % wz or H % wh or Wd % ww or C % heads:
        raise ValueError(f"{what}: {tuple(qkv.shape)} does not tile by {window}/{heads} heads")
    wlen, hd = wz * wh * ww, C // heads
    nz, nh, nw = Z // wz, H // wh, Wd // ww
    bias, n_types, _ = _tables(bias, mask, nz * nh * nw, nw, heads, wlen, what)
    if mask is not None and tuple(mask.shape[:2]) != (nz, nh):
        raise ValueError(f"{what}: mask shape {tuple(mask.shape)} != {(nz, nh, wlen, wlen)}")
    vec, body = _require(what, wlen, hd, qkv)
    bias, mask, mask_ptr = _f32_tables(bias, mask, qkv.device)
    out = torch.empty((Z, H, Wd, C), dtype=torch.bfloat16, device=qkv.device)
    err = fn(qkv.data_ptr(), bias.data_ptr(), mask_ptr, out.data_ptr(), Z, H, Wd, C, heads,
             wz, wh, ww, n_types, vec, hd**-0.5, body, _stream(qkv))  # fmt: skip
    _build.check(lib, err, what)
    return out


def fused_window_attention_4d(qkv, bias, mask, window, heads):
    """K5: window partition + attention + reverse on a window-padded packed
    (Z, H, W, 3C) qkv → (Z, H, W, C), heads merged."""
    with cost.kernel("K5", cost.window_attention_4d, qkv, window, heads):
        return _window_attention_4d(qkv, bias, mask, window, heads)


def _window_attention_4d(qkv, bias, mask, window, heads):
    if plain_only(qkv):
        return reference_window_attention_4d(qkv, bias, mask, window, heads)
    _refuse_grad("fused_window_attention_4d", qkv, bias, mask)
    lib = _lib()
    out = attention_4d(qkv, bias, mask, window, heads, lib, lib.skt_attention_4d, "fused_window_attention_4d")
    fused_window_attention_4d.launches += 1
    return out


fused_window_attention_4d.launches = 0


def fused_window_attention(qkv, bias, mask, n_lon_windows, heads):
    """K10: attention on partitioned packed rows (nWin, wlen, 3C) →
    (nWin, wlen, C), heads merged."""
    with cost.kernel("K10", cost.window_attention_rows, qkv, heads):
        return _window_attention_rows(qkv, bias, mask, n_lon_windows, heads)


def _window_attention_rows(qkv, bias, mask, n_lon_windows, heads):
    what = "fused_window_attention"
    if qkv.ndim != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"{what} takes a packed (nWin, wlen, 3C) qkv, C divisible by heads, got {tuple(qkv.shape)}")
    n_win, wlen, c3 = qkv.shape
    C = c3 // 3
    bias, n_types, n_masks = _tables(bias, mask, n_win, n_lon_windows, heads, wlen, what)
    if plain_only(qkv):
        return reference_window_attention_qkv(qkv, bias, mask, n_lon_windows, heads)
    _refuse_grad(what, qkv, bias, mask)
    hd = C // heads
    vec, body = _require(what, wlen, hd, qkv)
    bias, mask, mask_ptr = _f32_tables(bias, mask, qkv.device)
    out = torch.empty((n_win, wlen, C), dtype=torch.bfloat16, device=qkv.device)
    lib = _lib()
    err = lib.skt_attention_rows(
        qkv.data_ptr(), bias.data_ptr(), mask_ptr, out.data_ptr(), n_win, wlen, C, heads,
        _lon_windows(n_lon_windows, n_types, n_masks), n_types, n_masks, vec, hd**-0.5, body, _stream(qkv),
    )
    _build.check(lib, err, what)
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0


def flash_window_attention(q, k, v, bias, mask, n_lon_windows):
    """K11: attention over independent windows with split heads; q, k, v and
    the result (nWin, heads, wlen, hd)."""
    with cost.kernel("K11", cost.window_attention_split, q):
        return _window_attention_split(q, k, v, bias, mask, n_lon_windows)


def _window_attention_split(q, k, v, bias, mask, n_lon_windows):
    what = "flash_window_attention"
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what} takes q, k, v of one (nWin, heads, wlen, hd) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n_win, heads, wlen, hd = q.shape
    bias, n_types, n_masks = _tables(bias, mask, n_win, n_lon_windows, heads, wlen, what)
    if plain_only(q):
        return reference_window_attention(q, k, v, bias, mask, n_lon_windows)
    _refuse_grad(what, q, k, v, bias, mask)
    vec, body = _require(what, wlen, hd, q, k, v)
    bias, mask, mask_ptr = _f32_tables(bias, mask, q.device)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.skt_attention_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mask_ptr, out.data_ptr(),
        n_win, heads, wlen, hd, _lon_windows(n_lon_windows, n_types, n_masks), n_types, n_masks,
        vec, hd**-0.5, body, _stream(q),
    )
    _build.check(lib, err, what)
    flash_window_attention.launches += 1
    return out


flash_window_attention.launches = 0


"""GraphCast's message-passing kernels K7-K9 and their untiled
predecessors K13-K14.

- K7 ``fused_round_messages`` replaces ``skyrim_tpu/ops/graph_kernels.py``
  ``fused_round_messages`` (body ``_round_kernel``): one multimesh
  processor round over dst-sorted edge blocks — dst-row expansion, edge
  GEMM, finish, residual edge update, segment aggregation.  Four
  launches: the ``wgmma`` row GEMM with the expansion and swish in its
  epilogue (csrc/graph_round.cu), the second Dense, the LayerNorm rows
  kernel with the edges as residual, and the segmented sum
  (csrc/fused_mlp.cu, csrc/rowgemm.cuh), which sums runs of equal ids in
  registers and is fastest on the plan's sorted ids.
- K8 ``fused_m2g_tiled`` replaces ``fused_m2g_tiled`` (body
  ``_m2g_tiled_kernel``): the mesh→grid decoder over face tiles, the sum
  over the 3 slots of finish(face row + bias + dst row), in one launch
  (csrc/rowgemm.cuh ``rows_ln_kernel`` on tiles of 21 points = 63 rows:
  bias rows by TMA, the prologue a point at a time by producer warps, the
  Dense by ``wgmma``, the LayerNorm and the slot sum in the epilogue).
  csrc/graph_m2g.cu.
- K9 ``fused_g2m_tiled`` replaces ``fused_g2m_tiled`` (body
  ``_g2m_tiled_kernel``): the grid→mesh encoder, grid-major over spatial
  tiles, returning (TH, TW, U, L) tile partials.  Only the filled slots
  run, in the dst-sorted order of the row plan (``ops.graph.g2m_row_plan``,
  built once with the tables): one launch computes their messages (swish
  prologue once a row, the Dense by ``wgmma``, the LayerNorm in the
  epilogue; csrc/rowgemm.cuh ``rows_ln_kernel``), a second sums each
  destination's rows in order (CSR sum).  csrc/graph_g2m.cu.

- K13 ``fused_fixed_degree_messages`` replaces ``fused_fixed_degree_messages``
  (body ``_m2g_kernel``): K8 on flat wide rows, without the tile lookup; any
  ``deg`` from 1 to 4, one launch of ``rows_ln_kernel<deg>`` (tiles of
  ``rows_ln_tile(deg)`` points: the bias rows by TMA, each point's wide
  slices and dst row loaded and its ``deg`` rows computed in place, the
  Dense by ``wgmma``, the LayerNorm and the slot sum in the epilogue).  No
  (N·deg, L) intermediate is written.  csrc/graph_finish.cu.
- K14 ``fused_block_messages`` replaces ``fused_block_messages`` (body
  ``_g2m_kernel``): grid→mesh messages over block-plan rows, finish(src +
  bias) then the sum of each block's rows into its SB segments; ``local``
  need not be sorted, ``local == SB`` marks padding.  Two launches:
  ``block_messages`` (the (B·M, L) messages in row order, one launch of
  ``rows_ln_kernel<1>``), then the segmented sum (csrc/fused_mlp.cu), whose
  block keeps SB·512 + M·4 bytes of sums and ids in shared memory, at most
  227 KB (the full-width plan, M 8192 and SB 328, takes 200,704).
  csrc/graph_finish.cu + csrc/fused_mlp.cu.

``rows_ln_kernel`` holds whole rows of up to 512 columns a block, so K8,
K9, K13 and K14 refuse L > 512 on a CUDA tensor.

The TPU kernels expand and aggregate with one-hot matmuls on the MXU;
here an expansion is an indexed load and an aggregation a segmented sum
in f32 (csrc/rowgemm.cuh; K9's by CSR ranges, csrc/graph_g2m.cu).  Each
slot sum (K8, K9, K13) is taken in f32
and rounded once.  Bounds and designs are in the CUDA sources' headers.

Each wrapper takes its plain PyTorch version (``reference_*``) on a CPU
tensor and launches the kernels or raises on a CUDA tensor.  Reverse mode
is JAX's ``_round_bwd``, ``_m2g_tiled_bwd``, ``_g2m_tiled_bwd``,
``_m2g_bwd`` and ``_g2m_bwd`` (``ops/vjp.py``): the backward differentiates
the plain version on the saved inputs; the static tables (``local``,
``local_hw``, ``local_t``) and K9's row plan get no gradient; K8 and K9
replay whole tile rows at a time where the call is large (``RowChunks``).
``launches`` counts wrapper calls that launched (K7 also
``launches_by_shape``; ``block_messages.launches`` K14's messages
launches).
"""

from __future__ import annotations

import ctypes

import torch

from skyrim_tpu_torch.ops import _build, cost
from skyrim_tpu_torch.ops.fused_block import _EPS, _bf16, _f32
from skyrim_tpu_torch.ops.fused_mlp import (
    _stream,
    check_segment_sum,
    ln_rows,
    mlp_gemm,
    reference_finish,
    require,
    require_rows16,
    segment_sum,
)
from skyrim_tpu_torch.ops.graph import block_onehot, g2m_row_plan
from skyrim_tpu_torch.ops.vjp import RowChunks, with_plain_vjp

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# --- plain versions ----------------------------------------------------------


def reference_round_messages(edges, gsrc, staged, local, we, b0, wb, ln, SB):
    """One processor round over (B, M, L) edge blocks → (new_edges, agg (B, SB, L))."""
    B, M, L = edges.shape
    dt = edges.dtype
    oh = block_onehot(local, SB, torch.float32)  # (B, SB, M)
    expand = torch.einsum("bsm,bsd->bmd", oh, staged.float())
    h = edges.float() @ we.to(dt).float() + gsrc.float() + expand
    m = reference_finish(h, b0, wb, ln, dt)
    ne = (edges.float() + m.float()).to(dt)
    agg = torch.einsum("bsm,bmd->bsd", oh, ne.float()).to(dt)
    return ne, agg


def reference_fixed_degree_messages(wide, bias_w, ad, b0, wb, ln, deg):
    """Σ_k finish(wide_k + bias_k + ad) over flat rows; wide/bias_w (N, deg·L),
    ad (N, L) → (N, L), the slot sum in f32."""
    L = wide.shape[1] // deg
    agg = None
    for k in range(deg):
        sl = slice(k * L, (k + 1) * L)
        h = wide[:, sl].float() + bias_w[:, sl].float() + ad.float()
        m = reference_finish(h, b0, wb, ln, wide.dtype).float()
        agg = m if agg is None else agg + m
    return agg.to(wide.dtype)


def reference_block_messages(src_rows, bias_b, local, b0, wb, ln, SB):
    """Per block finish(src + bias), then the f32 sum of the rows with each
    local id < SB → (B, SB, L); id SB is a padding row."""
    B, M, L = src_rows.shape
    dt = src_rows.dtype
    m = reference_finish((src_rows.float() + bias_b.float()).reshape(B * M, L), b0, wb, ln, dt)
    acc = torch.zeros((B, SB + 1, L), dtype=torch.float32, device=src_rows.device)
    idx = torch.where((local >= 0) & (local < SB), local, SB).long()
    acc.scatter_add_(1, idx[..., None].expand(-1, -1, L), m.float().reshape(B, M, L))
    return acc[:, :SB].to(dt)


def reference_m2g_tiled(uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th, tw):
    """Per-point face row from the tile tables, then the fixed-degree sum."""
    H, W = local_hw.shape
    KL = bias_hw.shape[-1]
    dev = uniq.device
    ti = torch.arange(H, device=dev) // th
    tj = torch.arange(W, device=dev) // tw
    wide = uniq[ti[:, None], tj[None, :], local_hw.long()]  # (H, W, KL)
    agg = reference_fixed_degree_messages(
        wide.reshape(H * W, KL), bias_hw.reshape(H * W, KL), ad_hw.reshape(H * W, -1), b0, wb, ln, deg
    )
    return agg.reshape(H, W, -1)


def reference_g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw):
    """Grid-major encoder messages + per-tile aggregation into (TH, TW, U, L)."""
    H, W, L = asrc_hw.shape
    dt = asrc_hw.dtype
    TH, TW = H // th, W // tw
    acc = torch.zeros((TH * TW, U + 1, L), dtype=torch.float32, device=asrc_hw.device)
    for k in range(D):
        h = asrc_hw.float() + bias_hw[:, :, k * L : (k + 1) * L].float()
        m = reference_finish(h.reshape(H * W, L), b0, wb, ln, dt).float()
        m = m.reshape(TH, th, TW, tw, L).permute(0, 2, 1, 3, 4).reshape(TH * TW, th * tw, L)
        idx = local_t[:, :, k, :].reshape(TH * TW, th * tw).long()
        acc.scatter_add_(1, idx[..., None].expand(-1, -1, L), m)  # id U = empty slot
    return acc[:, :U].to(dt).reshape(TH, TW, U, L)


# --- kernels -------------------------------------------------------------------


def _lib(name: str, fn: str, argtypes):
    lib = _build.load(name)
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = _I
    return lib


def fused_round_messages(edges, gsrc, staged, local, we, b0, wb, ln, SB):
    """One multimesh processor round over dst-sorted edge blocks.

    edges/gsrc: (B, M, L) edge latents and gathered src-part rows; staged:
    (B, SB, L) dst-part rows per block segment; local: (B, M) int32 block-local
    segment ids (== SB ⇒ padding); we: (L, L) edge-part kernel slice; b0:
    (L,); wb: ((L, L), (L,)); ln: (scale, bias).  Returns (new_edges (B, M,
    L), agg (B, SB, L))."""
    with cost.kernel("K7", cost.round_messages, edges, SB):
        return with_plain_vjp(_round_messages, reference_round_messages, edges, gsrc, staged, local, we, b0, wb, ln,
                              SB)


def _round_messages(edges, gsrc, staged, local, we, b0, wb, ln, SB):
    if edges.device.type == "cpu":
        return reference_round_messages(edges, gsrc, staged, local, we, b0, wb, ln, SB)
    B, M, L = edges.shape
    if L % 8:
        raise ValueError(f"fused_round_messages takes L % 8 == 0, got {L}")
    require(edges, (B, M, L), "round edges")
    require(gsrc, (B, M, L), "round gsrc")
    require(staged, (B, SB, L), "round staged")
    require(local, (B, M), "round local", torch.int32)
    rows = B * M
    e2 = edges.view(rows, L)
    h = torch.empty((rows, L), dtype=torch.bfloat16, device=edges.device)
    we, b0 = _bf16(we), _f32(b0)  # held until the launch is queued
    lib = _lib("graph_round", "skt_round_gemm", [_P] * 7 + [_I] * 4 + [_P])
    err = lib.skt_round_gemm(
        e2.data_ptr(), we.data_ptr(), b0.data_ptr(), gsrc.data_ptr(), staged.data_ptr(),
        local.data_ptr(), h.data_ptr(), rows, L, M, SB, _stream(edges),
    )
    _build.check(lib, err, "round_gemm")
    y = mlp_gemm(h, _bf16(wb[0]), _f32(wb[1]))
    del h
    ne = ln_rows(y, ln, residual=e2, out=y)
    agg = segment_sum(ne, local, SB)
    fused_round_messages.launches += 1
    key = (B, M, L, SB)
    fused_round_messages.launches_by_shape[key] = fused_round_messages.launches_by_shape.get(key, 0) + 1
    return ne.view(B, M, L), agg


fused_round_messages.launches = 0
fused_round_messages.launches_by_shape = {}  # (B, M, L, SB)


def fused_m2g_tiled(uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th, tw):
    """Fixed-degree mesh→grid messages over (th, tw) spatial tiles.

    uniq: (TH, TW, U, deg·L) per-tile unique wide face rows; local_hw: (H, W)
    int32 index of each point into its tile's rows (from
    ``ops.graph.build_face_tiles``); bias_hw: (H, W, deg·L); ad_hw: (H, W, L).
    The tiles need not divide the grid.  Returns (H, W, L)."""
    with cost.kernel("K8", cost.m2g_tiled, uniq, bias_hw, deg):
        tiles = RowChunks(uniq.shape[0], th * local_hw.shape[1] * deg, {0: (0, 1), 1: (0, th), 2: (0, th), 3: (0, th)},
                          (0, th))
        return with_plain_vjp(_m2g_tiled, reference_m2g_tiled, uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th,
                              tw, chunks=tiles)


def _m2g_tiled(uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th, tw):
    if uniq.device.type == "cpu":
        return reference_m2g_tiled(uniq, local_hw, bias_hw, ad_hw, b0, wb, ln, deg, th, tw)
    H, W = local_hw.shape
    TH, TW, U, KL = uniq.shape
    L = KL // deg
    if deg != 3 or L % 8 or (TH, TW) != (-(-H // th), -(-W // tw)):
        raise ValueError(f"fused_m2g_tiled: deg {deg} (takes 3), L {L} (% 8), tiles {(TH, TW)} for {(H, W)}/{(th, tw)}")
    if L > 512:
        raise ValueError(f"fused_m2g_tiled takes L <= 512 (one block holds whole rows), got {L}")
    require(local_hw, (H, W), "m2g local", torch.int32)
    require(bias_hw, (H, W, KL), "m2g bias")
    require(ad_hw, (H, W, L), "m2g ad")
    require(uniq, (TH, TW, U, KL), "m2g uniq")
    require_rows16("fused_m2g_tiled", uniq, bias_hw, ad_hw)
    out = torch.empty((H, W, L), dtype=torch.bfloat16, device=uniq.device)
    b0, w, b = _f32(b0), _bf16(wb[0]), _f32(wb[1])  # held until the launch is queued
    scale, shift = _f32(ln[0]), _f32(ln[1])
    lib = _m2g_lib()
    err = lib.skt_m2g_messages(
        uniq.data_ptr(), local_hw.data_ptr(), bias_hw.data_ptr(), ad_hw.data_ptr(), b0.data_ptr(), w.data_ptr(),
        b.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), H, W, L, U, th, tw, TW, _EPS,
        _stream(uniq),
    )
    _build.check(lib, err, "m2g_messages")
    fused_m2g_tiled.launches += 1
    return out


fused_m2g_tiled.launches = 0


def _m2g_lib():
    return _lib("graph_m2g", "skt_m2g_messages", [_P] * 10 + [_I] * 7 + [_F, _P])


def g2m_plan(local_t, U, th, tw):
    """``ops.graph.g2m_row_plan`` of ``local_t`` as int32 tensors on its
    device: (rows (E,), csr (TH·TW·U + 1,))."""
    rows, csr = g2m_row_plan(local_t.cpu().numpy(), U, th, tw)
    return (torch.from_numpy(rows).to(local_t.device), torch.from_numpy(csr).to(local_t.device))


def g2m_messages(asrc_hw, bias_hw, rows, b0, wb, ln, D):
    """The messages of the plan's E filled slots in its order, (E, L), in one
    launch: ``LN(bf16(bf16(swish(asrc[rows // D] + bias[rows] + b0)) @ W + b))``."""
    H, W, L = asrc_hw.shape
    E = rows.shape[0]
    m = torch.empty((E, L), dtype=torch.bfloat16, device=asrc_hw.device)
    if E == 0:
        return m
    if L > 512:
        raise ValueError(f"g2m_messages takes L <= 512 (one block holds whole rows), got {L}")
    b0, w, b = _f32(b0), _bf16(wb[0]), _f32(wb[1])  # held until the launch is queued
    scale, shift = _f32(ln[0]), _f32(ln[1])
    lib = _g2m_lib()
    err = lib.skt_g2m_messages(
        asrc_hw.data_ptr(), bias_hw.data_ptr(), b0.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), rows.data_ptr(), m.data_ptr(), E, L, D, _EPS, _stream(asrc_hw),
    )
    _build.check(lib, err, "g2m_messages")
    return m


def csr_sum(x, csr):
    """(E, C) rows and (n + 1,) int32 offsets → (n, C): destination d's bf16
    sum of rows csr[d] .. csr[d + 1] in order, in f32; empty ranges give 0."""
    n, C = csr.shape[0] - 1, x.shape[1]
    if C % 8 or n <= 0:
        raise ValueError(f"csr_sum takes C % 8 == 0 and n > 0, got C {C}, n {n}")
    require(x, x.shape, "csr_sum x")
    require(csr, (n + 1,), "csr_sum csr", torch.int32)
    out = torch.empty((n, C), dtype=torch.bfloat16, device=x.device)
    lib = _g2m_lib()
    err = lib.skt_csr_sum(x.data_ptr(), csr.data_ptr(), out.data_ptr(), n, C, _stream(x))
    _build.check(lib, err, "csr_sum")
    return out


def _g2m_lib():
    lib = _lib("graph_g2m", "skt_g2m_messages", [_P] * 9 + [_I] * 3 + [_F, _P])
    lib.skt_csr_sum.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    lib.skt_csr_sum.restype = _I
    return lib


def fused_g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw, plan=None):
    """Grid-major grid→mesh messages over (th, tw) spatial tiles.

    asrc_hw: (H, W, L) per-point src-part rows; bias_hw: (H, W, D·L) cached
    static per-slot bias; local_t: (TH, TW, D, th·tw) int32 slot → tile-local
    dst index (== U ⇒ empty).  plan: ``g2m_plan(local_t, U, th, tw)`` built
    once with the tables; without it the plan is built here from
    ``local_t``.  Returns (TH, TW, U, L) tile partials."""
    with cost.kernel("K9", cost.g2m_tiled, asrc_hw, D, U, th, tw):
        tiles = RowChunks(local_t.shape[0], th * asrc_hw.shape[1] * D, {0: (0, th), 1: (0, th), 2: (0, 1)}, (0, 1))
        return with_plain_vjp(_g2m_tiled, _plain_g2m_tiled, asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw,
                              plan, chunks=tiles)


def _plain_g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw, plan=None):
    return reference_g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw)


def _g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw, plan=None):
    if asrc_hw.device.type == "cpu":
        return _plain_g2m_tiled(asrc_hw, bias_hw, local_t, b0, wb, ln, D, U, th, tw)
    H, W, L = asrc_hw.shape
    if H % th or W % tw or L % 8:
        raise ValueError(f"fused_g2m_tiled: tiles {(th, tw)} must cover {(H, W)} exactly, L {L} % 8")
    TH, TW = H // th, W // tw
    require(asrc_hw, (H, W, L), "g2m asrc")
    require(bias_hw, (H, W, D * L), "g2m bias")
    require(local_t, (TH, TW, D, th * tw), "g2m local", torch.int32)
    rows, csr = plan if plan is not None else g2m_plan(local_t, U, th, tw)
    require(rows, (rows.shape[0],), "g2m plan rows", torch.int32)
    m = g2m_messages(asrc_hw, bias_hw, rows, b0, wb, ln, D)
    out = csr_sum(m, csr)
    fused_g2m_tiled.launches += 1
    return out.view(TH, TW, U, L)


fused_g2m_tiled.launches = 0


def rows_ln_tile(group):
    """(rows, points) of one ``rows_ln_kernel<group>`` tile (csrc/rowgemm.cuh
    ``rowln::ROWS``): whole groups of ``group`` slot rows within the 64-row
    ``wgmma`` tile, so 64, 32, 21 or 16 points for group 1 to 4."""
    if group not in (1, 2, 3, 4):
        raise ValueError(f"rows_ln_kernel takes 1 to 4 slot rows a point, got {group}")
    rows = 64 - 64 % group
    return rows, rows // group


def _messages_lib():
    lib = _build.load("graph_finish")
    lib.skt_fixed_degree_messages.argtypes = [_P] * 9 + [_I] * 3 + [_F, _P]
    lib.skt_block_messages.argtypes = [_P] * 8 + [_I] * 2 + [_F, _P]
    lib.skt_fixed_degree_messages.restype = lib.skt_block_messages.restype = _I
    return lib


def fused_fixed_degree_messages(wide, bias_w, ad, b0, wb, ln, deg):
    """Fixed-degree messages per row: Σ_k finish(wide_k + bias_k + ad) (K13).

    wide/bias_w: (N, deg·L) source rows and cached bias, slot-major lane
    slices; ad: (N, L) dst-part rows; b0: (L,); wb: ((L, L), (L,)); ln over L;
    deg 1 to 4, L ≤ 512 on a CUDA tensor.  Returns (N, L)."""
    with cost.kernel("K13", cost.fixed_degree_messages, wide, deg):
        return with_plain_vjp(_fixed_degree_messages, reference_fixed_degree_messages, wide, bias_w, ad, b0, wb, ln,
                              deg)


def _fixed_degree_messages(wide, bias_w, ad, b0, wb, ln, deg):
    if wide.device.type == "cpu":
        return reference_fixed_degree_messages(wide, bias_w, ad, b0, wb, ln, deg)
    if wide.ndim != 2 or deg not in (1, 2, 3, 4) or wide.shape[1] % (8 * deg) or wide.shape[0] * deg >= 2**31:
        raise ValueError(f"fused_fixed_degree_messages takes (N, deg·L) rows, deg 1 to 4, L % 8 == 0, got {tuple(wide.shape)}, deg {deg}")
    N, KL = wide.shape
    L = KL // deg
    if L > 512:
        raise ValueError(f"fused_fixed_degree_messages takes L <= 512 (one block holds whole rows), got {L}")
    require(wide, (N, KL), "fixed-degree wide")
    require(bias_w, (N, KL), "fixed-degree bias")
    require(ad, (N, L), "fixed-degree ad")
    require_rows16("fused_fixed_degree_messages", wide, bias_w, ad)
    if tuple(wb[0].shape) != (L, L):
        raise ValueError(f"fused_fixed_degree_messages: kernel {tuple(wb[0].shape)} for L {L}")
    out = torch.empty((N, L), dtype=torch.bfloat16, device=wide.device)
    if N == 0:
        return out
    b0, w, b = _f32(b0), _bf16(wb[0]), _f32(wb[1])  # held until the launch is queued
    scale, shift = _f32(ln[0]), _f32(ln[1])
    lib = _messages_lib()
    err = lib.skt_fixed_degree_messages(
        wide.data_ptr(), bias_w.data_ptr(), ad.data_ptr(), b0.data_ptr(), w.data_ptr(), b.data_ptr(),
        scale.data_ptr(), shift.data_ptr(), out.data_ptr(), N, L, deg, _EPS, _stream(wide),
    )
    _build.check(lib, err, "fixed_degree_messages")
    fused_fixed_degree_messages.launches += 1
    return out


fused_fixed_degree_messages.launches = 0


def block_messages(src, bias, b0, wb, ln):
    """K14's messages in one launch: ``LN(bf16(bf16(swish(src + bias + b0)) @
    W + b))`` over (M, L) rows in order → (M, L); L % 8 == 0, L ≤ 512."""
    M, L = src.shape
    if L % 8 or L > 512 or tuple(wb[0].shape) != (L, L):
        raise ValueError(f"block_messages takes L % 8 == 0, L <= 512 (one block holds whole rows) and an (L, L) "
                         f"kernel, got L {L}, kernel {tuple(wb[0].shape)}")
    require(src, (M, L), "block src rows")
    require(bias, (M, L), "block bias rows")
    require_rows16("block_messages", src, bias)
    m = torch.empty((M, L), dtype=torch.bfloat16, device=src.device)
    if M == 0:
        return m
    b0, w, b = _f32(b0), _bf16(wb[0]), _f32(wb[1])  # held until the launch is queued
    scale, shift = _f32(ln[0]), _f32(ln[1])
    lib = _messages_lib()
    err = lib.skt_block_messages(
        src.data_ptr(), bias.data_ptr(), b0.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), m.data_ptr(), M, L, _EPS, _stream(src),
    )
    _build.check(lib, err, "block_messages")
    block_messages.launches += 1
    return m


block_messages.launches = 0


def fused_block_messages(src_rows, bias_b, local, b0, wb, ln, SB):
    """Per block finish(src + bias), then segment aggregation (K14).

    src_rows/bias_b: (B, M, L) pre-gathered source rows and cached bias in the
    layout of ``ops.graph.build_block_plan``; local: (B, M) int32 block-local
    segment ids in any order (== SB ⇒ padding); L ≤ 512 on a CUDA tensor.
    Returns (B, SB, L) block aggregates (unpack with the plan's ``unpack``
    outside)."""
    with cost.kernel("K14", cost.block_messages, src_rows, SB):
        return with_plain_vjp(_block_messages, reference_block_messages, src_rows, bias_b, local, b0, wb, ln, SB)


def _block_messages(src_rows, bias_b, local, b0, wb, ln, SB):
    if src_rows.device.type == "cpu":
        return reference_block_messages(src_rows, bias_b, local, b0, wb, ln, SB)
    if src_rows.ndim != 3:
        raise ValueError(f"fused_block_messages takes (B, M, L) rows, got {tuple(src_rows.shape)}")
    B, M, L = src_rows.shape
    require(src_rows, (B, M, L), "block src rows")
    require(bias_b, (B, M, L), "block bias rows")
    require(local, (B, M), "block local", torch.int32)
    check_segment_sum(SB, M, L, "fused_block_messages")  # before the messages launch
    m = block_messages(src_rows.view(B * M, L), bias_b.view(B * M, L), b0, wb, ln)
    out = segment_sum(m, local, SB)
    fused_block_messages.launches += 1
    return out


fused_block_messages.launches = 0

"""Row MLP (K6), the finish alone (K12) and the row kernels that K7, K12 and
K14 share.

K6 replaces ``skyrim_tpu/ops/fused_mlp.py`` ``fused_mlp`` (Pallas body
``_mlp_kernel``): ``[residual +] LN?(Dense₂(swish(Dense₁(x ‖ x2))))`` over
rows, GraphCast's node and edge MLPs.  ``x2`` feeds the first layer's
trailing kernel rows (the concat is never built); ``x_transposed`` takes x
feature-major (Cin, N) and reads it in place; the residual is added after
the LayerNorm, in the compute dtype.

Kernels (csrc/fused_mlp.cu with csrc/rowgemm.cuh, the ``wgmma`` row GEMM
of every port kernel that multiplies), two launches as ``mlp_paths``
names them by shape: the first GEMM with a split-K first layer and an f32
swish epilogue, its A read as ``a_path`` says (aligned rows; feature-major
(Cin, N) by TMA, ``embed_grid``; element loads for rows of 174, 3 or 4
values and other feature-major inputs); then, with a LayerNorm and
H == Cout ≤ 512, the finish in one launch of the whole-row kernel
``rows_ln_kernel`` (second Dense, bias, LayerNorm and residual, h brought
by TMA), else the second GEMM with its bias (and the residual when there
is no LayerNorm) and, with a LayerNorm, the LayerNorm rows kernel, which
adds the residual.  Bound on this card: operations (1.09 TFLOP for a
512→512→512 MLP over the 1,038,240 grid rows, 1.10 ms at 989 TFLOP/s bf16).

K12 ``fused_finish`` replaces ``fused_finish`` of the same JAX module
(Pallas body ``_finish_kernel``): ``LN(Dense(swish(x + b0)))`` over rows,
the second half of a factored edge MLP.  Kernels (csrc/graph_finish.cu),
as ``finish_path`` names them by shape: where Cout == L ≤ 512, one launch
of the whole-row kernel ``rows_ln_kernel`` (x by TMA, the f32 swish
computed once a row in place, the Dense, bias and LayerNorm; the product
never reaches device memory); else the row GEMM with the swish computed in
its A loader and the bias epilogue, then the LayerNorm rows kernel.  Cout
may differ from L; both are multiples of 8, N is any.  Bound on this
card: bytes (2.13 GB in and out over the 1,038,240 grid rows at L 512,
0.63 ms at 3.35 TB/s, against 0.54 TFLOP).

``reference_finish`` is its plain version and the shared plain version of
the per-edge message math of K7-K9, K13 and K14 (JAX
``_finish_f32``/``reference_finish``): swish(h + b0) in f32 → compute
dtype → Dense → + b → compute dtype → LayerNorm (f32 statistics, fast
variance, eps 1e-6) → compute dtype.

On a CPU tensor ``fused_mlp`` runs ``reference_mlp`` and ``fused_finish``
``reference_finish``; on a CUDA tensor they launch the kernels or raise.
Reverse mode is JAX's ``_mlp_bwd``/``_finish_bwd`` (``ops/vjp.py``): the
backward differentiates the plain version on the saved inputs
(``x_transposed`` is not differentiated).
``<wrapper>.launches`` counts wrapper calls that launched,
``fused_mlp.launches_by_shape`` the same by (N, Cin, Cin2, Cout),
``mlp_finish.launches_by_shape`` the whole-row finish's by (rows, L,
residual), ``ln_rows.launches_by_shape`` the LayerNorm rows kernel's by
(rows, C), ``fused_finish.launches_by_path`` K12's calls by
``finish_path``, and ``finish_rows_ln.launches``, ``finish_gemm.launches``
and ``segment_sum.launches`` those kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from skyrim_tpu_torch.ops import _build
from skyrim_tpu_torch.ops.fused_block import _EPS, _bf16, _f32, _layernorm_f32
from skyrim_tpu_torch.ops.vjp import with_plain_vjp

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ACT_NONE, _ACT_SWISH = 0, 1  # rowgemm::Act
_A_MODES = {"elements": 0, "rows": 1, "feature_major_tma": 2}  # fused_mlp.cu AMode


def _swish_f32(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(h)


def reference_finish(h, b0, wb, ln, dt):
    """Plain finish: ``h`` the f32 sum of the first layer's parts."""
    h = _swish_f32(h.float() + b0.float()).to(dt)
    y = (h.float() @ wb[0].to(dt).float() + wb[1].float()).to(dt)
    return _layernorm_f32(y, *ln).to(dt)


def reference_mlp(x, w1b1, w2b2, ln=None, x2=None, residual=None, x_transposed=False):
    """Plain PyTorch version of K6 (f32 products of compute-dtype operands)."""
    dt = x.dtype
    if x_transposed:
        x = x.T
    cin = x.shape[1]
    w1 = w1b1[0].to(dt).float()
    h = x.float() @ w1[:cin]
    if x2 is not None:
        h = h + x2.float() @ w1[cin:]
    h = _swish_f32(h + w1b1[1].float()).to(dt)
    y = (h.float() @ w2b2[0].to(dt).float() + w2b2[1].float()).to(dt)
    if ln is not None:
        y = _layernorm_f32(y, *ln).to(dt)
    if residual is not None:
        y = (residual.float() + y.float()).to(dt)
    return y


def _lib():
    lib = _build.load("fused_mlp")
    lib.skt_mlp_gemm.argtypes = [_P, _L, _L, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.skt_ln_rows.argtypes = [_P, _P, _P, _P, _P, _I, _I, _F, _P]
    lib.skt_segment_sum.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.skt_mlp_finish.argtypes = [_P] * 7 + [_I, _I, _F, _P]
    for fn in (lib.skt_mlp_gemm, lib.skt_mlp_finish, lib.skt_ln_rows, lib.skt_segment_sum):
        fn.restype = _I
    return lib


def _finish_lib():
    lib = _build.load("graph_finish")
    lib.skt_finish_gemm.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.skt_finish_rows_ln.argtypes = [_P] * 7 + [_I, _I, _F, _P]
    lib.skt_finish_gemm.restype = lib.skt_finish_rows_ln.restype = _I
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def require(t: torch.Tensor, shape, name: str, dtype=torch.bfloat16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} CUDA tensor {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def require_rows16(name: str, *ts) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (its rows of
    L % 8 == 0 bf16 values then load 16 bytes at a time)."""
    if not _aligned(*ts):
        raise ValueError(f"{name}: inputs must start on a 16-byte boundary")


def a_path(M, K1, K2, N, transposed, aligned=True):
    """How the row GEMM reads its A, by the operands' shapes: ``"rows"``
    (16-byte aligned rows: the TMA kernel where N % 128 or N % 192 == 0,
    else the ``cp.async`` ring), ``"feature_major_tma"`` (feature-major
    (K1, M) by TMA on the aligned kernel: no second part, M % 8 == 0 so that
    the rows of 2M bytes stay 16-byte aligned, N % 128 or % 192 == 0) or
    ``"elements"`` (element loads on the ring: rows of 174, 3 or 4 values,
    and every other feature-major input).  ``aligned``: every base starts on
    a 16-byte boundary.  A choice by shape made before the launch; a launch
    that fails raises, it does not fall back."""
    wide = N % 128 == 0 or N % 192 == 0
    if transposed:
        return "feature_major_tma" if K2 == 0 and M % 8 == 0 and wide and aligned else "elements"
    return "rows" if K1 % 8 == 0 and K2 % 8 == 0 and aligned else "elements"


def mlp_gemm(a, w, b, *, a2=None, swish=False, residual=None, transposed=False):
    """One launch of the row GEMM: ``act(a ‖ a2 @ w + b)`` [+ residual] → bf16.

    ``a`` (M, K1) rows, or (K1, M) feature-major with ``transposed``;
    ``a2`` (M, K2) rows; ``w`` (K1 + K2, N) bf16; ``b`` (N,) f32.  A is read
    as ``a_path`` names."""
    K1, M = a.shape if transposed else a.shape[::-1]
    K2 = 0 if a2 is None else a2.shape[1]
    N = w.shape[1]
    require(a, a.shape, "mlp_gemm a")
    require(w, (K1 + K2, N), "mlp_gemm w")
    require(b, (N,), "mlp_gemm b", torch.float32)
    if a2 is not None:
        require(a2, (M, K2), "mlp_gemm a2")
    if residual is not None:
        require(residual, (M, N), "mlp_gemm residual")
    s1m, s1k = (1, M) if transposed else (K1, 1)
    mode = _A_MODES[a_path(M, K1, K2, N, transposed, _aligned(a, a2, w, residual))]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    lib = _lib()
    err = lib.skt_mlp_gemm(
        a.data_ptr(), s1m, s1k, K1, a2.data_ptr() if a2 is not None else None, K2,
        w.data_ptr(), b.data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), M, N, _ACT_SWISH if swish else _ACT_NONE, mode, _stream(a),
    )
    _build.check(lib, err, "mlp_gemm")
    return out


def mlp_paths(N, Cin, Cin2, H, Cout, ln, residual, transposed):
    """The two launches ``fused_mlp`` makes for these shapes: how its first
    product reads x (``a_path``), and its finish: ``"rows_ln"`` (one launch
    of the whole-row kernel: second Dense, bias, LayerNorm, residual) where
    there is a LayerNorm and H == Cout, Cout % 8 == 0 and Cout ≤ 512 (the
    kernel's W is (L, L) and a block holds whole rows of up to 512);
    ``"gemm_ln_rows"`` (the second GEMM, then the LayerNorm rows kernel)
    for the other LayerNorm shapes; ``"gemm"`` (the second GEMM, the
    residual in its epilogue) without a LayerNorm.  ``ln`` and ``residual``
    say whether there is one; the bases are taken as 16-byte aligned.  A
    choice by shape, made before the launches."""
    if ln and H == Cout and Cout % 8 == 0 and Cout <= 512:
        finish = "rows_ln"
    else:
        finish = "gemm_ln_rows" if ln else "gemm"
    return a_path(N, Cin, Cin2, H, transposed), finish


def mlp_finish(h, wb, ln, residual=None):
    """One launch of the whole-row kernel: ``bf16([residual +]
    bf16(LN(bf16(h @ W + b))))`` over (M, L) rows, W (L, L), L % 8 == 0,
    L ≤ 512; h is read by TMA and must start on a 16-byte boundary."""
    M, L = h.shape
    if L % 8 or L > 512 or tuple(wb[0].shape) != (L, L):
        raise ValueError(f"mlp_finish takes L % 8 == 0, L <= 512 and an (L, L) kernel, got {tuple(h.shape)}, "
                         f"kernel {tuple(wb[0].shape)}")
    require(h, (M, L), "mlp_finish h")
    if residual is not None:
        require(residual, (M, L), "mlp_finish residual")
    require_rows16("mlp_finish", h, residual)
    w, b, scale, shift = _bf16(wb[0]), _f32(wb[1]), _f32(ln[0]), _f32(ln[1])  # held until the launch is queued
    out = torch.empty((M, L), dtype=torch.bfloat16, device=h.device)
    lib = _lib()
    err = lib.skt_mlp_finish(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(), M, L, _EPS, _stream(h),
    )
    _build.check(lib, err, "mlp_finish")
    key = (M, L, residual is not None)
    mlp_finish.launches_by_shape[key] = mlp_finish.launches_by_shape.get(key, 0) + 1
    return out


mlp_finish.launches_by_shape = {}  # (rows, L, residual) -> launches


def ln_rows(y, ln, *, residual=None, out=None):
    """``bf16([residual +] bf16(LN(y)))`` per row; ``out`` may be ``y`` itself."""
    R, C = y.shape
    if C % 8:
        raise ValueError(f"ln_rows takes C % 8 == 0, got {tuple(y.shape)}")
    require(y, y.shape, "ln_rows y")
    if residual is not None:
        require(residual, (R, C), "ln_rows residual")
    out = torch.empty((R, C), dtype=torch.bfloat16, device=y.device) if out is None else out
    require(out, (R, C), "ln_rows out")
    scale, bias = _f32(ln[0]), _f32(ln[1])
    lib = _lib()
    err = lib.skt_ln_rows(
        y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(), R, C, _EPS, _stream(y),
    )
    _build.check(lib, err, "ln_rows")
    ln_rows.launches_by_shape[(R, C)] = ln_rows.launches_by_shape.get((R, C), 0) + 1
    return out


ln_rows.launches_by_shape = {}  # (rows, C) -> launches


def check_segment_sum(S, R, C, what="segment_sum"):
    """Raise ValueError unless ``segment_sum`` takes S ids over groups of R
    rows of C columns: a block keeps its group's S x 128 f32 sums and R ids in
    shared memory, S·512 + R·4 bytes within a block's 227 KB, and C is even."""
    if S * 512 + R * 4 > _build.MAX_SMEM or C % 2:
        raise ValueError(
            f"{what}: S {S}, R {R} need {S * 512 + R * 4} bytes of shared memory (at most {_build.MAX_SMEM}) and C {C} must be even"
        )


def segment_sum(x, local, S):
    """(G·R, C) rows and (G, R) int32 ids → (G, S, C): per group, the f32 sum
    of the rows with each id in [0, S), as bf16; ids in any order (runs of
    equal ids are summed in registers first, so sorted ids are fastest), the
    same bits on every call; within ``check_segment_sum``'s limits."""
    G, R = local.shape
    C = x.shape[1]
    check_segment_sum(S, R, C)
    require(x, (G * R, C), "segment_sum x")
    require(local, (G, R), "segment_sum local", torch.int32)
    out = torch.empty((G, S, C), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.skt_segment_sum(x.data_ptr(), local.data_ptr(), out.data_ptr(), G, R, S, C, _stream(x))
    _build.check(lib, err, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def finish_gemm(x, b0, wb):
    """One launch of the row GEMM with the finish prologue:
    ``bf16(bf16(swish(x + b0)) @ W + b)`` for (M, L) rows → (M, Cout)."""
    M, L = x.shape
    Cout = wb[0].shape[1]
    if L % 8 or tuple(wb[0].shape) != (L, Cout):
        raise ValueError(f"finish takes L % 8 == 0 and a ({L}, Cout) kernel, got L {L}, kernel {tuple(wb[0].shape)}")
    require(x, (M, L), "finish x")
    require_rows16("finish", x)
    b0, w, b = _f32(b0), _bf16(wb[0]), _f32(wb[1])  # held until the launch is queued
    y = torch.empty((M, Cout), dtype=torch.bfloat16, device=x.device)
    lib = _finish_lib()
    err = lib.skt_finish_gemm(x.data_ptr(), b0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, L, Cout,
                              _stream(x))
    _build.check(lib, err, "finish_gemm")
    finish_gemm.launches += 1
    return y


finish_gemm.launches = 0


def finish_rows_ln(x, b0, wb, ln):
    """One launch of the whole-row kernel with the finish prologue:
    ``bf16(LN(bf16(bf16(swish(x + b0)) @ W + b)))`` over (M, L) rows, W
    (L, L), L % 8 == 0, L ≤ 512; x is read by TMA and must start on a
    16-byte boundary."""
    M, L = x.shape
    if L % 8 or L > 512 or tuple(wb[0].shape) != (L, L):
        raise ValueError(f"finish_rows_ln takes L % 8 == 0, L <= 512 and an (L, L) kernel, got {tuple(x.shape)}, "
                         f"kernel {tuple(wb[0].shape)}")
    require(x, (M, L), "finish x")
    require_rows16("finish_rows_ln", x)
    out = torch.empty((M, L), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    b0, w, b, scale, shift = _f32(b0), _bf16(wb[0]), _f32(wb[1]), _f32(ln[0]), _f32(ln[1])  # held until queued
    lib = _finish_lib()
    err = lib.skt_finish_rows_ln(x.data_ptr(), b0.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
                                 shift.data_ptr(), out.data_ptr(), M, L, _EPS, _stream(x))
    _build.check(lib, err, "finish_rows_ln")
    finish_rows_ln.launches += 1
    return out


finish_rows_ln.launches = 0


def finish_path(L, Cout):
    """The launches ``fused_finish`` makes for (N, L) rows to Cout columns:
    ``"rows_ln"`` (one launch of the whole-row kernel: the swish computed in
    place on the rows TMA brought, the Dense, its bias and the LayerNorm)
    where Cout == L, L % 8 == 0 and L ≤ 512 (the kernel's W is (L, L) and a
    block holds whole rows of up to 512), which is every shape GraphCast
    has; else ``"gemm_ln_rows"`` (the row GEMM with the swish in its A
    loader, then the LayerNorm rows kernel in place).  A choice by shape,
    made before the launches."""
    return "rows_ln" if Cout == L and L % 8 == 0 and L <= 512 else "gemm_ln_rows"


def fused_finish(x, b0, wb, ln):
    """``LN(Dense(swish(x + b0)))`` over rows (K12).  x: (N, L); b0: (L,); wb:
    ((L, Cout), (Cout,)); ln: (scale, bias) over Cout.  Returns (N, Cout),
    in the launches ``finish_path`` names."""
    return with_plain_vjp(_finish, _plain_finish, x, b0, wb, ln)


def _plain_finish(x, b0, wb, ln):
    return reference_finish(x, b0, wb, ln, x.dtype)


def _finish(x, b0, wb, ln):
    if x.device.type == "cpu":
        return _plain_finish(x, b0, wb, ln)
    if x.ndim != 2 or wb[0].shape[1] % 8:
        raise ValueError(f"fused_finish takes (N, L) rows and Cout % 8 == 0, got {tuple(x.shape)} -> {wb[0].shape[1]}")
    path = finish_path(x.shape[1], wb[0].shape[1])
    if path == "rows_ln":
        out = finish_rows_ln(x, b0, wb, ln)
    else:
        y = finish_gemm(x, b0, wb)
        out = ln_rows(y, ln, out=y)
    fused_finish.launches += 1
    fused_finish.launches_by_path[path] = fused_finish.launches_by_path.get(path, 0) + 1
    return out


fused_finish.launches = 0
fused_finish.launches_by_path = {}  # finish_path -> calls


def fused_mlp(x, w1b1, w2b2, ln=None, x2=None, residual=None, x_transposed=False):
    """``[residual +] LN?(Dense₂(swish(Dense₁(x ‖ x2))))`` over rows → (N, Cout).

    x: (N, Cin), or (Cin, N) with ``x_transposed``; w1b1: ((Cin [+ Cin2], H),
    (H,)); w2b2: ((H, Cout), (Cout,)); ln: optional (scale, bias) over Cout;
    x2: optional (N, Cin2); residual: optional (N, Cout)."""
    return with_plain_vjp(_mlp, reference_mlp, x, w1b1, w2b2, ln, x2, residual, x_transposed)


def _mlp(x, w1b1, w2b2, ln=None, x2=None, residual=None, x_transposed=False):
    if x.device.type == "cpu":
        return reference_mlp(x, w1b1, w2b2, ln, x2=x2, residual=residual, x_transposed=x_transposed)
    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ValueError(f"fused_mlp takes a bf16 2-d input, got {x.dtype} {tuple(x.shape)}")
    Cin, N = x.shape if x_transposed else x.shape[::-1]
    H, Cout = w2b2[0].shape
    if ln is not None and Cout % 8:
        raise ValueError(f"fused_mlp's LayerNorm takes Cout % 8 == 0, got {Cout}")
    _, finish = mlp_paths(N, Cin, 0 if x2 is None else x2.shape[1], H, Cout, ln is not None, residual is not None,
                          x_transposed)
    h = mlp_gemm(x, _bf16(w1b1[0]), _f32(w1b1[1]), a2=x2, swish=True, transposed=x_transposed)
    if finish == "rows_ln":
        out = mlp_finish(h, w2b2, ln, residual)
    else:
        y = mlp_gemm(h, _bf16(w2b2[0]), _f32(w2b2[1]), residual=residual if ln is None else None)
        out = y if ln is None else ln_rows(y, ln, residual=residual, out=y)
    del h
    fused_mlp.launches += 1
    key = (N, Cin, 0 if x2 is None else x2.shape[1], Cout)
    fused_mlp.launches_by_shape[key] = fused_mlp.launches_by_shape.get(key, 0) + 1
    return out


fused_mlp.launches = 0
fused_mlp.launches_by_shape = {}  # (N, Cin, Cin2, Cout)

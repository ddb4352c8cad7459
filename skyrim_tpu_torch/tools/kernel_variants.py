"""Time variants of a hand-written kernel against each other on one card.

    python -m skyrim_tpu_torch.tools.kernel_variants KIND [VARIANT ...]

KIND is ``attention``, ``gemm``, ``round``, ``g2m``, ``m2g``, ``mlp``, ``lngemm``,
``resample``, ``messages`` or ``ptxas``.  A VARIANT is a directory: an
edited copy of ``skyrim_tpu_torch/csrc`` (``""`` for the package's own, which
is also what is timed when no variant is given).  The sources carry no
build-time switches: an experiment is a copy with the change made in it.
Every variant is built with the package's nvcc
flags plus ``-Xptxas -v`` (the register, stack and shared-memory report of
the kernels named below is printed), checked to launch, then timed with CUDA
events, 20 launches a round, four rounds in turn over the variants, so that
clock drift shows as spread between rounds and not as a difference between
variants.

- ``attention``: ``window_attention.cu``; ``skt_attention_4d`` (K5) at Pangu
  stage 1 — qkv (8, 186, 360, 576), 6 heads, 124 bias types — and stage 2 —
  qkv (8, 96, 180, 1152), 12 heads, 64 types — shifted mask on both.
- ``gemm``: ``fused_mlp.cu`` and ``gemm.cu``; the aligned row GEMM at every
  shape the main paths give it: ``skt_mlp_gemm`` on K7's second product,
  (329,728 x 512) @ (512 x 512), and on one product of K6's grid update,
  (1,038,240 x 512) @ (512 x 512), with the bias epilogue; ``skt_gemm_bf16``
  on Pangu's eight block products (qkv, proj + residual, fc1 + GELU, fc2 +
  residual at stage 1, M 535,680, C 192, and stage 2, M 138,240, C 384), each
  with the epilogue K1 gives it; K1's proj + residual and fc2 + residual at
  FengWu's C 1152 (M 66,960) and FuXi V1's C 1536 (M 17,280) on
  ``skt_gemm_bf16`` (the 128 x 128 ping-pong tiles) and, where the variant
  exports it, ``skt_wide_gemm_bf16`` (``wide_gemm_kernel``).  Each with its
  TFLOP/s, and
  ``torch.matmul`` in bf16 on the same operands timed beside it once (a
  yardstick; the port never calls it).  Then, for a variant that exports
  ``skt_rowgemm_host_ns``, the host's share of one launch over 1,000 calls
  (tensor-map encodes, ``cudaFuncSetAttribute``, a whole launch), on the host
  clock.
- ``round``: ``graph_round.cu`` and ``fused_mlp.cu``; K7's chain at
  (322, 1024, 512), SB 176 on a sorted ``local``: the first product with its
  expansion epilogue, the second Dense, the LayerNorm with its residual and
  the segmented sum; each launch alone and the chain.
- ``g2m``: ``graph_g2m.cu``; K9's two launches at full width on the row plan
  of the 721 x 1440 tables (1,629,780 filled slots, L 512): the messages
  kernel (prologue, products and LayerNorm) and the CSR sum.  The tables are
  built on the host first (about 10 s).
- ``m2g``: ``graph_m2g.cu`` and ``fused_mlp.cu``; K8 at full width on the
  face tiles of the 721 x 1440 tables (uniq (91, 12, 192, 1536), L 512):
  the one launch ``skt_m2g_messages``, or, for a ``csrc`` that exports
  ``skt_m2g_gemm`` instead (the two-launch K8 before it), that GEMM and the
  LayerNorm rows summing three rows, alone and together.
- ``mlp``: ``fused_mlp.cu``; K6 at its five full-width shapes (the
  feature-major ``embed_grid`` 174 -> 512 -> 512 with LayerNorm, the grid
  update and the decoder's node update, 512 (+ 512) -> 512 -> 512 with
  LayerNorm and residual over 1,038,240 rows, a mesh MLP over 40,962 rows,
  the head 512 -> 512 -> 83), each K6 call as the variant makes it: the
  first product with its swish, then the finish in one ``skt_mlp_finish``
  launch where the variant exports it and the shape has a LayerNorm with H
  == Cout, else the second product and the LayerNorm rows.  ``embed_grid``'s
  first product alone as well: feature-major A by TMA where the variant's
  ``fused_mlp.cu`` names ``A_FEATURE_MAJOR_TMA``, else by element loads; and,
  as a yardstick timed only, a torch copy of its transpose into (N, 176)
  rows followed by the aligned rows GEMM.
- ``lngemm``: ``gemm.cu`` and ``fused_block.cu``; K1's LayerNorm-prologue
  products at full width: LN1 + qkv and LN2 + fc1 + GELU at stage 1
  (M 535,680, K 192, N 576 and 768) and stage 2 (M 138,240, K 384, N 1,152
  and 1,536), each one ``skt_ln_gemm_bf16`` launch where the variant exports
  it, else the pair it replaces (``skt_layernorm_bf16`` into h, then
  ``skt_gemm_bf16`` on h); LN1 + qkv and LN2 + fc1 + GELU at FengWu's C 1152
  (M 66,960, N 3,456 and 4,608) and FuXi V1's C 1536 (M 17,280, N 4,608 and
  6,144) as that pair and, where the variant exports
  ``skt_wide_gemm_bf16``, one ``wide_gemm_kernel`` launch at each of
  ``WIDE_GROUPS`` (column tiles a statistics pass serves; 0 the launch's
  choice); ``torch.matmul`` in bf16 on the same operands
  timed beside them (a yardstick).  The layouts are ``rowgemm.cuh``'s
  ``lng::TALL_BM``, ``TALL_BN`` (rows of K <= 256), ``BM``, ``BN`` and ``NC``:
  edit them in a copy.
- ``resample``: ``resample.cu`` and ``gemm.cu``; K3 and K4 at Pangu's full
  width on their main-path inputs: K3 on the (8, 181, 360, 192) view of the
  stage-1 buffer (8, 186, 360, 192) to (8, 91, 180, 384), K4 on the
  (8, 91, 180, 384) view of the stage-2 buffer (8, 96, 180, 384) to
  (8, 182, 360, 192); each one ``skt_downsample_bf16`` / ``skt_upsample_bf16``
  launch where the variant exports them, else the chains they replace:
  K3 ``skt_merge_layernorm_bf16`` on the padded contiguous copy (8, 182, 360,
  192) into the merged (131,040, 768) matrix, then ``skt_gemm_bf16``, alone
  and with ``DownSample``'s ``F.pad`` copy before it; K4 ``skt_gemm_bf16``
  on a contiguous copy of its view into (131,040, 768), then
  ``skt_expand_layernorm_bf16``.  Each output held against the plain
  version (``ops/resample.py``) at the kernels' tolerance; ``torch.matmul``
  of the two products alone, (131,040 x 768) @ (768 x 384) and (131,040 x
  384) @ (384 x 768), timed beside them (a yardstick).
- ``messages``: ``graph_finish.cu`` and ``fused_mlp.cu``; K13 at full width
  (1,038,240 grid rows, deg 3, L 512) and K14 on the full-width grid->mesh
  block plan ((201, 8192, 512), SB 328; built on the host first, about 10 s):
  K13's one ``skt_fixed_degree_messages`` launch (also at deg 1 over the
  first 1,038,240 rows of the same buffers) and K14's messages
  (``skt_block_messages``) and segmented sum, alone and together; or, for a
  ``csrc`` that exports ``skt_fixed_degree_gemm`` instead (the chains before
  them), K13's GEMM and the LayerNorm rows summing three rows, and K14's
  finish GEMM with its bias rows, the LayerNorm rows and the segmented sum,
  alone and together.  With either, K12 over the grid rows and over the mesh
  edges (the first 327,660 rows of the same buffers): one
  ``skt_finish_rows_ln`` launch where the variant exports it, and the chain
  it replaced (``skt_finish_gemm``, then the LayerNorm rows in place).
  K13's output over its first 4,200 points, K14's messages over their first
  4,096 rows and K12's last 4,096 rows of each launch are held against the
  plain versions (ops/graph_kernels.py, ops/fused_mlp.py) at the kernels'
  tolerance.
- ``ptxas``: no timing; every library of ``_build.LIBS`` from the first and
  the second directory given, compiled with ``-Xptxas -v``: each kernel whose
  register, stack or spill report differs between the two, then the count of
  those that are identical (needs nvcc only).

Prints one line per report, per (round, variant, case); needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROUNDS, LAUNCHES = 4, 20
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = {"attention": ("window_attention",), "gemm": ("fused_mlp", "gemm"), "round": ("graph_round", "fused_mlp"),
           "g2m": ("graph_g2m",), "m2g": ("graph_m2g", "fused_mlp"), "mlp": ("fused_mlp",),
           "lngemm": ("gemm", "fused_block"), "resample": ("resample", "gemm"),
           "messages": ("graph_finish", "fused_mlp")}  # fmt: skip
REPORTED = {"attention": ("window_attention", "Packed4D"), "gemm": ("EpiGemm",),
            "round": ("rowgemm", ""), "g2m": ("graph_g2m", ""), "m2g": ("M2G",), "mlp": ("rowgemm",),
            "lngemm": ("EpiGemm",), "resample": ("resample",), "messages": ("graph_finish",)}  # fmt: skip


def _bind(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, I
    return fn


def _ln_rows(lib, src):
    """``skt_ln_rows`` of a variant as ln(y, scale, shift, res, out, rows, C,
    nsum, eps, stream), for a ``fused_mlp.cu`` with the nsum argument (rows
    summed a LayerNorm, before K13 took one launch) or without it (nsum 1)."""
    if "int nsum" in (src / "fused_mlp.cu").read_text():
        return _bind(lib, "skt_ln_rows", [P, P, P, P, P, I, I, I, F, P])
    fn = _bind(lib, "skt_ln_rows", [P, P, P, P, P, I, I, F, P])

    def ln(y, scale, shift, res, out, rows, C, nsum, eps, stream):
        if nsum != 1:
            raise ValueError(f"this skt_ln_rows takes one row a LayerNorm, not {nsum}")
        return fn(y, scale, shift, res, out, rows, C, eps, stream)

    return ln


def attention_cases(torch, libs, _src):
    from skyrim_tpu_torch.ops.flash_window_attention import BODIES, attention_body
    from skyrim_tpu_torch.ops.windows import shift_attention_mask

    dev, window = torch.device("cuda"), (2, 6, 12)
    g = torch.Generator(device=dev).manual_seed(0)
    fn = _bind(libs["window_attention"], "skt_attention_4d", [P] * 4 + [I] * 10 + [F, I, P])
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for stage, (Z, H, W, C, heads, valid_h) in (("stage 1", (8, 186, 360, 192, 6, 181)), ("stage 2", (8, 96, 180, 384, 12, 91))):
        qkv = torch.randn(Z, H, W, 3 * C, device=dev, generator=g).to(torch.bfloat16)
        bias = torch.randn((Z // 2) * (H // 6), heads, 144, 144, device=dev, generator=g) * 0.5
        mask = torch.from_numpy(shift_attention_mask((Z, H, W), window, (1, 3, 6), (Z, valid_h, W))).to(dev)
        out = torch.empty(Z, H, W, C, device=dev, dtype=torch.bfloat16)
        body = BODIES.index(attention_body(144, C // heads))

        def call(a=(qkv, bias, mask, out), dims=(Z, H, W, C, heads), body=body):
            qkv, bias, mask, out = a
            return fn(qkv.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(), *dims, *window,
                      bias.shape[0], 1, (dims[3] // dims[4]) ** -0.5, body, stream)  # fmt: skip

        cases[f"K5 {stage}"] = (call, None)
    return cases


# name, M, K, N, epilogue: "mlp" (skt_mlp_gemm, bias), else skt_gemm_bf16's
# 0 bias, 1 GELU, 2 residual
GEMM_SHAPES = (
    ("K7 second product", 322 * 1024, 512, 512, "mlp"),
    ("K6 grid_update, one product", 721 * 1440, 512, 512, "mlp"),
    ("Pangu s1 qkv", 535680, 192, 576, 0),
    ("Pangu s1 proj + res", 535680, 192, 192, 2),
    ("Pangu s1 fc1 + GELU", 535680, 192, 768, 1),
    ("Pangu s1 fc2 + res", 535680, 768, 192, 2),
    ("Pangu s2 qkv", 138240, 384, 1152, 0),
    ("Pangu s2 proj + res", 138240, 384, 384, 2),
    ("Pangu s2 fc1 + GELU", 138240, 384, 1536, 1),
    ("Pangu s2 fc2 + res", 138240, 1536, 384, 2),
    ("FengWu qkv, no LN", 66960, 1152, 3456, 0),
    ("FengWu fc1 + GELU, no LN", 66960, 1152, 4608, 1),
    ("FengWu proj + res", 66960, 1152, 1152, 2),
    ("FengWu fc2 + res", 66960, 4608, 1152, 2),
    ("FuXi V1 proj + res", 17280, 1536, 1536, 2),
    ("FuXi V1 fc2 + res", 17280, 6144, 1536, 2),
)
WIDE_K = 512  # K1's products past this K take wide_gemm_kernel (and the chain's pair before it)
_operands: dict = {}  # one set of operands a shape, shared by the variants


def _gemm_operands(torch, M, K, N):
    if (M, K, N) not in _operands:
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        _operands[(M, K, N)] = (
            torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16),
            (torch.randn(K, N, device=dev, generator=g) * K**-0.5).to(torch.bfloat16),
            torch.randn(N, device=dev, generator=g) * 0.1,
            torch.randn(M, N, device=dev, generator=g).to(torch.bfloat16),
            torch.empty(M, N, device=dev, dtype=torch.bfloat16),
        )
    return _operands[(M, K, N)]


def _wide(lib):
    """A variant's skt_wide_gemm_bf16 (the long-K GEMM), or None."""
    if not hasattr(lib, "skt_wide_gemm_bf16"):
        return None
    return _bind(lib, "skt_wide_gemm_bf16", [P] * 7 + [I] * 4 + [F, I, P])


def gemm_cases(torch, libs, _src):
    mlp = _bind(libs["fused_mlp"], "skt_mlp_gemm", [P, L, L, I, P, I, P, P, P, P, I, I, I, I, P])
    gemm = _bind(libs["gemm"], "skt_gemm_bf16", [P] * 5 + [I] * 4 + [P])
    wide = _wide(libs["gemm"])
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for name, M, K, N, epi in GEMM_SHAPES:
        a, w, b, r, out = _gemm_operands(torch, M, K, N)
        calls = {}
        if epi == "mlp":
            def call(a=a, w=w, b=b, out=out, M=M, K=K, N=N):
                return mlp(a.data_ptr(), K, 1, K, None, 0, w.data_ptr(), b.data_ptr(), None, out.data_ptr(), M, N, 0, 1, stream)
        else:
            def call(a=a, w=w, b=b, r=r, out=out, M=M, K=K, N=N, epi=epi):
                return gemm(a.data_ptr(), w.data_ptr(), b.data_ptr(), r.data_ptr() if epi == 2 else None, out.data_ptr(),
                            M, N, K, epi, stream)  # fmt: skip
        calls["128 x 128 ping-pong" if K > WIDE_K else ""] = call
        if K > WIDE_K and wide:
            def call(a=a, w=w, b=b, r=r, out=out, M=M, K=K, N=N, epi=epi):
                return wide(a.data_ptr(), None, None, w.data_ptr(), b.data_ptr(), r.data_ptr() if epi == 2 else None,
                            out.data_ptr(), M, N, K, epi, 1e-6, 0, stream)  # fmt: skip
            calls["wide"] = call
        for how, call in calls.items():
            out.zero_()  # the operands are shared by the variants: no earlier variant's result stands
            call()  # held against torch.matmul in f32 on the first 4096 rows
            torch.cuda.synchronize()
            ref = a[:4096].float() @ w.float() + b
            if epi == 1:
                ref = torch.nn.functional.gelu(ref.to(torch.bfloat16).float(), approximate="tanh")
            elif epi == 2:
                ref = ref.to(torch.bfloat16).float() + r[:4096].float()
            err = float((out[:4096].float() - ref).abs().max())
            case = f"{name} ({M}, {K}) @ ({K}, {N}){' ' + how if how else ''}"
            print(f"{case}: max |kernel - matmul| over 4096 rows = {err:.4g}")
            cases[case] = (call, 2 * M * K * N)
    return cases


# name, M, K, N, GELU
LNGEMM_SHAPES = (
    ("Pangu s1 LN1 + qkv", 535680, 192, 576, 0),
    ("Pangu s1 LN2 + fc1 + GELU", 535680, 192, 768, 1),
    ("Pangu s2 LN1 + qkv", 138240, 384, 1152, 0),
    ("Pangu s2 LN2 + fc1 + GELU", 138240, 384, 1536, 1),
    ("FengWu LN1 + qkv", 66960, 1152, 3456, 0),
    ("FengWu LN2 + fc1 + GELU", 66960, 1152, 4608, 1),
    ("FuXi V1 LN1 + qkv", 17280, 1536, 4608, 0),
    ("FuXi V1 LN2 + fc1 + GELU", 17280, 1536, 6144, 1),
)
WIDE_GROUPS = (0, 1, 3, 8)  # wide_gemm_kernel's column tiles a unit: 0 the launch's choice


def lngemm_cases(torch, libs, _src):
    gemm = _bind(libs["gemm"], "skt_gemm_bf16", [P] * 5 + [I] * 4 + [P])
    fused = hasattr(libs["gemm"], "skt_ln_gemm_bf16")
    if fused:
        lng = _bind(libs["gemm"], "skt_ln_gemm_bf16", [P] * 6 + [I] * 4 + [F, P])
    ln = _bind(libs["fused_block"], "skt_layernorm_bf16", [P] * 4 + [I] * 2 + [F, P])
    wide = _wide(libs["gemm"])
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for name, M, K, N, gelu in LNGEMM_SHAPES:
        x, w, b, _, out = _gemm_operands(torch, M, K, N)
        scale, shift = _ln_params(torch, K)
        h = _h_buffer(torch, M, K)
        calls = {}
        if fused and K <= WIDE_K:
            def call(x=x, w=w, b=b, out=out, scale=scale, shift=shift, M=M, K=K, N=N, gelu=gelu):
                return lng(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                           M, N, K, gelu, 1e-6, stream)  # fmt: skip
            calls["one launch"] = call
        else:  # the pair: the LayerNorm rows launch into h, then the 128 x 128 ping-pong GEMM on h
            def call(x=x, w=w, b=b, out=out, scale=scale, shift=shift, h=h, M=M, K=K, N=N, gelu=gelu):
                return (ln(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), h.data_ptr(), M, K, 1e-6, stream)
                        or gemm(h.data_ptr(), w.data_ptr(), b.data_ptr(), None, out.data_ptr(), M, N, K, gelu, stream))
            calls["LayerNorm + GEMM"] = call
        if K > WIDE_K and wide:
            for group in WIDE_GROUPS:
                def call(x=x, w=w, b=b, out=out, scale=scale, shift=shift, M=M, K=K, N=N, gelu=gelu, group=group):
                    return wide(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                                out.data_ptr(), M, N, K, gelu, 1e-6, group, stream)  # fmt: skip
                calls[f"wide, group {group or 'chosen'}"] = call
        for how, call in calls.items():
            out.zero_()
            call()  # held against torch in f32 on the first 4096 rows
            torch.cuda.synchronize()
            xf = x[:4096].float()
            mu = xf.mean(-1, keepdim=True)
            var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
            hr = ((xf - mu) * torch.rsqrt(var + 1e-6) * scale + shift).to(torch.bfloat16).float()
            ref = (hr @ w.float() + b).to(torch.bfloat16).float()
            if gelu:
                ref = torch.nn.functional.gelu(ref, approximate="tanh")
            err = float((out[:4096].float() - ref).abs().max())
            case = f"{name} ({M}, {K}) @ ({K}, {N}) {how}"
            print(f"{case}: max |kernel - torch| over 4096 rows = {err:.4g}")
            cases[case] = (call, 2 * M * K * N)
    return cases


def _resample_operands(torch):
    """K3's and K4's main-path inputs (views of the stage buffers), their
    parameters and outputs, made once and shared by the variants."""
    if "resample" not in _operands:
        from skyrim_tpu_torch.ops import resample as RS

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        C, N = 192, 384
        x = randn(8, 186, 360, C).to(torch.bfloat16)[:, :181]
        ln, wb = (1 + randn(4 * C, s=0.1), randn(4 * C, s=0.3)), (randn(4 * C, N, s=(4 * C) ** -0.5), randn(N, s=0.1))
        xu = randn(8, 96, 180, N).to(torch.bfloat16)[:, :91]
        wbu, lnu = (randn(N, 4 * C, s=N**-0.5), randn(4 * C, s=0.1)), (1 + randn(C, s=0.1), randn(C, s=0.3))
        _operands["resample"] = dict(
            x=x, ln=ln, wb=wb, down=RS.prepare_downsample(ln, wb), xu=xu, wbu=wbu, lnu=lnu,
            up=RS.prepare_upsample(wbu, lnu), w_bf16=wb[0].to(torch.bfloat16),
            out3=torch.empty(8, 91, 180, N, device=dev, dtype=torch.bfloat16),
            out4=torch.empty(8, 182, 360, C, device=dev, dtype=torch.bfloat16),
            merged=torch.empty(131040, 4 * C, device=dev, dtype=torch.bfloat16),
            ref3=RS.reference_downsample(RS.pad_even_h(x), ln, wb), ref4=RS.reference_upsample(xu, wbu, lnu),
        )
    return _operands["resample"]


def resample_cases(torch, libs, _src):
    from torch.nn.functional import pad

    lib = libs["resample"]
    o = _resample_operands(torch)
    x, xu, out3, out4 = o["x"], o["xu"], o["out3"], o["out4"]
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [t.data_ptr() for t in (*o["down"], *o["up"])]
    cases = {}
    if hasattr(lib, "skt_downsample_bf16"):
        down = _bind(lib, "skt_downsample_bf16", [P, L, L, L] + [I] * 4 + [P] * 4 + [I, F, P])
        up = _bind(lib, "skt_upsample_bf16", [P, L, L, L] + [I] * 4 + [P] * 5 + [I, F, P])
        cases["K3 one launch"] = (lambda: down(x.data_ptr(), *x.stride()[:3], 8, 181, 360, 192, *ptr[:3], out3.data_ptr(),
                                               384, 1e-6, stream), 2 * 131040 * 768 * 384)  # fmt: skip
        cases["K4 one launch"] = (lambda: up(xu.data_ptr(), *xu.stride()[:3], 8, 91, 180, 384, *ptr[3:], out4.data_ptr(),
                                             192, 1e-6, stream), 2 * 131040 * 384 * 768)  # fmt: skip
    else:
        merge = _bind(lib, "skt_merge_layernorm_bf16", [P] * 4 + [I] * 4 + [F, P])
        expand = _bind(lib, "skt_expand_layernorm_bf16", [P] * 4 + [I] * 4 + [F, P])
        gemm = _bind(libs["gemm"], "skt_gemm_bf16", [P] * 5 + [I] * 4 + [P])
        xp, xc, merged = pad(x, (0, 0, 0, 0, 0, 1)), xu.contiguous(), o["merged"]
        s3, b3, b = (t.data_ptr() for t in (*o["ln"], o["wb"][1]))
        w3 = o["w_bf16"].data_ptr()

        def k3(xp=xp):
            return (merge(xp.data_ptr(), s3, b3, merged.data_ptr(), 8, 182, 360, 192, 1e-6, stream)
                    or gemm(merged.data_ptr(), w3, b, None, out3.data_ptr(), 131040, 384, 768, 0, stream))

        cases["K3 chain"] = (k3, 2 * 131040 * 768 * 384)
        cases["K3 chain + pad copy"] = (lambda: k3(pad(x, (0, 0, 0, 0, 0, 1))), 2 * 131040 * 768 * 384)
        cases["K4 chain"] = (lambda: gemm(xc.data_ptr(), *ptr[3:5], None, merged.data_ptr(), 131040, 768, 384, 0, stream)
                             or expand(merged.data_ptr(), *ptr[5:], out4.data_ptr(), 8, 91, 180, 192, 1e-6, stream),
                             2 * 131040 * 384 * 768)  # fmt: skip
    for case, (call, _) in cases.items():  # held against the plain version
        out, ref = (out3, o["ref3"]) if case.startswith("K3") else (out4, o["ref4"])
        out.zero_()
        call()
        torch.cuda.synchronize()
        ref = ref.float()
        ratio = float(((out.float() - ref).abs() / (2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max())).max())
        print(f"{case}: max |kernel - plain| / limit = {ratio:.4g}{'  FAILS' if ratio > 1 else ''}")
    return cases


def _ln_params(torch, K):
    g = torch.Generator(device="cuda").manual_seed(K)
    return 1 + 0.1 * torch.randn(K, device="cuda", generator=g), 0.1 * torch.randn(K, device="cuda", generator=g)


def _h_buffer(torch, M, K):
    key = ("h", M, K)
    if key not in _operands:
        _operands[key] = torch.empty(M, K, device="cuda", dtype=torch.bfloat16)
    return _operands[key]


def yardsticks(torch, kind):
    """torch.matmul in bf16 on each gemm or lngemm case's operands (timed,
    never used)."""
    shapes = {"gemm": GEMM_SHAPES, "lngemm": LNGEMM_SHAPES,
              "resample": (("K3 product", 131040, 768, 384, 0), ("K4 product", 131040, 384, 768, 0))}.get(kind, ())
    out = {}
    for name, M, K, N, _ in shapes:
        a, w = _gemm_operands(torch, M, K, N)[:2]
        out[f"{name} ({M}, {K}) @ ({K}, {N})"] = (lambda a=a, w=w: torch.matmul(a, w), 2 * M * K * N)
    return out


def host_costs(torch, label, lib, launches=1000):
    """The host's share of one aligned row-GEMM launch, where the variant
    exports skt_rowgemm_host_ns (a 128-row product, so that the card keeps up)."""
    if not hasattr(lib, "skt_rowgemm_host_ns"):
        return
    fn = _bind(lib, "skt_rowgemm_host_ns", [P] * 4 + [I] * 4 + [P, P])
    M, K, N = 128, 512, 512
    dev = torch.device("cuda")
    a, w = torch.zeros(M, K, device=dev, dtype=torch.bfloat16), torch.zeros(K, N, device=dev, dtype=torch.bfloat16)
    b, out = torch.zeros(N, device=dev), torch.empty(M, N, device=dev, dtype=torch.bfloat16)
    ns = (ctypes.c_double * 3)()
    for _ in range(2):  # the second round: the attribute set, the library warm
        err = fn(a.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, launches,
                 torch.cuda.current_stream().cuda_stream, ns)  # fmt: skip
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{label}: skt_rowgemm_host_ns: CUDA error {err}")
    print(f"{label}: host ns a launch over {launches}: three tensor-map encodes {ns[0]:.0f}, "
          f"cudaFuncSetAttribute {ns[1]:.0f}, whole skt_mlp_gemm launch {ns[2]:.0f}")


def round_cases(torch, libs, src):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, M, Lw, SB = 322, 1024, 512, 176
    rows = B * M

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)

    e, gsrc, staged = randn(rows, Lw), randn(rows, Lw, scale=0.3), randn(B, SB, Lw, scale=0.3)
    local = torch.sort(torch.randint(0, SB + 1, (B, M), device=dev, generator=g), dim=1).values.to(torch.int32)
    we, w = randn(Lw, Lw, scale=Lw**-0.5), randn(Lw, Lw, scale=Lw**-0.5)
    b0, b, scale, bias = (torch.randn(Lw, device=dev, generator=g) * 0.1 for _ in range(4))
    h, y, ne = (torch.empty(rows, Lw, device=dev, dtype=torch.bfloat16) for _ in range(3))
    agg = torch.empty(B, SB, Lw, device=dev, dtype=torch.bfloat16)
    rg = _bind(libs["graph_round"], "skt_round_gemm", [P] * 7 + [I] * 4 + [P])
    mg = _bind(libs["fused_mlp"], "skt_mlp_gemm", [P, L, L, I, P, I, P, P, P, P, I, I, I, I, P])
    ln = _ln_rows(libs["fused_mlp"], src)
    ss = _bind(libs["fused_mlp"], "skt_segment_sum", [P, P, P, I, I, I, I, P])
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()  # noqa: E731

    def first():
        return rg(p(e), p(we), p(b0), p(gsrc), p(staged), p(local), p(h), rows, Lw, M, SB, st)

    def second():
        return mg(p(h), Lw, 1, Lw, None, 0, p(w), p(b), None, p(y), rows, Lw, 0, 1, st)

    def norm():
        return ln(p(y), p(scale), p(bias), p(e), p(ne), rows, Lw, 1, 1e-6, st)

    def seg():
        return ss(p(ne), p(local), p(agg), B, M, SB, Lw, st)

    return {
        "round_gemm": (first, 2 * rows * Lw * Lw), "mlp_gemm": (second, 2 * rows * Lw * Lw),
        "ln_rows": (norm, None), "segment_sum": (seg, None),
        "K7 chain": (lambda: first() or second() or norm() or seg(), None),
    }  # fmt: skip


_G2M_PLAN = []


def g2m_cases(torch, libs, _src):
    from skyrim_tpu_torch.ops.graph import build_g2m_tiles, build_graphs, g2m_row_plan

    H, W, Lw = 721, 1440, 512
    if not _G2M_PLAN:  # built once for every variant
        g = build_graphs(H, W, 6)
        gt = build_g2m_tiles(g["g2m_src"], g["g2m_dst"], g["g2m_efeat"], H, W, g["n_mesh"])
        _G2M_PLAN.append((*g2m_row_plan(gt["local"], gt["U"], gt["th"], gt["tw"]), gt["D"]))
    rows_np, csr_np, D = _G2M_PLAN[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    E, n = len(rows_np), len(csr_np) - 1
    rows, csr = torch.from_numpy(rows_np).to(dev), torch.from_numpy(csr_np).to(dev)
    asrc = torch.randn(H * W, Lw, device=dev, generator=g).to(torch.bfloat16)
    bias = (torch.randn(H * W * D, Lw, device=dev, generator=g) * 0.3).to(torch.bfloat16)
    w = (torch.randn(Lw, Lw, device=dev, generator=g) * Lw**-0.5).to(torch.bfloat16)
    b0, b, scale, shift = (torch.randn(Lw, device=dev, generator=g) * 0.1 for _ in range(4))
    m = torch.empty(E, Lw, device=dev, dtype=torch.bfloat16)
    out = torch.empty(n, Lw, device=dev, dtype=torch.bfloat16)
    msg = _bind(libs["graph_g2m"], "skt_g2m_messages", [P] * 9 + [I] * 3 + [F, P])
    cs = _bind(libs["graph_g2m"], "skt_csr_sum", [P] * 3 + [I] * 2 + [P])
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()  # noqa: E731

    def messages():
        return msg(p(asrc), p(bias), p(b0), p(w), p(b), p(scale), p(shift), p(rows), p(m), E, Lw, D, 1e-6, st)

    return {"messages": (messages, 2 * E * Lw * Lw),
            "csr_sum": (lambda: cs(p(m), p(csr), p(out), n, Lw, st), None)}


_M2G_TILES = []


def m2g_cases(torch, libs, src):
    from skyrim_tpu_torch.ops.graph import build_face_tiles, build_graphs

    H, W, Lw = 721, 1440, 512
    if not _M2G_TILES:  # built once for every variant
        ft = build_face_tiles(build_graphs(H, W, 6)["m2g_face"].reshape(H, W), th=8, tw=128)
        _M2G_TILES.append(ft)
    ft = _M2G_TILES[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    TH, TW, U = ft["tile_faces"].shape
    uniq = (torch.randn(TH, TW, U, 3 * Lw, device=dev, generator=g) * 0.3).to(torch.bfloat16)
    local = torch.from_numpy(ft["tile_local"]).to(dev)
    bias = (torch.randn(H * W, 3 * Lw, device=dev, generator=g) * 0.3).to(torch.bfloat16)
    ad = (torch.randn(H * W, Lw, device=dev, generator=g) * 0.3).to(torch.bfloat16)
    w = (torch.randn(Lw, Lw, device=dev, generator=g) * Lw**-0.5).to(torch.bfloat16)
    b0, b, scale, shift = (torch.randn(Lw, device=dev, generator=g) * 0.1 for _ in range(4))
    out = torch.empty(H * W, Lw, device=dev, dtype=torch.bfloat16)
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr()  # noqa: E731
    flops = 2 * 3 * H * W * Lw * Lw
    lib = libs["graph_m2g"]
    if hasattr(lib, "skt_m2g_messages"):
        fn = _bind(lib, "skt_m2g_messages", [P] * 10 + [I] * 7 + [F, P])
        return {"K8": (lambda: fn(p(uniq), p(local), p(bias), p(ad), p(b0), p(w), p(b), p(scale), p(shift), p(out),
                                  H, W, Lw, U, 8, 128, TW, 1e-6, st), flops)}  # fmt: skip
    gemm = _bind(lib, "skt_m2g_gemm", [P] * 8 + [I] * 7 + [P])
    ln = _ln_rows(libs["fused_mlp"], src)
    y = torch.empty(3 * H * W, Lw, device=dev, dtype=torch.bfloat16)

    def first():
        return gemm(p(uniq), p(local), p(bias), p(ad), p(b0), p(w), p(b), p(y), H, W, Lw, U, 8, 128, TW, st)

    def norm():
        return ln(p(y), p(scale), p(shift), None, p(out), H * W, Lw, 3, 1e-6, st)

    return {"K8": (lambda: first() or norm(), flops), "K8 gemm": (first, flops), "K8 ln_rows": (norm, None)}


def _message_operands(torch):
    """K12's, K13's and K14's full-width inputs, made once and shared by the variants."""
    if "messages" not in _operands:
        from skyrim_tpu_torch.ops.graph import build_block_plan, build_graphs

        H, W, Lw, deg = 721, 1440, 512, 3
        N = H * W
        graphs = build_graphs(H, W, 6)
        plan = build_block_plan(graphs["g2m_dst"], graphs["n_mesh"], target_rows=8192)
        B, M = plan["local"].shape
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

        _operands["messages"] = dict(
            N=N, deg=deg, L=Lw, B=B, M=M, SB=plan["SB"], E=len(graphs["mesh_dst"]), x=randn(N, Lw),
            y=torch.empty(N, Lw, device=dev, dtype=torch.bfloat16), wide=randn(N, deg * Lw, scale=0.3),
            bias_w=randn(N, deg * Lw, scale=0.3), ad=randn(N, Lw, scale=0.3), src=randn(B * M, Lw),
            bias=randn(B * M, Lw, scale=0.3), local=torch.from_numpy(plan["local"]).to(dev),
            w=randn(Lw, Lw, scale=Lw**-0.5), b0=randn(Lw, scale=0.1, dtype=torch.float32),
            b=randn(Lw, scale=0.1, dtype=torch.float32), scale=1 + randn(Lw, scale=0.1, dtype=torch.float32),
            shift=randn(Lw, scale=0.1, dtype=torch.float32), out=torch.empty(N, Lw, device=dev, dtype=torch.bfloat16),
            m=torch.empty(B * M, Lw, device=dev, dtype=torch.bfloat16),
            agg=torch.empty(B, plan["SB"], Lw, device=dev, dtype=torch.bfloat16),
        )  # fmt: skip
    return _operands["messages"]


def messages_cases(torch, libs, src):
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops import graph_kernels as GK

    o = _message_operands(torch)
    N, deg, Lw, B, M, SB = (o[k] for k in ("N", "deg", "L", "B", "M", "SB"))
    lib, mlp = libs["graph_finish"], libs["fused_mlp"]
    st = torch.cuda.current_stream().cuda_stream
    p = lambda k: o[k].data_ptr()  # noqa: E731
    seg = _bind(mlp, "skt_segment_sum", [P, P, P, I, I, I, I, P])
    ln = _ln_rows(mlp, src)
    f13, f14 = 2 * N * deg * Lw * Lw, 2 * B * M * Lw * Lw

    def sums():
        return seg(p("m"), p("local"), p("agg"), B, M, SB, Lw, st)

    if hasattr(lib, "skt_fixed_degree_messages"):
        k13 = _bind(lib, "skt_fixed_degree_messages", [P] * 9 + [I] * 3 + [F, P])
        k14 = _bind(lib, "skt_block_messages", [P] * 8 + [I] * 2 + [F, P])

        def fixed():
            return k13(p("wide"), p("bias_w"), p("ad"), p("b0"), p("w"), p("b"), p("scale"), p("shift"), p("out"),
                       N, Lw, deg, 1e-6, st)  # fmt: skip

        def messages():
            return k14(p("src"), p("bias"), p("b0"), p("w"), p("b"), p("scale"), p("shift"), p("m"), B * M, Lw, 1e-6, st)

        def fixed1():  # deg 1 on the first N rows of the (3N, L) views
            return k13(p("wide"), p("bias_w"), p("ad"), p("b0"), p("w"), p("b"), p("scale"), p("shift"), p("out"),
                       N, Lw, 1, 1e-6, st)  # fmt: skip

        cases = {"K13 one launch": (fixed, f13), "K13 deg 1 one launch": (fixed1, f13 // deg),
                 "K14 messages": (messages, f14), "K14 segment_sum": (sums, None),
                 "K14 messages + sum": (lambda: messages() or sums(), f14)}  # fmt: skip
        cases.update(_finish_cases(o, lib, ln, st))
    else:
        gemm13 = _bind(lib, "skt_fixed_degree_gemm", [P] * 7 + [I] * 3 + [P])
        gemm14 = _bind(lib, "skt_finish_gemm", [P] * 6 + [I] * 3 + [P])
        y = torch.empty(N * deg, Lw, device=o["out"].device, dtype=torch.bfloat16)

        def fixed():
            return (gemm13(p("wide"), p("bias_w"), p("ad"), p("b0"), p("w"), p("b"), y.data_ptr(), N, Lw, deg, st)
                    or ln(y.data_ptr(), p("scale"), p("shift"), None, p("out"), N, Lw, deg, 1e-6, st))

        def messages():
            return (gemm14(p("src"), p("bias"), p("b0"), p("w"), p("b"), p("m"), B * M, Lw, Lw, st)
                    or ln(p("m"), p("scale"), p("shift"), None, p("m"), B * M, Lw, 1, 1e-6, st))

        def fixed1():
            return (gemm13(p("wide"), p("bias_w"), p("ad"), p("b0"), p("w"), p("b"), y.data_ptr(), N, Lw, 1, st)
                    or ln(y.data_ptr(), p("scale"), p("shift"), None, p("out"), N, Lw, 1, 1e-6, st))

        cases = {"K13 chain": (fixed, f13), "K13 deg 1 chain": (fixed1, f13 // deg),
                 "K14 messages (GEMM + LayerNorm rows)": (messages, f14),
                 "K14 segment_sum": (sums, None), "K14 chain": (lambda: messages() or sums(), f14)}  # fmt: skip
    # held against the plain versions on the first points and rows
    o["out"].zero_()
    o["m"].zero_()
    fixed()
    messages()
    torch.cuda.synchronize()
    n13, n14 = 21 * 200, 4096
    wb, lnp = (o["w"], o["b"]), (o["scale"], o["shift"])
    checks = [
        ("K13", o["out"][:n13], GK.reference_fixed_degree_messages(o["wide"][:n13], o["bias_w"][:n13], o["ad"][:n13],
                                                                   o["b0"], wb, lnp, deg)),
        ("K14 messages", o["m"][:n14], FM.reference_finish(o["src"][:n14].float() + o["bias"][:n14].float(), o["b0"],
                                                           wb, lnp, torch.bfloat16)),
    ]  # fmt: skip
    for case, (call, _) in cases.items():  # K12's last 4,096 rows, each launch on its own
        if case.startswith("K12"):
            o["y"].zero_()
            call()
            torch.cuda.synchronize()
            n = o["N"] if "grid" in case else o["E"]
            checks.append((case, o["y"][n - 4096 : n].clone(), FM.reference_finish(o["x"][n - 4096 : n], o["b0"], wb,
                                                                                   lnp, torch.bfloat16)))
    for case, out, ref in checks:
        ref = ref.float()
        ratio = float(((out.float() - ref).abs() / (2e-2 * ref.std() + 2 * 2.0**-8 * ref.abs().max())).max())
        print(f"{src}: {case}: max |kernel - plain| / limit = {ratio:.4g}{'  FAILS' if ratio > 1 else ''}")
    return cases


def _finish_cases(o, lib, ln, st):
    """K12 over the grid rows and the mesh edges (the first E rows of the same
    buffers): one launch where the variant exports skt_finish_rows_ln, and
    the chain (the finish GEMM, then the LayerNorm rows in place)."""
    p = lambda k: o[k].data_ptr()  # noqa: E731
    gemm = _bind(lib, "skt_finish_gemm", [P] * 5 + [I] * 3 + [P])
    one = _bind(lib, "skt_finish_rows_ln", [P] * 7 + [I, I, F, P]) if hasattr(lib, "skt_finish_rows_ln") else None
    Lw, cases = o["L"], {}
    for what, n in (("grid rows", o["N"]), ("mesh edges", o["E"])):
        if one:
            cases[f"K12 {what} one launch"] = (lambda n=n: one(p("x"), p("b0"), p("w"), p("b"), p("scale"), p("shift"),
                                                               p("y"), n, Lw, 1e-6, st), 2 * n * Lw * Lw)  # fmt: skip
        cases[f"K12 {what} chain"] = (lambda n=n: gemm(p("x"), p("b0"), p("w"), p("b"), p("y"), n, Lw, Lw, st)
                                      or ln(p("y"), p("scale"), p("shift"), None, p("y"), n, Lw, 1, 1e-6, st),
                                      2 * n * Lw * Lw)  # fmt: skip
    return cases


# K6's full-width shapes: name, rows, Cin, Cin2, Cout, residual (None: no
# LayerNorm, False: LayerNorm, True: LayerNorm and residual), feature-major
MLP_SHAPES = (
    ("embed_grid", 721 * 1440, 174, 0, 512, False, True),
    ("grid_update", 721 * 1440, 512, 0, 512, True, False),
    ("m2g.MLP_0", 721 * 1440, 512, 512, 512, True, False),
    ("mesh MLP", 40962, 512, 512, 512, True, False),
    ("head", 721 * 1440, 512, 0, 83, None, False),
)
_MLP_OPERANDS: dict = {}


def _mlp_operands(torch, M, c1, c2, cout, xt):
    key = (M, c1, c2, cout, xt)
    if key not in _MLP_OPERANDS:
        dev, Lw = torch.device("cuda"), 512
        g = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

        _MLP_OPERANDS[key] = dict(
            x=randn(*((c1, M) if xt else (M, c1))), x2=randn(M, c2) if c2 else None,
            w1=randn(c1 + c2, Lw, scale=(c1 + c2) ** -0.5), b1=randn(Lw, scale=0.1, dtype=torch.float32),
            w2=randn(Lw, cout, scale=Lw**-0.5), b2=randn(cout, scale=0.1, dtype=torch.float32),
            scale=1 + randn(cout, scale=0.1, dtype=torch.float32), shift=randn(cout, scale=0.1, dtype=torch.float32),
            res=randn(M, cout), h=torch.empty(M, Lw, device=dev, dtype=torch.bfloat16),
            y=torch.empty(M, cout, device=dev, dtype=torch.bfloat16),
        )  # fmt: skip
    return _MLP_OPERANDS[key]


def mlp_cases(torch, libs, src):
    lib = libs["fused_mlp"]
    mg = _bind(lib, "skt_mlp_gemm", [P, L, L, I, P, I, P, P, P, P, I, I, I, I, P])
    ln = _ln_rows(lib, src)
    fin = _bind(lib, "skt_mlp_finish", [P] * 7 + [I] * 2 + [F, P]) if hasattr(lib, "skt_mlp_finish") else None
    fm_tma = "A_FEATURE_MAJOR_TMA" in (src / "fused_mlp.cu").read_text()
    st = torch.cuda.current_stream().cuda_stream
    p = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    Lw, cases = 512, {}
    for name, M, c1, c2, cout, res, xt in MLP_SHAPES:
        o = _mlp_operands(torch, M, c1, c2, cout, xt)
        s1m, s1k, mode = (1, M, 2 if fm_tma else 0) if xt else (c1, 1, 1)
        r = o["res"] if res else None

        def first(o=o, s1m=s1m, s1k=s1k, mode=mode, M=M, c1=c1, c2=c2):
            return mg(p(o["x"]), s1m, s1k, c1, p(o["x2"]), c2, p(o["w1"]), p(o["b1"]), None, p(o["h"]), M, Lw, 1, mode, st)

        if res is None:  # no LayerNorm: the second product alone
            def finish(o=o, M=M, cout=cout):
                return mg(p(o["h"]), Lw, 1, Lw, None, 0, p(o["w2"]), p(o["b2"]), None, p(o["y"]), M, cout, 0, 1, st)
        elif fin is not None:
            def finish(o=o, r=r, M=M):
                return fin(p(o["h"]), p(o["w2"]), p(o["b2"]), p(o["scale"]), p(o["shift"]), p(r), p(o["y"]), M, Lw,
                           1e-6, st)  # fmt: skip
        else:
            def finish(o=o, r=r, M=M, cout=cout):
                return (mg(p(o["h"]), Lw, 1, Lw, None, 0, p(o["w2"]), p(o["b2"]), None, p(o["y"]), M, cout, 0, 1, st)
                        or ln(p(o["y"]), p(o["scale"]), p(o["shift"]), p(r), p(o["y"]), M, cout, 1, 1e-6, st))
        flops = 2 * M * ((c1 + c2) * Lw + Lw * cout)
        cases[f"K6 {name}"] = (lambda first=first, finish=finish: first() or finish(), flops)
        if xt:
            cases[f"K6 {name} first product"] = (first, 2 * M * c1 * Lw)
            # the first product's result against torch in f32 on the first 4096 rows
            first()
            torch.cuda.synchronize()
            h = o["x"][:, :4096].T.float() @ o["w1"].float() + o["b1"]
            err = float((o["h"][:4096].float() - torch.nn.functional.silu(h)).abs().max())
            print(f"{src}: K6 {name} first product ({'TMA' if mode == 2 else 'element loads'}): "
                  f"max |kernel - torch| over 4096 rows = {err:.4g}")
    return cases


def mlp_yardsticks(torch, libs):
    """embed_grid's first product as a torch copy of its transpose into
    (N, 176) rows (zero-padded to 16-byte rows) and the aligned rows GEMM."""
    mg = _bind(libs["fused_mlp"], "skt_mlp_gemm", [P, L, L, I, P, I, P, P, P, P, I, I, I, I, P])
    name, M, c1, c2, cout, _, _ = MLP_SHAPES[0]
    o = _mlp_operands(torch, M, c1, c2, cout, True)
    rows = torch.zeros(M, 176, device=o["x"].device, dtype=torch.bfloat16)
    w1 = torch.zeros(176, 512, device=o["x"].device, dtype=torch.bfloat16)
    w1[:c1] = o["w1"]
    st = torch.cuda.current_stream().cuda_stream

    def call():
        rows[:, :c1].copy_(o["x"].t())
        return mg(rows.data_ptr(), 176, 1, 176, None, 0, w1.data_ptr(), o["b1"].data_ptr(), None, o["h"].data_ptr(),
                  M, 512, 1, 1, st)  # fmt: skip

    return {f"K6 {name} first product: transposing copy + aligned rows GEMM": (call, 2 * M * c1 * 512)}


CASES = {"attention": attention_cases, "gemm": gemm_cases, "round": round_cases, "g2m": g2m_cases, "m2g": m2g_cases,
         "mlp": mlp_cases, "lngemm": lngemm_cases, "resample": resample_cases, "messages": messages_cases}  # fmt: skip


def ptxas_reports(srcs: list[Path]) -> int:
    """Compare ptxas's report of every kernel of the libraries built from two
    csrc directories; prints the kernels that differ and the count of the
    identical ones."""
    from skyrim_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(n, name, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", f"{tmp}/{n}-{name}.so",
             str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for n, src in enumerate(srcs) for name in _build.LIBS]  # fmt: skip
        reports: dict = {}
        for n, name, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"{srcs[n]}: nvcc {name}.cu failed\n{log}", file=sys.stderr)
                return 1
            kernel = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:  # the anonymous namespace's hash differs between two copies of a file
                    kernel = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
                elif kernel and ("registers" in line or "stack frame" in line):
                    reports.setdefault((n, name), {}).setdefault(kernel, []).append(line.split("info    :")[-1].strip())
    same = 0
    for name in _build.LIBS:
        a, b = reports.get((0, name), {}), reports.get((1, name), {})
        for kernel in sorted(set(a) | set(b)):
            if a.get(kernel) == b.get(kernel):
                same += 1
            else:
                print(f"{name}: {kernel[:120]}\n  {srcs[0]}: {a.get(kernel)}\n  {srcs[1]}: {b.get(kernel)}")
    print(f"ptxas reports: {same} kernels identical")
    return 0


def main(argv: list[str]) -> int:
    from skyrim_tpu_torch.ops import _build

    if argv[:1] == ["ptxas"] and len(argv) == 3:
        return ptxas_reports([Path(a) if a else _build.CSRC for a in argv[1:]])

    import torch

    if not argv or argv[0] not in CASES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    kind = argv[0]
    variants = []
    for src in argv[1:] or [""]:
        variants.append((src or "package", Path(src) if src else _build.CSRC))

    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for n, (label, src) in enumerate(variants):
            for name in SOURCES[kind]:
                lib = Path(tmp) / f"variant{n}-{name}.so"
                cmd = [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(lib),
                       str(src / f"{name}.cu")]  # fmt: skip
                jobs.append((label, name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs: dict[str, dict] = {}
        for label, name, lib, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"{label}: nvcc {name}.cu failed\n{log}", file=sys.stderr)
                return 1
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Function properties" in line and all(w in line for w in REPORTED[kind]):
                    print(f"{label}: {line.split('for ')[-1][:110]}: {lines[i + 1].strip()}; {lines[i + 2].strip()}")
            libs.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
        calls, refused = {}, 0
        srcs = dict(variants)
        for label, loaded in libs.items():
            cases = CASES[kind](torch, loaded, srcs[label])
            errs = {case: call() for case, (call, _) in cases.items()}
            torch.cuda.synchronize()
            lib = next(iter(loaded.values()))
            lib.skt_error_string.restype = ctypes.c_char_p
            for case, (call, flops) in cases.items():
                if errs[case]:  # left out of the timing
                    print(f"{label}: {case}: the launch was refused: CUDA error {errs[case]} "
                          f"({lib.skt_error_string(errs[case]).decode()})", file=sys.stderr)
                    refused = 1
                else:
                    calls[(label, case)] = (call, flops)
        for case, (call, flops) in yardsticks(torch, kind).items():
            calls[("torch.matmul", case)] = (call, flops)
        if kind == "mlp":
            for case, (call, flops) in mlp_yardsticks(torch, libs[variants[0][0]]).items():
                calls[("torch copy", case)] = (call, flops)
        torch.cuda.synchronize()
        for rnd in range(ROUNDS):
            for (label, case), (call, flops) in calls.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(LAUNCHES):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / LAUNCHES
                rate = f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
                print(f"round {rnd} {label}: {case}: {ms:.4f} ms{rate}", flush=True)
        for label, loaded in libs.items():
            host_costs(torch, label, loaded.get("fused_mlp"))
    return refused


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

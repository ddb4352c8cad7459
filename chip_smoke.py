#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (skyrim_tpu_torch) on one card and check it.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases:
  1. the device, and the card's name and power limit from nvidia-smi;
  2. build every kernel from skyrim_tpu_torch/csrc (one nvcc per source,
     all at once) and print the seconds;
  3. each kernel at its full-width main-path shapes in bf16 against its
     plain PyTorch version on the card, timed with CUDA events beside the
     plain version and, for K2, torch.roll.  Pangu: K1 at stage 1 and
     stage 2, shifted, each row named with its path and the launches of one
     call counted (five: LN1 + qkv and LN2 + fc1 each one ln_gemm launch),
     and its window attention alone with a strong earth bias; K2 at both
     shapes; FengWu's fuser: K1 at (1, 186, 360, 1152), 18 heads, window
     (1, 6, 12), one bias table, the shift (0, 3, 6) and the padding rows
     181-185 in its mask, on the seven-launch chain (C > 512), its
     attention alone, and K2 at the same shape; K2 at FuXi's trunk (1, 96,
     180, 1536), exact against torch.roll; each K1 and K2 row names the
     forecast whose launches it reports; K3 and K4, each one launch, on
     the strided views of the stage
     buffers the forward hands them (K3's odd H, 181, read in place), each
     check refusing three faulty outputs (beta dropped, parity slabs (i, j)
     swapped, each row's statistics from the next row), K4 also held at
     its rounding point (a group mean of 64, by the rms of the error), where
     its LayerNorm run before the bf16 rounding must fail, and
     torch.matmul of each product alone timed beside them.  GraphCast: K6
     once per shape class
     (the feature-major Cin = 174 embedding, the grid update, the decoder's
     node update, the Cout = 83 head, the mesh MLPs), and its output under
     three faults (the grid update's residual dropped; the embedding's K
     tail read from rows 174-175 of its input buffer, which hold 1e4, with
     W1 rows to match; the grid update's LayerNorm statistics of each row
     taken from the next row), which its check must refuse; K7 at the multimesh
     block plan, padding rows included, then with the ids of every block
     shuffled, with one block made of padding rows only, twice on the same
     inputs (the same bits), and with one real edge dropped per block, which
     its check must refuse; the row GEMM alone at ragged shapes (M = 40,962;
     N = 83; K = 174 feature-major; K = 1,024 split 512 + 512) against
     torch.matmul in f32, its TMA store into an output with 64 guard rows
     past a ragged M (N 192 and 512, residual epilogue), which must come back
     bit-identical, and every shape it takes on the main paths (Pangu's
     eight block products, four of them -- LN1 + qkv, LN2 + fc1 + GELU at
     both stages -- with the LayerNorm in the prologue (ops.gemm.ln_gemm),
     timed beside the LayerNorm rows launch + GEMM pair they replace and
     refusing three faults: each row's statistics from the next row, the
     LayerNorm left out, beta dropped; K7's second product, K6's grid
     update) against its plain version, with its rate,
     bound and launches per forward beside torch.matmul's (timed only); K8 and K9 on the real full-width
     tile tables (partial face tiles in K8, its one launch also stored into
     an output with 64 guard rows past H*W, which must come back
     bit-identical; K9 on the tables' row plan of filled
     slots, its two launches -- messages and CSR sum -- also timed apart, and
     its messages stored into an output with 64 guard rows past E, which must
     come back bit-identical); K8's outputs under three faults (slot 2's
     message dropped in a latitude band; slot 0's bias read for every slot;
     each point's dst row taken from the next point) and K9's under two (a
     dropped message, through a row plan the wrapper builds from the edited
     table; a misread slot bias), which their checks must refuse.
     The op layer: K5, K10 and K11 on one qkv at Pangu stage 1 and stage 2
     (124 and 64 bias types at 0.5, shifted mask), the three outputs equal
     after the relayout, K10 (on views of its packed qkv) and K11 beside
     scaled_dot_product_attention (timed only), each row named with the kernel body its shape takes
     (ops/flash_window_attention.py attention_body); K5 and K1 at FuXi's V1
     trunk geometry (window (1, 6, 12), wlen
     72, hd 64; K1 there on its seven-launch chain, C 1536, its row
     reporting the launches of FuXi V1's forecast); K12 over the grid
     rows and the mesh edges, one launch a call (timed over 20 after 5),
     within 2 ulps of its two-launch chain (the finish GEMM, then the
     LayerNorm rows; timed beside it), its store into an output with 64
     guard rows past its rows, and its output under three faults (b0
     dropped, each row's LayerNorm statistics taken from the next row, the
     LayerNorm applied before the bf16 rounding of the product); K13 over the grid
     rows, deg 3, one launch a call (timed over 20 after 5, and 20 single
     launches' least, median and most), its store into an output with 64 guard
     rows past N, which must come back bit-identical, and its output under
     three faults (slot 2's message dropped in a latitude band, slot 0's
     bias read for every slot, each point's dst row taken from the next
     point); K14 on the full-width grid->mesh block plan (target_rows 8192,
     padding rows included), two launches a call (messages, then the
     segmented sum, also timed apart), its messages stored into an output
     with 64 guard rows past its rows, and its output with one row dropped
     per block and with each row's bias taken from the next row; the checks
     must refuse every faulty output.  These ops are entry points of their
     own: each row's launch count is read around one call of the public
     wrapper, the count set to 0 just before.  SFNO's transforms (no kernel
     of the port) at fcnv2_sm's geometry, with TF32 allowed outside them:
     the (721, 1440, 256) analysis and the synthesis onto that grid within
     1e-5 of max|ref| of float64 on the card, the analysis without its
     precision guard refused, and their times;
  4. the main paths, run right after the build and before phase 3, so that
     phase 3's full-width buffers cannot shift what they measure, each after a garbage collection and an emptied cache,
     with every launch count set to 0 just before and
     read just after: GlobalModel("pangu", ic_source="synthetic") at
     721x1440, a 4-step forecast (16 K1, 16 K2, 1 K3, 1 K4 per forward;
     inside them 32 launches of ln_gemm, 32 of the row GEMM through ops.gemm
     -- K1's proj and fc2 -- and no LayerNorm rows launch; all 16 K1 calls
     on the ln_gemm path),
     then GlobalModel("graphcast", ic_source="synthetic"), 721x1440, 83
     channels, latent 512, 16 rounds, refinement 6, a 4-step forecast
     (21 K6, 16 K7, 1 K8, 1 K9 per forward; 20 of the K6 calls finish in
     one launch of the whole-row kernel, counted by rows, width and
     residual, and the LayerNorm rows kernel runs 16 times, K7's only,
     counted by rows and width; the
     cache build's launches are counted apart),
     then GlobalModel("fourcastnet_v2", ic_source="synthetic"), fcnv2_sm at
     721x1440, 73 channels, embed 256, 12 blocks, a 4-step forecast that
     launches no kernel of the port (every count stays 0), then
     GlobalModel("fengwu", ic_source="synthetic"), 721x1440, 69 channels, 2
     frames, fuser 1152 with 18 heads, 16 blocks, a 4-step forecast (16 K1
     on the chain at (1, 186, 360, 1152) and 16 K2 at that shape per
     forward; inside K1 64 launches of the row GEMM through ops.gemm and 32
     of the LayerNorm rows, none of ln_gemm), then GlobalModel("fuxi",
     ic_source="synthetic"), the published Swin-V2 cascade at 721x1440, 70
     channels, 2 frames, 3 stages of 48 blocks at C 1536 (its seed-0
     parameters drawn on the card and given as params), a 4-step forecast
     (48 K2 at (1, 96, 180, 1536) a forward and no other kernel), its stage
     switch (from step 19 two advances take stage 0, then stage 1, each
     equal bit for bit to _forward of that stage) and its two int8 tiers
     on stage 0 (at rest and served through torch._int_mm: resident bytes,
     step ms beside bf16's, peak, the first step within 0.15 mean |diff| /
     mean |bf16| of bf16, 48 K2 a step; then torch._int_mm, int8_dot and
     torch.matmul at the trunk's four product shapes, timed only), then
     FuXi's V1 flavour, one stage (48 K1 on the chain and 48 K2 a forward,
     inside K1 192 launches of the row GEMM and 96 of the LayerNorm rows),
     then GlobalModel("fourcastnet", ic_source="synthetic"), AFNO at
     720x1440, 26 channels, width 768, 12 blocks (no kernel of the port),
     then GlobalModel("dlwp", ic_source="synthetic"), DLWP at 721x1440, 7
     channels, 2 frames in and 2 out a call, face 64, features 64-128-256,
     a 4-step forecast in 2 calls (no kernel of the port: every count 0;
     its ms a call and a 6-h frame, and every kernel of its profiled call);
     for each, its set-up seconds, per-step CUDA-event
     times, peak memory, one profiled step, and rollout(save=True) for 2
     steps into a temporary directory and a reload of the files.  Weights
     are random, from a seed.
     Then the module path: the full-width net's stage-1 and stage-2
     EarthAttention3D modules (one unshifted, one shifted block each),
     forward(x, mask) against the plain composition, 4 K5 launches and no K1
     (K5's stage rows report this count, 2 per stage).  Then the facade:
     Skyrim("pangu", ic_source="file:<IC>").predict(date, "0000",
     lead_time=13, save=True) at 721x1440, the IC written by the port, the
     parameters a seeded init saved as the port's checkpoint and found by
     weights.load_params: 12 h, 2 steps, 2 files, 2 forwards' launches, the
     last file equal to the returned prediction and that equal bit for bit
     to GlobalModel.rollout's last frame, the loaded parameters equal leaf
     for leaf to the checkpoint's; its wall time split into IC read, NetCDF
     writes and the other host time on the host clock, beside the two
     steps' device time by CUDA events; the facade lists the seven models.
     Then the ensembles from one NetCDF IC the port writes (Pangu's and
     DLWP's 70 channels, DLWP's two history frames), Pangu's parameters a
     seed-1 init saved as the port's checkpoint: Skyrim("pangu", "dlwp",
     ic_source="file:<IC>").predict(lead_time=12, save=True) at full width
     (2 Pangu steps, 1 DLWP call, 5 files; each member's step ms and peak;
     torch.cuda.memory_allocated() after each member's release within 64
     MB of its value before it; the mean over the 6 shared channels equal
     bit for bit to the numpy mean of the members' own GlobalModel.rollout
     finals; Pangu's launches of 2 steps; the wall time split as the
     facade's), then ic_ensemble_forecast("pangu", n_members=4, n_steps=2)
     on the checkpoint's parameters loaded once (the control member equal
     bit for bit to GlobalModel.forecast, members 1-3 different, 8 steps'
     launches, ms a member-step); then the data and IO layers: Pangu's 69
     input channels encoded as GFS GRIB2 messages (grib.encode_simple, the
     synthetic source's fields, HGT in metres) with their .idx, served by a
     fake transport put in place of the GFS source's, the byte-range cache
     in a temporary SKYRIM_CACHE; the native GRIB decoder
     (skyrim_tpu_torch/native/gribcore.cc, built with g++) required, the 69
     messages decoded by it and by numpy equal bit for bit (both timed); the
     fetched IC finite and within each message's packing quantum of its
     field (x 9.81 for HGT), a second fetch from the cache;
     Skyrim("pangu", ic_source="gfs").predict(lead_time=12, save=True) on a
     seed-2 checkpoint (2 steps, 2 files, 2 forwards' launches), its files
     equal bit for bit to GlobalModel.rollout's from a file: IC holding the
     fetched field; stream_save_forecast of the same model and IC, 4 steps
     into a local Zarr store, float32 equal bit for bit to stream_rollout's
     frames (wall time beside the steps' CUDA-event times) and float16 with
     3 channels equal bit for bit to those frames cast on the card, beside
     the NetCDF writes of the same 4 frames and every store's bytes;
  5. the small test configurations on the card (kernels) against the CPU
     (plain versions), 4 steps each: Pangu's and GraphCast's, SFNO's,
     FengWu's, FuXi's (Swin-V2, V1, and Swin-V2 int8-served at min_size
     256), AFNO's golden ones and DLWP's (face 16, features (8, 16),
     73x144) (FengWu's and FuXi V1's K1 and FuXi's K2 launched on the card,
     SFNO, AFNO and DLWP launching no kernel of the port);
  6. train (run after phase 4, before phase 3): the gradients of K1 (both
     Pangu stages, shifted, earth bias at 0.5), K2 (both shapes, exact
     against torch.roll's, its backward one K2 launch), K3 and K4 (on the
     stage buffers' views) at full width against autograd through their
     plain versions, within 1e-5 of the largest element; a K1 whose output
     is detached (its kernel path without the Function), which that check
     must refuse; K6-K9's at the
     small GraphCast configuration on the inputs of their first calls in a
     forward.  Then Pangu at its published widths (721x1440, 69 channels,
     embed 192, depths 2-6-6-2, seed-0 parameters, the norm stats the
     dataset's) finetuned by Trainer(TrainConfig(batch_size=1,
     remat=True)).fit on a seeded synthetic dataset in the CDS layout (one
     NetCDF slice of 4 frames, 1.15 GB as float32, in a temporary
     directory): every leaf of net6, norm and consts changed, net24 moved by
     the decay alone with its optimizer step counted, the loss finite and
     falling over the same pair fed three times, that step's CUDA-event ms
     split into forward, backward and optimizer, its peak, its launches by
     kernel (remat: the forward twice, 32 K1, 48 K2 with K2's 16 backward
     launches, 2 K3, 2 K4) and a profile (idle share); the checkpoint,
     loaded by load_params, forecasting bit for bit what the trained tree
     forecasts; one step's leaf gradients on the kernel path and on the
     plain path (the plain blocks each under torch.utils.checkpoint) within
     a relative L2 error of 2e-2, or, for a leaf whose two bf16 gradients
     differ by more (the earth-bias tables), the kernel path's no further
     from the plain path's in f32 than 1.25x the bf16 plain path's;
  7. multi_device (run last): the multi-device layer (skyrim_tpu_torch/parallel)
     on rank processes of this script (--multi-device-rank DIR, a file://
     rendezvous) that share the card over gloo, the exchanged slabs staged
     through host memory; two launches, each with a time limit, a rank that
     fails or hangs failing the phase.  2 ranks: Pangu at its published
     widths (721x1440, embed 192, depths 2-6-6-2; seed-0 parameters drawn
     on the card, the constant masks at random, replicated from rank 0) over
     (dp, lat, lon) = (1, 1, 2), 2 steps (the window covers at both stages,
     stage 1 through the shift); FengWu over (1, 1, 2), 1 step (K1's chain
     at C 1152 on covers); DLWP over (1, 1, 2) in gather mode, 1 call; a
     2-member Pangu IC ensemble (ic_ensemble_forecast, the synthetic IC)
     over (2, 1, 1).  4 ranks: Pangu over (1, 1, 4), 1 step; the IC
     ensemble over (2, 1, 2).  Each output gathered on rank 0 and held to
     the same model, parameters and IC on one process through the kernels
     (the ensembles: mesh=None), max |diff| / mean |one process| <= 1e-2 a
     step, and whether it is bit for bit; each rank's launches by kernel
     equal to its local forwards' (Pangu: K1 16, K2 16, K3 1, K4 1 a
     forward), K1's and K2's by shape (the covers), and no call of K1-K4's
     plain versions; the 4-rank Pangu under three planted faults (every
     window cover's halo from the other side of the ring, the cover offset
     one token off, the constant masks left uncut), each refused, its ratio
     to the limit printed; the backend, the seconds and nvidia-smi's line.

Prints the results on a JSON line (the main paths, the facade, "dlwp",
"ensemble", "ic_ensemble", "data_io", the small configurations,
"multi_device", ...), then

{"kernels": [...]} on a line of its own, then as the last line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, on
any failure, without a CUDA device, or outside a checkout of the repo.
"""

from __future__ import annotations

import datetime
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM
# kernel vs plain on the card: bf16 rounding of intermediates (the residual
# stream above all) and summation order differ, so elementwise
# |kernel - plain| <= 2e-2 * std(plain) + 2 bf16 ulps (2 * 2**-8) of a scale.
# The scale is max|plain| where a residual stream or a LayerNorm output is
# rounded to bf16 on the way (the rounding is that of the largest
# intermediate, not of the output element), and |plain| of the element itself
# where the output is an f32 sum of a varying number of messages (K7's
# aggregates; K9's tile partials, one message to hundreds near the poles), so
# that a missing or wrong message is not hidden under the largest partial's
# ulps.  The roll is exact.
TOL_STD, TOL_ULPS = 2e-2, 2 * 2.0**-8
# K1's window attention alone: its earth bias is drawn at 0.5 (as in
# tests/test_torch_ops.py), so a missing or misindexed bias table moves the
# output well past the same tolerance, measured on the attention output itself
ATTN_BIAS_SCALE = 0.5
# small config, card vs CPU over a 4-step rollout: the golden tolerance of
# tests/test_golden.py (3e-2 * std for mean and spread, 10x for single values)
GOLDEN = 3e-2


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def over_limit(torch, out, ref, per_element: bool) -> float:
    """max over elements of |out - ref| / limit (> 1 fails the check)."""
    out, ref = out.float(), ref.float()
    scale = ref.abs() if per_element else ref.abs().max()
    return float(((out - ref).abs() / (TOL_STD * ref.std() + TOL_ULPS * scale)).max())


def compare(torch, out, ref, name: str, exact: bool = False, per_element: bool = False) -> float:
    check(tuple(out.shape) == tuple(ref.shape), f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    max_err = float((out.float() - ref.float()).abs().max())
    if exact:
        check(max_err == 0.0, f"{name}: not exact, max err {max_err}")
    else:
        ratio = over_limit(torch, out, ref, per_element)
        check(ratio <= 1, f"{name}: max err {max_err:.4g}, {ratio:.3g}x its limit (std {float(ref.float().std()):.4g})")
    return max_err


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_launches(torch, args, window, heads) -> str:
    """One call of fused_swin_block with its kernels' launches counted: its
    path (ops.fused_block.block_path) and the launches, which must be five
    on the ln_gemm path and seven on the chain."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops.gemm import gemm, ln_gemm

    kernels = (ln_gemm, gemm, FB.layernorm, FB.window_attention)
    before = [k.launches for k in kernels]
    FB.fused_swin_block(*args, window, heads)
    torch.cuda.synchronize()
    n = sum(k.launches - b for k, b in zip(kernels, before))
    path = FB.block_path(args[0].shape[-1])
    check(n == {"ln_gemm": 5, "chain": 7}[path], f"K1 at C {args[0].shape[-1]} ({path}) launched {n} kernels a call")
    return f"[{path}: {n} launches a call]"


def kernel_checks(torch, g) -> tuple[list[dict], dict]:
    """Phase 3: every kernel at its main-path shapes against its plain version.
    Returns the kernels' rows and the max errors of the attention-alone checks."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import roll as RL
    from skyrim_tpu_torch.ops.flash_window_attention import attention_body
    from skyrim_tpu_torch.ops.windows import shift_attention_mask, window_partition, window_reverse

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    rows = []
    attn_err = {}
    # (label, (Z, H, W, C, heads, valid_h), window, shift, a bias table per
    # (z, lat) window type): Pangu's two stage widths, and FengWu's fuser
    # (one table, C 1152: K1's seven-launch chain)
    geometries = (("stage 1/4", (8, 186, 360, 192, 6, 181), (2, 6, 12), (1, 3, 6), True),
                  ("stage 2/3", (8, 96, 180, 384, 12, 91), (2, 6, 12), (1, 3, 6), True),
                  ("FengWu fuser", (1, 186, 360, 1152, 18, 181), (1, 6, 12), (0, 3, 6), False))

    # K1 at each geometry, shifted blocks (mask on every one)
    for stage, (Z, H, Wd, C, heads, valid_h), window, shift, per_type in geometries:
        wz, wh, ww = window
        nz, nh, nw = Z // wz, H // wh, Wd // ww
        wlen, hidden = wz * wh * ww, 4 * C
        n_types = nz * nh if per_type else 1
        mask = torch.from_numpy(shift_attention_mask((Z, H, Wd), window, shift, (Z, valid_h, Wd))).to(dev)

        def bias_table(scale):
            return randn(n_types, heads, wlen, wlen, scale=scale) if per_type else randn(heads, wlen, wlen, scale=scale)

        # the window attention alone, every bias type, bias at 0.5
        qkv = randn(Z, H, Wd, 3 * C, dtype=bf16)
        bias = bias_table(ATTN_BIAS_SCALE)
        out = FB.window_attention(qkv, bias, mask, window, heads)
        torch.cuda.synchronize()
        ref = window_reverse(
            FB.reference_window_attention_qkv(window_partition(qkv, window), bias, mask, nw, heads),
            window, (Z, H, Wd),
        )
        attn_err[stage] = compare(torch, out, ref, f"K1 window attention {stage}")
        del qkv, bias, out, ref
        torch.cuda.empty_cache()

        x = randn(Z, H, Wd, C, dtype=bf16)
        args = (
            x,
            (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)),
            bias_table(0.02),
            mask,
            (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)),
            (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
            (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1),
             randn(hidden, C, scale=hidden**-0.5), randn(C, scale=0.1)),
        )
        out = FB.fused_swin_block(*args, window, heads)
        torch.cuda.synchronize()
        ref = FB.reference_swin_block(*args, window, heads)
        err = compare(torch, out, ref, f"K1 {stage}")
        del out, ref
        path = k1_launches(torch, args, window, heads)
        N = Z * H * Wd
        flops = 2 * N * C * (4 * C + 2 * hidden) + 4 * (nz * nh * nw) * heads * wlen * wlen * (C // heads)
        nbytes = 2 * N * C * 2 + 2 * C * (4 * C + 2 * hidden) + args[3].numel() * 4 + args[4].numel() * 4
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(
            name=f"K1 fused_swin_block {stage} {tuple(x.shape)} [attention: {attention_body(wlen, C // heads)} body] {path}",
            shape=tuple(x.shape),
            route="cuda", source="skyrim_tpu_torch/csrc/gemm.cu+rowgemm.cuh+attention.cuh+fused_block.cu",
            replaces="skyrim_tpu/ops/fused_block.py:202", max_abs_err=err,
            ms=time_ms(torch, lambda: FB.fused_swin_block(*args, window, heads), 10),
            plain_ms=time_ms(torch, lambda: FB.reference_swin_block(*args, window, heads), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        del args, x, mask
        torch.cuda.empty_cache()

    # K2 at each geometry (the shifted blocks' frame change), and at FuXi's
    # trunk (both flavours: 48 a forward)
    for stage, (Z, H, Wd, C), s in [(g[0], g[1][:4], g[3]) for g in geometries] + [
            ("FuXi trunk", (1, 96, 180, 1536), (0, 3, 6))]:
        x = randn(Z, H, Wd, C, dtype=bf16)
        err = compare(torch, RL.roll3d(x, s), RL.plain_roll3d(x, s), f"K2 roll3d {stage}", exact=True)
        b_ms, b_by = bound(0, 2 * x.numel() * 2)
        rows.append(dict(
            name=f"K2 roll3d {stage} {tuple(x.shape)}", shape=tuple(x.shape), route="cuda",
            source="skyrim_tpu_torch/csrc/roll.cu", replaces="skyrim_tpu/ops/roll.py:34", max_abs_err=err,
            ms=time_ms(torch, lambda: RL.roll3d(x, s), 20),
            plain_ms=time_ms(torch, lambda: RL.plain_roll3d(x, s), 20),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda: torch.roll(x, tuple(-v for v in s), (0, 1, 2)), 20),
        ))
        del x

    torch.cuda.empty_cache()
    return rows, attn_err


def resample_checks(torch, g) -> tuple[list[dict], dict, dict]:
    """Phase 3, K3 and K4 at Pangu's full width on their main-path inputs,
    each one launch: K3 on the (8, 181, 360, 192) view of the stage-1 buffer
    (8, 186, 360, 192) -> (8, 91, 180, 384), against the plain version on
    the padded copy; K4 on the (8, 91, 180, 384) view of the stage-2 buffer
    (8, 96, 180, 384) -> (8, 182, 360, 192).  Pixels drawn each with its own
    scale and offset and beta at 0.3, so that the faults below show; each
    kernel's check must refuse the outputs of a faulty kernel (beta dropped,
    parity slabs (i, j) swapped, each row's statistics from the next row).
    K4's rounding point apart: with a group mean of 64 (the bias, exact in
    bf16) the LayerNorm's input rounding moves every value by up to half an
    ulp of 64, so the kernel is held there to the plain version that rounds
    where it does, by the rms of the error against 2e-2 * std (a single
    element may flip by an ulp on the f32 summation order), and the
    LayerNorm run before the rounding must fail that.  torch.matmul of each
    product alone is timed beside them (a yardstick; the port never calls
    it).  Returns the kernels' rows, the faults' errors over their limits and
    the yardsticks."""
    from skyrim_tpu_torch.ops import resample as RS

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    C, N = 192, 384
    M = 8 * 91 * 180
    rows, faults = [], {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    def pixels(*shape):  # each pixel its own scale and offset
        lead = (*shape[:-1], 1)
        return randn(*shape) * (0.5 + 3 * torch.rand(*lead, device=dev, generator=g)) + randn(*lead)

    def refused(name, out, ref):
        faults[name] = {"max": over_limit(torch, out, ref, False)}
        log(f"{name}: max err/limit {faults[name]['max']:.4g}")
        check(faults[name]["max"] > 1, f"the check passed a faulty output: {name}")

    def stats(v, shift=0):  # f32 LayerNorm statistics of the last axis, optionally of the row `shift` ahead
        mu = v.mean(-1, keepdim=True)
        var = ((v * v).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        return (torch.roll(mu, -shift, 0), torch.roll(var, -shift, 0)) if shift else (mu, var)

    def layernorm(v, ln, st):
        return (v - st[0]) * torch.rsqrt(st[1] + 1e-6) * ln[0] + ln[1]

    # K3
    x = pixels(8, 186, 360, C).to(bf16)[:, :181]
    ln, wb = (1 + randn(4 * C, scale=0.1), randn(4 * C, scale=0.3)), (randn(4 * C, N, scale=(4 * C) ** -0.5), randn(N, scale=0.1))
    prep = RS.prepare_downsample(ln, wb)
    out = RS.fused_downsample(x, ln, wb, prep)
    torch.cuda.synchronize()
    xp = RS.pad_even_h(x)
    ref = RS.reference_downsample(xp, ln, wb)
    err = compare(torch, out, ref, "K3 fused_downsample")
    del out

    def dense3(h):
        return (h.to(bf16) @ wb[0].to(bf16) + wb[1].to(bf16)).reshape(ref.shape)

    def merged(swap):  # (M, 4C) f32 in the lane order (2i + j) C + c, or (2j + i) C + c
        v = xp.float().reshape(8, 91, 2, 180, 2, C)
        return (v.permute(0, 1, 3, 4, 2, 5) if swap else v.permute(0, 1, 3, 2, 4, 5)).reshape(M, 4 * C)

    refused("K3: beta dropped", RS.reference_downsample(xp, (ln[0], torch.zeros_like(ln[1])), wb), ref)
    v = merged(True)
    refused("K3: parity slabs (i, j) swapped", dense3(layernorm(v, ln, stats(v))), ref)
    v = merged(False)
    refused("K3: each row's statistics from the next row", dense3(layernorm(v, ln, stats(v, 1))), ref)
    del v, ref
    b_ms, b_by = bound(2 * M * 4 * C * N, x.numel() * 2 + M * N * 2 + 4 * C * N * 2)
    rows.append(dict(
        name="K3 fused_downsample (8, 181, 360, 192) in (8, 186, 360, 192) -> (8, 91, 180, 384)", shape=None,
        route="cuda", source="skyrim_tpu_torch/csrc/resample.cu+rowgemm.cuh",
        replaces="skyrim_tpu/ops/resample.py:111", max_abs_err=err,
        ms=time_ms(torch, lambda: RS.fused_downsample(x, ln, wb, prep), 20),
        plain_ms=time_ms(torch, lambda: RS.reference_downsample(RS.pad_even_h(x), ln, wb), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del x, xp, prep
    torch.cuda.empty_cache()

    # K4
    xu = pixels(8, 96, 180, N).to(bf16)[:, :91]
    wb, ln = (randn(N, 4 * C, scale=N**-0.5), randn(4 * C, scale=0.1)), (1 + randn(C, scale=0.1), randn(C, scale=0.3))
    prep = RS.prepare_upsample(wb, ln)
    out = RS.fused_upsample(xu, wb, ln, prep)
    torch.cuda.synchronize()
    ref = RS.reference_upsample(xu, wb, ln)
    err = compare(torch, out, ref, "K4 fused_upsample")
    del out

    def expand(m):  # (Z, H, W, 4 Co) -> (Z, 2H, 2W, Co), group 2i + j to pixel (2h + i, 2w + j)
        return m.reshape(8, 91, 180, 2, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(8, 182, 360, C)

    refused("K4: beta dropped", RS.reference_upsample(xu, wb, (ln[0], torch.zeros_like(ln[1]))), ref)
    refused("K4: parity (i, j) swapped", ref.reshape(8, 91, 2, 180, 2, C).transpose(2, 4).reshape(ref.shape), ref)
    m = expand(xu @ wb[0].to(bf16) + wb[1].to(bf16)).float().reshape(-1, C)
    refused("K4: each row's statistics from the next row", layernorm(m, ln, stats(m, 1)).to(bf16).reshape(ref.shape), ref)
    del m, ref
    # the rounding point
    b64 = 64 + 0.5 * torch.randint(-4, 5, (4 * C,), device=dev, generator=g).float()
    w16 = wb[0].to(bf16).float()
    y = expand(xu.float() @ w16 + b64).reshape(-1, C)
    single = layernorm(y.to(bf16).float(), ln, stats(y.to(bf16).float()))
    unrounded = layernorm(y, ln, stats(y))
    del y
    out = RS.fused_upsample(xu, (wb[0], b64), ln, RS.prepare_upsample((wb[0], b64), ln)).float().reshape(-1, C)
    torch.cuda.synchronize()
    limit = TOL_STD * float(single.std())

    def rms(a):
        return float(((a - single) ** 2).mean().sqrt()) / limit

    rounding = {"kernel": rms(out), "fault": rms(unrounded.to(bf16).float())}
    faults["K4: the group's LayerNorm before the bf16 rounding (rms, group mean 64)"] = {"rms": rounding["fault"]}
    log(f"K4 rounding point, group mean 64: rms err/limit kernel {rounding['kernel']:.4g}, "
        f"LayerNorm before the rounding {rounding['fault']:.4g}")
    check(rounding["kernel"] <= 1, f"K4 at a group mean of 64: rms err {rounding['kernel']:.4g}x its limit")
    check(rounding["fault"] > 1, "K4's rounding check passed the LayerNorm run before the bf16 rounding")
    del out, single, unrounded
    b_ms, b_by = bound(2 * M * N * 4 * C, xu.numel() * 2 + M * 4 * C * 2 + N * 4 * C * 2)
    rows.append(dict(
        name="K4 fused_upsample (8, 91, 180, 384) in (8, 96, 180, 384) -> (8, 182, 360, 192)", shape=None,
        route="cuda", source="skyrim_tpu_torch/csrc/resample.cu+rowgemm.cuh",
        replaces="skyrim_tpu/ops/resample.py:220", max_abs_err=err,
        ms=time_ms(torch, lambda: RS.fused_upsample(xu, wb, ln, prep), 20),
        plain_ms=time_ms(torch, lambda: RS.reference_upsample(xu, wb, ln), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del xu, prep
    torch.cuda.empty_cache()
    # the products alone by torch.matmul, on operands of the same shapes
    yard = {}
    for name, K, Nn in (("K3 product (131040, 768) @ (768, 384)", 4 * C, N), ("K4 product (131040, 384) @ (384, 768)", N, 4 * C)):
        a, w = randn(M, K).to(bf16), randn(K, Nn, scale=K**-0.5).to(bf16)
        yard[f"{name} torch.matmul ms"] = time_ms(torch, lambda: torch.matmul(a, w), 20)
        del a, w
    log(f"K3/K4 yardsticks: {yard}; K4 rounding point: {rounding}")
    torch.cuda.empty_cache()
    return rows, faults, dict(yardsticks=yard, k4_rounding_rms_over_limit=rounding)


def graphcast_kernel_checks(torch, g) -> tuple[list[dict], dict]:
    """Phase 3, GraphCast: K6-K9 at every full-width main-path shape against
    their plain versions, on the real static tables of the full model.
    Returns the kernels' rows and, for three faults fed to K6, three to K8,
    two to K9 and one to K7, how far over its limit each output lies."""
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, build_tables
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops import graph_kernels as GK

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cfg = GraphCastConfig()
    t0 = time.perf_counter()
    t = build_tables(cfg, dev)
    log(f"GraphCast tables at full width built in {time.perf_counter() - t0:.1f} s")
    L, H, W = cfg.latent, cfg.lat, cfg.lon
    N, n_mesh = H * W, t["n_mesh"]
    cin = 2 * cfg.in_channels + 5 + 3

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    def finish_params():
        return (randn(L, scale=0.1), (randn(L, L, scale=L**-0.5), randn(L, scale=0.1)),
                (1 + randn(L, scale=0.1), randn(L, scale=0.1)))

    rows, faults = [], {}

    def row(name, key, source, replaces, err, fn, plain, flops, nbytes, iters=5):
        b_ms, b_by = bound(flops, nbytes)
        rows.append(dict(name=name, shape=key, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, ms=time_ms(torch, fn, iters), plain_ms=time_ms(torch, plain, 2),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K6, one row per shape class of the main path
    mlps = (  # name, N, Cin, Cin2, Cout, ln, residual, feature-major
        ("embed_grid", N, cin, 0, L, True, False, True),
        ("grid_update", N, L, 0, L, True, True, False),
        ("m2g.MLP_0", N, L, L, L, True, True, False),
        ("head", N, L, 0, cfg.in_channels, False, False, False),
        ("mesh MLP", n_mesh, L, L, L, True, True, False),
    )
    for name, n, c1, c2, cout, use_ln, use_res, xt in mlps:
        x = randn(*((c1, n) if xt else (n, c1)), dtype=bf16)
        args = (x, (randn(c1 + c2, L, scale=(c1 + c2) ** -0.5), randn(L, scale=0.1)),
                (randn(L, cout, scale=L**-0.5), randn(cout, scale=0.1)),
                (1 + randn(cout, scale=0.1), randn(cout, scale=0.1)) if use_ln else None)
        kw = dict(x2=randn(n, c2, dtype=bf16) if c2 else None,
                  residual=randn(n, cout, dtype=bf16) if use_res else None, x_transposed=xt)
        out = FM.fused_mlp(*args, **kw)
        torch.cuda.synchronize()
        ref = FM.reference_mlp(*args, **kw)
        err = compare(torch, out, ref, f"K6 {name}")
        del out
        if name in ("embed_grid", "grid_update"):
            faults.update(mlp_faults(torch, g, name, args, kw, ref))
        del ref
        flops = 2 * n * ((c1 + c2) * L + L * cout)
        nbytes = 2 * n * (c1 + c2 + cout * (2 if use_res else 1)) + 2 * ((c1 + c2) * L + L * cout)
        shape = f"({c1}{'T' if xt else ''}{f'+{c2}' if c2 else ''}, {n})->{L}->{cout}"
        row(f"K6 fused_mlp {name} {shape}", (n, c1, c2, cout), "skyrim_tpu_torch/csrc/fused_mlp.cu+rowgemm.cuh",
            "skyrim_tpu/ops/fused_mlp.py:117", err,
            lambda: FM.fused_mlp(*args, **kw), lambda: FM.reference_mlp(*args, **kw), flops, nbytes)
        del x, args, kw
        torch.cuda.empty_cache()

    # K7 on the multimesh block plan (its padding rows included)
    B, M = t["mesh_src_blocks"].shape
    SB = t["mesh_SB"]
    local = t["mesh_local"]
    check(bool((local == SB).any()), "the block plan has no padding rows")
    args = (randn(B, M, L, dtype=bf16), randn(B, M, L, scale=0.3, dtype=bf16), randn(B, SB, L, scale=0.3, dtype=bf16),
            local, randn(L, L, scale=L**-0.5), *finish_params(), SB)
    ne, agg = GK.fused_round_messages(*args)
    torch.cuda.synchronize()
    ne_r, agg_r = GK.reference_round_messages(*args)
    err = max(compare(torch, ne, ne_r, "K7 new edges"),
              compare(torch, agg, agg_r, "K7 aggregates", per_element=True))
    # two calls on the same inputs: the same bits (no atomics in the aggregation)
    ne2, agg2 = GK.fused_round_messages(*args)
    check(bool(torch.equal(ne, ne2)) and bool(torch.equal(agg, agg2)), "K7: two runs on the same inputs differ")
    del ne, ne2, agg2, ne_r
    # the check's power at this shape: with the first real edge of every block
    # dropped from the plan, the kernel's aggregates must fail it
    dropped = local.clone()
    check(bool((dropped < SB).any(1).all()), "a block of the multimesh plan has no real edge")
    dropped[torch.arange(B, device=dev), (dropped < SB).float().argmax(1)] = SB
    k7_fault = over_limit(torch, GK.fused_round_messages(*args[:3], dropped, *args[4:])[1], agg_r, True)
    log(f"K7 fault, one edge dropped in each of {B} blocks: max err/limit {k7_fault:.4g}")
    check(k7_fault > 1, "K7's check passed aggregates with an edge dropped per block")
    del agg, agg_r, dropped
    # the ids of every block in a shuffled order (the aggregation's run
    # detection sees short runs), and one block of padding rows only
    shuffled = torch.gather(local, 1, torch.argsort(torch.rand(B, M, device=dev, generator=g), dim=1))
    padding = local.clone()
    padding[B // 2] = SB
    for what, loc in (("unsorted local", shuffled), ("an all-padding block", padding)):
        vargs = (*args[:3], loc, *args[4:])
        ne, agg = GK.fused_round_messages(*vargs)
        torch.cuda.synchronize()
        ne_r, agg_r = GK.reference_round_messages(*vargs)
        v_err = max(compare(torch, ne, ne_r, f"K7 new edges, {what}"),
                    compare(torch, agg, agg_r, f"K7 aggregates, {what}", per_element=True))
        log(f"K7 with {what}: max_abs_err {v_err:.4g}")
        if loc is padding:
            check(not bool(agg[B // 2].any()), "K7: a block of padding rows aggregated something")
        del ne, agg, ne_r, agg_r
    del shuffled, padding
    n_edges = int((local < SB).sum())
    row(f"K7 fused_round_messages ({B}, {M}, {L}) SB {SB}", (B, M, L, SB),
        "skyrim_tpu_torch/csrc/graph_round.cu+rowgemm.cuh+fused_mlp.cu", "skyrim_tpu/ops/graph_kernels.py:364", err,
        lambda: GK.fused_round_messages(*args), lambda: GK.reference_round_messages(*args),
        # the work this data needs: the products and the edge and gsrc rows
        # of the real edges, not of the padding rows; every output written
        4 * n_edges * L * L, 2 * (2 * n_edges * L + B * M * L + 2 * B * SB * L) + 4 * B * M + 2 * 2 * L * L)
    del args
    torch.cuda.empty_cache()

    # K8 on the full-width face tiles (partial tiles in both dimensions; a
    # partial last 21-point tile of the kernel: 1,038,240 = 21 * 49,440, so
    # none at full width, see the gpu tests)
    TH, TW, U = t["tile_faces"].shape
    m2g_th, m2g_tw = t["m2g_th"], t["m2g_tw"]
    args = (randn(TH, TW, U, 3 * L, scale=0.3, dtype=bf16), t["tile_local"],
            randn(H, W, 3 * L, scale=0.3, dtype=bf16), randn(H, W, L, scale=0.3, dtype=bf16),
            *finish_params(), 3, m2g_th, m2g_tw)
    out = GK.fused_m2g_tiled(*args)
    torch.cuda.synchronize()
    ref = GK.reference_m2g_tiled(*args)
    err = compare(torch, out, ref, "K8 fused_m2g_tiled")
    row(f"K8 fused_m2g_tiled uniq ({TH}, {TW}, {U}, {3 * L}) -> ({H}, {W}, {L})", None,
        "skyrim_tpu_torch/csrc/graph_m2g.cu+rowgemm.cuh", "skyrim_tpu/ops/graph_kernels.py:515", err,
        lambda: GK.fused_m2g_tiled(*args), lambda: GK.reference_m2g_tiled(*args),
        2 * 3 * N * L * L, 2 * (TH * TW * U * 3 * L + N * 3 * L + 2 * N * L) + 4 * N + 2 * L * L)
    m2g_guard_rows(torch, args, out)

    # the check's power at this shape: K8's output under three faults must
    # fail it -- slot 2's message dropped for every point within 10 degrees of
    # the equator (the kernel's output less the plain slot-2 message there),
    # slot 0's bias read for every slot, and each point's dst row (ad) taken
    # from the next point (the off-by-one a 63-row grouping invites)
    uniq, local_hw, bias_hw, ad_hw, b0, wb, ln = args[:7]
    lat = 90 - 180 * torch.arange(H, device=dev) / (H - 1)
    band = (lat.abs() < 10).nonzero().squeeze(1)
    ti, tj = band // m2g_th, torch.arange(W, device=dev) // m2g_tw
    h2 = (uniq[ti[:, None], tj[None, :], local_hw[band].long()][..., 2 * L:].float()
          + bias_hw[band][..., 2 * L:].float() + ad_hw[band].float())
    m2 = FM.reference_finish(h2.reshape(-1, L), b0, wb, ln, bf16).float().view(len(band), W, L)
    dropped = out.clone()
    dropped[band] = (out[band].float() - m2).to(bf16)
    del h2, m2, out
    bias0 = bias_hw.view(H, W, 3, L)[:, :, :1].expand(H, W, 3, L).reshape(H, W, 3 * L)
    ad_next = torch.roll(ad_hw.view(N, L), -1, 0).view(H, W, L)
    for fault, make in ((f"K8: slot 2's message dropped for the {len(band)} latitude rows within 10 degrees "
                         "of the equator", lambda: dropped),
                        ("K8: slot 0's bias read for every slot",
                         lambda: GK.fused_m2g_tiled(uniq, local_hw, bias0, *args[3:])),
                        ("K8: each point's dst row taken from the next point",
                         lambda: GK.fused_m2g_tiled(*args[:3], ad_next, *args[4:]))):
        bad = make()
        faults[fault] = {"max": over_limit(torch, bad, ref, False)}
        log(f"{fault}: max err/limit {faults[fault]['max']:.4g} under the check's rule (2 ulps of max|plain|)")
        check(faults[fault]["max"] > 1, f"K8's check passed a faulty output: {fault}")
        del bad
    del args, ref, dropped, bias0, ad_next, uniq, local_hw, bias_hw, ad_hw
    torch.cuda.empty_cache()

    # K9 on the full-width grid-major tiles
    D, U, th, tw = t["g2m_D"], t["g2m_U"], t["g2m_th"], t["g2m_tw"]
    TH, TW = H // th, W // tw
    args = (randn(H, W, L, dtype=bf16), randn(H, W, D * L, scale=0.3, dtype=bf16), t["g2m_local"],
            *finish_params(), D, U, th, tw)
    plan = (t["g2m_rows"], t["g2m_csr"])  # the tables' row plan, as the main path passes it
    out = GK.fused_g2m_tiled(*args, plan=plan)
    torch.cuda.synchronize()
    ref = GK.reference_g2m_tiled(*args)
    err = compare(torch, out, ref, "K9 fused_g2m_tiled", per_element=True)
    del out
    local = t["g2m_local"]  # (TH, TW, D, th * tw), U = empty slot
    filled = local < U
    n_edges, n_src = int(filled.sum()), int(filled.any(2).sum())
    check(plan[0].shape[0] == n_edges, f"K9's row plan has {plan[0].shape[0]} rows for {n_edges} filled slots")
    row(f"K9 fused_g2m_tiled ({H}, {W}, {L}) -> ({TH}, {TW}, {U}, {L}), {n_edges} filled slots", None,
        "skyrim_tpu_torch/csrc/graph_g2m.cu+rowgemm.cuh", "skyrim_tpu/ops/graph_kernels.py:661", err,
        lambda: GK.fused_g2m_tiled(*args, plan=plan), lambda: GK.reference_g2m_tiled(*args),
        # the work this data needs: the products and the bias rows of the
        # filled slots (the edges), the source rows of the points that have
        # an edge; not the empty slots.  Every output written.
        2 * n_edges * L * L, 2 * (n_src * L + n_edges * L + TH * TW * U * L) + 4 * N * D + 2 * L * L)

    k9_parts = g2m_parts(torch, args, plan, n_edges)

    # the check's power at this shape: the kernel's outputs under two faults
    # must fail it -- one message dropped in every tile within 60 degrees of
    # the equator (where partials sum few messages; the wrapper builds its own
    # row plan from the edited local), and slot 0's bias read for every slot
    lat = 90 - 180 * torch.arange(H, device=dev) / (H - 1)
    tiles = (lat.abs() < 60).view(TH, th).all(1).repeat_interleave(TW).nonzero().squeeze(1)
    dropped = local.clone()
    flat = dropped.view(TH * TW, D * th * tw)
    check(bool((flat[tiles] < U).any(1).all()), "a K9 tile has no message")
    flat[tiles, (flat[tiles] < U).float().argmax(1)] = U
    bias0 = args[1].view(H, W, D, L)[:, :, :1].expand(H, W, D, L).reshape(H, W, D * L)
    for fault, fargs, fplan in ((f"one message dropped in each of {len(tiles)} tiles", (*args[:2], dropped, *args[3:]), None),
                                ("slot 0's bias read for every slot", (args[0], bias0, *args[2:]), plan)):
        out = GK.fused_g2m_tiled(*fargs, plan=fplan)
        faults[fault] = {rule: over_limit(torch, out, ref, pe) for rule, pe in (("per_element", True), ("max", False))}
        log(f"K9 fault, {fault}: max err/limit {faults[fault]['per_element']:.4g} under the check's rule "
            f"(|plain| per element), {faults[fault]['max']:.4g} under 2 ulps of max|plain|")
        check(faults[fault]["per_element"] > 1, f"K9's check passed a faulty output: {fault}")
        del out
    del args, t, ref, dropped, bias0, plan
    torch.cuda.empty_cache()
    faults[f"K7: one edge dropped in each of {B} blocks"] = {"per_element": k7_fault}
    return rows, faults, k9_parts


def mlp_faults(torch, g, name, args, kw, ref) -> dict:
    """K6's check at full width against outputs that a faulty kernel would
    give, each of which must fail it (2 ulps of max|plain|): at the grid
    update, the residual dropped, and each row's LayerNorm statistics taken
    from the next row (computed plainly from the plain pre-LayerNorm rows);
    at embed_grid, the K tail read: the input as rows 0..175 of a buffer whose
    rows 174-175 hold 1e4, with two W1 rows drawn like W1's to match."""
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops.fused_block import _EPS

    bf16 = torch.bfloat16
    x, w1b1, w2b2, ln = args
    bad = {}
    if name == "grid_update":
        bad["K6: the grid update's residual dropped"] = lambda: FM.fused_mlp(*args, **{**kw, "residual": None})

        def stats_of_next_row():
            h = FM._swish_f32(x.float() @ w1b1[0].to(bf16).float() + w1b1[1]).to(bf16)
            y = (h.float() @ w2b2[0].to(bf16).float() + w2b2[1]).to(bf16).float()
            del h
            mu = torch.roll(y.mean(-1, keepdim=True), -1, 0)
            var = torch.roll((y * y).mean(-1, keepdim=True), -1, 0) - mu * mu
            y = ((y - mu) * torch.rsqrt(var.clamp_min(0) + _EPS) * ln[0] + ln[1]).to(bf16)
            return (kw["residual"].float() + y.float()).to(bf16)

        bad["K6: the grid update's LayerNorm statistics of each row taken from the next row"] = stats_of_next_row
    else:
        K1 = x.shape[0]
        xbuf = torch.full((K1 + 2, x.shape[1]), 1e4, device=x.device, dtype=bf16)
        xbuf[:K1] = x
        w1 = torch.cat([w1b1[0], torch.randn(2, w1b1[0].shape[1], device=x.device, generator=g) * K1**-0.5])
        bad["K6: embed_grid's K tail read from input rows 174-175 (1e4)"] = (
            lambda: FM.fused_mlp(xbuf, (w1, w1b1[1]), w2b2, ln, **kw))
    out = {}
    for fault, make in bad.items():
        out[fault] = {"max": over_limit(torch, make(), ref, False)}
        log(f"{fault}: max err/limit {out[fault]['max']:.4g} under the check's rule (2 ulps of max|plain|)")
        check(out[fault]["max"] > 1, f"K6's check passed a faulty output: {fault}")
    return out


def m2g_guard_rows(torch, args, out) -> None:
    """K8's output stored by TMA into a buffer with GUARD_ROWS rows past H*W,
    which must come back bit-identical; the rows before them must equal the
    wrapper's output."""
    from skyrim_tpu_torch.ops import graph_kernels as GK
    from skyrim_tpu_torch.ops.fused_block import _EPS

    uniq, local, bias, ad, b0, wb, ln, _, th, tw = args
    (H, W), (TH, TW, U, _) = local.shape, uniq.shape
    n, L = H * W, ad.shape[-1]
    buf = torch.full((n + GUARD_ROWS, L), SENTINEL, device=ad.device, dtype=torch.int16)
    b0f, w, b = b0.float().contiguous(), wb[0].to(torch.bfloat16).contiguous(), wb[1].float().contiguous()
    scale, shift = ln[0].float().contiguous(), ln[1].float().contiguous()
    lib = GK._m2g_lib()
    err = lib.skt_m2g_messages(uniq.data_ptr(), local.data_ptr(), bias.data_ptr(), ad.data_ptr(), b0f.data_ptr(),
                               w.data_ptr(), b.data_ptr(), scale.data_ptr(), shift.data_ptr(), buf.data_ptr(),
                               H, W, L, U, th, tw, TW, _EPS, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"skt_m2g_messages with guard rows: CUDA error {err}")
    check(bool((buf[n:] == SENTINEL).all()), "K8 wrote a guard row past H*W")
    check(bool(torch.equal(buf[:n].view(torch.bfloat16), out.view(n, L))), "K8's outputs differ between two runs")
    log(f"K8 stored into {GUARD_ROWS} guard rows past H*W: unchanged; two runs: the same bits")


def g2m_parts(torch, args, plan, n_edges) -> dict:
    """K9's two launches timed apart at full width on the tables' plan: the
    messages of the filled slots (prologue, products and LayerNorm in one
    kernel) and the CSR sum; and the messages stored into an output with
    GUARD_ROWS rows past E, which must come back bit-identical."""
    from skyrim_tpu_torch.ops import graph_kernels as GK
    from skyrim_tpu_torch.ops.fused_block import _EPS

    asrc, bias, _, b0, wb, ln, D = args[:7]
    rows, csr = plan
    E, L = rows.shape[0], asrc.shape[-1]
    check(E == n_edges, f"K9's messages cover {E} rows for {n_edges} filled slots")
    m = GK.g2m_messages(asrc, bias, rows, b0, wb, ln, D)
    buf = torch.full((E + GUARD_ROWS, L), SENTINEL, device=asrc.device, dtype=torch.int16)
    b0f, w, b = b0.float().contiguous(), wb[0].to(torch.bfloat16).contiguous(), wb[1].float().contiguous()
    scale, shift = ln[0].float().contiguous(), ln[1].float().contiguous()
    lib = GK._g2m_lib()
    err = lib.skt_g2m_messages(asrc.data_ptr(), bias.data_ptr(), b0f.data_ptr(), w.data_ptr(), b.data_ptr(),
                               scale.data_ptr(), shift.data_ptr(), rows.data_ptr(), buf.data_ptr(), E, L, D,
                               _EPS, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"skt_g2m_messages with guard rows: CUDA error {err}")
    check(bool((buf[E:] == SENTINEL).all()), "K9's messages wrote a guard row past E")
    check(bool(torch.equal(buf[:E].view(torch.bfloat16), m)), "K9's messages differ between two runs")
    del buf
    parts = {"rows": E, "guard_rows_identical": True,
             "messages_ms": time_ms(torch, lambda: GK.g2m_messages(asrc, bias, rows, b0, wb, ln, D), 5),
             "csr_sum_ms": time_ms(torch, lambda: GK.csr_sum(m, csr), 5)}
    log(f"K9 parts at full width: {parts}")
    return parts


# The row GEMM's shapes on the main paths: name, M, K, N, epilogue (what K1
# gives ops.gemm.gemm; "ln", "ln_gelu": ops.gemm.ln_gemm, the
# LayerNorm in the prologue, bias or GELU; "mlp": ops.fused_mlp.mlp_gemm, bias
# only), and the kernel (with its by-shape key) whose launches it shares.
S1, S2, SF = (8, 186, 360, 192), (8, 96, 180, 384), (1, 186, 360, 1152)
GEMM_ROWS = (
    ("Pangu stage 1/4 LN1 + qkv", 535680, 192, 576, "ln", ("K1", S1)),
    ("Pangu stage 1/4 proj + residual", 535680, 192, 192, "residual", ("K1", S1)),
    ("Pangu stage 1/4 LN2 + fc1 + GELU", 535680, 192, 768, "ln_gelu", ("K1", S1)),
    ("Pangu stage 1/4 fc2 + residual", 535680, 768, 192, "residual", ("K1", S1)),
    ("Pangu stage 2/3 LN1 + qkv", 138240, 384, 1152, "ln", ("K1", S2)),
    ("Pangu stage 2/3 proj + residual", 138240, 384, 384, "residual", ("K1", S2)),
    ("Pangu stage 2/3 LN2 + fc1 + GELU", 138240, 384, 1536, "ln_gelu", ("K1", S2)),
    ("Pangu stage 2/3 fc2 + residual", 138240, 1536, 384, "residual", ("K1", S2)),
    ("FengWu fuser qkv", 66960, 1152, 3456, "bias", ("K1", SF)),
    ("FengWu fuser proj + residual", 66960, 1152, 1152, "residual", ("K1", SF)),
    ("FengWu fuser fc1 + GELU", 66960, 1152, 4608, "gelu", ("K1", SF)),
    ("FengWu fuser fc2 + residual", 66960, 4608, 1152, "residual", ("K1", SF)),
    ("K7's second product", 322 * 1024, 512, 512, "mlp", ("K7", None)),
    ("K6 grid_update, one product", 721 * 1440, 512, 512, "mlp", ("K6", (721 * 1440, 512, 0, 512))),
)
GUARD_ROWS, SENTINEL = 64, 0x7FA5  # a bf16 NaN pattern no product writes


def row_gemm_checks(torch, g) -> tuple[list[dict], dict]:
    """Phase 3, the row GEMM alone (csrc/rowgemm.cuh): its ragged edges
    through skt_mlp_gemm against torch.matmul in f32 on the same bf16
    operands, within the kernel tolerance; the TMA store into an output with
    GUARD_ROWS rows past M (skt_gemm_bf16 called through the library, residual
    epilogue, M not a multiple of the row tile, N 192 and 512), which must come
    back bit-identical; then every shape of the main paths (GEMM_ROWS)
    against its plain version, timed with torch.matmul in bf16 on the same
    operands beside it (the yardstick: called nowhere in the port), the
    LayerNorm-prologue rows also with the pair of launches they replace and
    under three faults (ln_gemm_faults).  Returns the rows and the faults'
    errors over the limit."""
    import ctypes

    from skyrim_tpu_torch.ops import _build
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops.gemm import gemm, ln_gemm, plain_gemm, plain_ln_gemm

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    out = []
    for what, M, K1, K2, N, xt in (("M 40,962", 40962, 512, 0, 512, False), ("N 83", 40962, 512, 0, 83, False),
                                   ("K 174 feature-major", 40962, 174, 0, 512, True),
                                   ("K 1,024 split 512 + 512", 40962, 512, 512, 512, False)):
        a = randn(*((K1, M) if xt else (M, K1)), dtype=bf16)
        a2 = randn(M, K2, dtype=bf16) if K2 else None
        w, b = randn(K1 + K2, N, scale=(K1 + K2) ** -0.5, dtype=bf16), randn(N, scale=0.1)
        c = FM.mlp_gemm(a, w, b, a2=a2, transposed=xt)
        torch.cuda.synchronize()
        rows = a.T.float() if xt else a.float()
        ref = (rows if a2 is None else torch.cat([rows, a2.float()], dim=1)) @ w.float() + b
        out.append(dict(name=f"row GEMM, {what}: ({M}, {K1 + K2}) @ ({K1 + K2}, {N})",
                        max_abs_err=compare(torch, c, ref, f"row GEMM, {what}")))
        del a, a2, w, b, c, rows, ref

    lib = _build.load("gemm")
    fn = lib.skt_gemm_bf16
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    for M, K, N in ((40962, 384, 192), (40962, 512, 512)):
        a, w, b = randn(M, K, dtype=bf16), randn(K, N, scale=K**-0.5, dtype=bf16), randn(N, scale=0.1)
        r = randn(M, N, dtype=bf16)
        buf = torch.full((M + GUARD_ROWS, N), SENTINEL, device=dev, dtype=torch.int16)
        _build.check(lib, fn(a.data_ptr(), w.data_ptr(), b.data_ptr(), r.data_ptr(), buf.data_ptr(), M, N, K, 2,
                             torch.cuda.current_stream().cuda_stream), "skt_gemm_bf16 with guard rows")  # fmt: skip
        torch.cuda.synchronize()
        name = f"row GEMM, TMA store with {GUARD_ROWS} guard rows: ({M}, {K}) @ ({K}, {N}) + residual"
        check(bool((buf[M:] == SENTINEL).all()), f"{name}: a guard row past M was written")
        err = compare(torch, buf[:M].view(bf16), plain_gemm(a, w, b, residual=r), name)
        out.append(dict(name=name, max_abs_err=err, guard_rows_identical=True))
        del a, w, b, r, buf

    faults = {}
    for what, M, K, N, epi, launch_of in GEMM_ROWS:
        a, w, b = randn(M, K, dtype=bf16), randn(K, N, scale=K**-0.5, dtype=bf16), randn(N, scale=0.1)
        r = randn(M, N, dtype=bf16) if epi == "residual" else None
        gelu, extra = epi in ("gelu", "ln_gelu"), {}
        if epi.startswith("ln"):
            # rows of the residual stream's kind: each its own scale and
            # offset, so that a LayerNorm left out or misapplied shows; beta
            # drawn at 0.3 so that its drop does
            a = (a.float() * (0.5 + 3 * torch.rand(M, 1, device=dev, generator=g)) + randn(M, 1)).to(bf16)
            ln = (1 + randn(K, scale=0.1), randn(K, scale=0.3))
            fn = lambda: ln_gemm(a, ln, w, b, gelu=gelu)  # noqa: E731
            ref = plain_ln_gemm(a, ln, w, b, gelu=gelu)
        elif epi == "mlp":
            fn = lambda: FM.mlp_gemm(a, w, b)  # noqa: E731
            ref = plain_gemm(a, w, b)
        else:
            fn = lambda: gemm(a, w, b, gelu=gelu, residual=r)  # noqa: E731
            ref = plain_gemm(a, w, b, gelu=gelu, residual=r)
        c = fn()
        torch.cuda.synchronize()
        err = compare(torch, c, ref, f"row GEMM, {what}")
        del c
        if epi.startswith("ln"):
            faults.update(ln_gemm_faults(torch, what, a, ln, w, b, gelu, ref))
            h = FB.layernorm(a, *ln)
            # the pair it replaces (the LayerNorm rows launch, then the aligned
            # GEMM on h), and that GEMM alone
            extra = dict(pair_ms=time_ms(torch, lambda: gemm(FB.layernorm(a, *ln), w, b, gelu=gelu), 10),
                         gemm_alone_ms=time_ms(torch, lambda: gemm(h, w, b, gelu=gelu), 10))
            del h
        del ref
        ms = time_ms(torch, fn, 10)
        lib_ms = time_ms(torch, lambda: torch.matmul(a, w), 10)
        flops = 2 * M * K * N
        b_ms, b_by = bound(flops, 2 * (M * K + K * N + M * N * (2 if r is not None else 1)))
        out.append(dict(name=f"row GEMM, {what}: ({M}, {K}) @ ({K}, {N})", max_abs_err=err, ms=ms,
                        tflops=flops / ms / 1e9, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        library_tflops=flops / lib_ms / 1e9, **extra, launch_of=launch_of))
        del a, w, b, r
        torch.cuda.empty_cache()
    for r in out:
        log("  ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
    return out, faults


def ln_gemm_faults(torch, what, x, ln, w, b, gelu, ref) -> dict:
    """ln_gemm's check at full width against outputs that a faulty kernel
    would give, each of which must fail it (2 ulps of max|plain|): each row's
    LayerNorm statistics taken from the next row, the LayerNorm left out (x
    multiplied as it is), beta dropped (computed plainly)."""
    from skyrim_tpu_torch.ops.gemm import _EPS, plain_gemm, plain_ln_gemm

    xf = x.float()
    mu = torch.roll(xf.mean(-1, keepdim=True), -1, 0)
    var = torch.roll((xf * xf).mean(-1, keepdim=True), -1, 0) - mu * mu
    h_next = ((xf - mu) * torch.rsqrt(var.clamp_min(0) + _EPS) * ln[0] + ln[1]).to(torch.bfloat16)
    del xf, mu, var
    bad = {
        f"K1 {what}: each row's LayerNorm statistics taken from the next row": lambda: plain_gemm(h_next, w, b, gelu=gelu),
        f"K1 {what}: the LayerNorm left out": lambda: plain_gemm(x, w, b, gelu=gelu),
        f"K1 {what}: beta dropped": lambda: plain_ln_gemm(x, (ln[0], torch.zeros_like(ln[1])), w, b, gelu=gelu),
    }
    out = {}
    for fault, make in bad.items():
        out[fault] = {"max": over_limit(torch, make(), ref, False)}
        log(f"{fault}: max err/limit {out[fault]['max']:.4g} under the check's rule (2 ulps of max|plain|)")
        check(out[fault]["max"] > 1, f"ln_gemm's check passed a faulty output: {fault}")
    return out


def op_row(torch, rows, name, source, replaces, wrapper, args, plain, flops, nbytes, *,
           per_element=False, library=None, iters=5, warmup=1):
    """One row of an op-layer kernel: the public wrapper against its plain
    version on the same inputs, then one counted call (the op is its own
    entry point), then the times.  Returns the wrapper's output."""
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = compare(torch, out, ref, name, per_element=per_element)
    del ref
    wrapper.launches = 0
    again = wrapper(*args)
    torch.cuda.synchronize()
    launches = wrapper.launches
    check(launches == 1, f"{name}: one call of the wrapper counted {launches} launches")
    check(bool(torch.equal(again, out)), f"{name}: two runs on the same inputs differ")
    del again
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name=name, shape=None, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=err, ms=time_ms(torch, lambda: wrapper(*args), iters, warmup),
        plain_ms=time_ms(torch, lambda: plain(*args), 2), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, library, iters) if library else None,
    ))
    return out


def attention_op_checks(torch, g) -> list[dict]:
    """Phase 3, the attention ops: K5, K10, K11 at Pangu's two stage shapes on
    one qkv (bias at ATTN_BIAS_SCALE, shifted mask), then K5 and K1 at FuXi's
    V1 trunk geometry.  Returns the rows; K5's stage rows carry the shape
    under which the module path counts its launches."""
    import torch.nn.functional as F

    from skyrim_tpu_torch.ops import flash_window_attention as FA
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops.windows import shift_attention_mask, window_partition

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    src = "skyrim_tpu_torch/csrc/window_attention.cu+attention.cuh"
    jax_src = "skyrim_tpu/ops/flash_window_attention.py"

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    def attn_work(n_win, heads, wlen, hd, bias, mask):
        C = heads * hd
        return (4 * n_win * heads * wlen * wlen * hd,
                2 * n_win * wlen * 4 * C + 4 * bias.numel() + (4 * mask.numel() if mask is not None else 0))

    rows = []
    window, wlen = (2, 6, 12), 144
    for stage, (Z, H, Wd, C, heads, valid_h) in (("stage 1/4", (8, 186, 360, 192, 6, 181)),
                                                 ("stage 2/3", (8, 96, 180, 384, 12, 91))):
        nz, nh, nw = Z // 2, H // 6, Wd // 12
        n_win, hd = nz * nh * nw, C // heads
        mask = torch.from_numpy(shift_attention_mask((Z, H, Wd), window, (1, 3, 6), (Z, valid_h, Wd))).to(dev)
        bias = randn(nz * nh, heads, wlen, wlen, scale=ATTN_BIAS_SCALE)
        qkv = randn(Z, H, Wd, 3 * C, dtype=bf16)
        flops, nbytes = attn_work(n_win, heads, wlen, hd, bias, mask)
        body = f"[{FA.attention_body(wlen, hd)} body]"
        # the yardstick of K10 and K11: one library call on the same inputs,
        # the additive bias + mask as a materialised bf16 attn_mask; timed,
        # used nowhere
        attn_mask = (bias[:, None] + mask.view(nz * nh, 1, 1, wlen, wlen)).to(bf16)
        attn_mask = attn_mask.expand(nz * nh, nw, heads, wlen, wlen).reshape(n_win, heads, wlen, wlen)
        out5 = op_row(torch, rows, f"K5 fused_window_attention_4d {stage} {tuple(qkv.shape)} {body}", src, f"{jax_src}:226",
                      FA.fused_window_attention_4d, (qkv, bias, mask, window, heads),
                      FA.reference_window_attention_4d, flops, nbytes, iters=10)
        rows[-1]["shape"] = (Z, H, Wd, C)  # the module path's launches at this width
        parts = window_partition(qkv, window).contiguous()
        del qkv
        qv, kv, vv = parts.view(n_win, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)  # views
        out10 = op_row(torch, rows, f"K10 fused_window_attention {stage} {tuple(parts.shape)} {body}", src, f"{jax_src}:105",
                       FA.fused_window_attention, (parts, bias, mask, nw, heads),
                       FA.reference_window_attention_qkv, flops, nbytes, iters=10,
                       library=lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=attn_mask))
        del qv, kv, vv
        compare(torch, out10, window_partition(out5, window), f"K10 against K5 after the partition, {stage}", exact=True)
        del out5
        q, k, v = parts.view(n_win, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        del parts
        out11 = op_row(torch, rows, f"K11 flash_window_attention {stage} {tuple(q.shape)} {body}", src, f"{jax_src}:358",
                       FA.flash_window_attention, (q, k, v, bias, mask, nw),
                       FA.reference_window_attention, flops, nbytes, iters=10,
                       library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
        compare(torch, out11.transpose(1, 2).reshape(n_win, wlen, C), out10,
                f"K11 against K10 after the head merge, {stage}", exact=True)
        sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        log(f"{stage}: max |scaled_dot_product_attention - K11| = {float((sdpa.float() - out11.float()).abs().max()):.4g}")
        del q, k, v, out10, out11, sdpa, attn_mask, bias, mask
        torch.cuda.empty_cache()

    # FuXi's V1 trunk (and FengWu's fuser): window (1, 6, 12), wlen 72, hd 64,
    # one bias table, the latitude padding 90 -> 96 and the shift in the mask
    window, wlen, dims, C, heads = (1, 6, 12), 72, (1, 96, 180), 1536, 24
    Z, H, Wd = dims
    mask = torch.from_numpy(shift_attention_mask(dims, window, (0, 3, 6), (1, 90, 180))).to(dev)
    check(tuple(mask.shape) == (1, 16, wlen, wlen), f"FuXi-geometry mask shape {tuple(mask.shape)}")
    bias = randn(heads, wlen, wlen, scale=ATTN_BIAS_SCALE)
    qkv = randn(Z, H, Wd, 3 * C, dtype=bf16)
    flops, nbytes = attn_work(16 * 15, heads, wlen, C // heads, bias, mask)
    body = f"[{FA.attention_body(wlen, C // heads)} body]"
    op_row(torch, rows, f"K5 fused_window_attention_4d FuXi V1 trunk {tuple(qkv.shape)} {body}", src, f"{jax_src}:226",
           FA.fused_window_attention_4d, (qkv, bias, mask, window, heads),
           FA.reference_window_attention_4d, flops, nbytes, iters=10)
    del qkv
    hidden, N = 4 * C, Z * H * Wd
    args = (
        randn(Z, H, Wd, C, dtype=bf16),
        (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
        (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)),
        randn(heads, wlen, wlen, scale=0.02), mask,
        (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)),
        (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
        (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1),
         randn(hidden, C, scale=hidden**-0.5), randn(C, scale=0.1)),
        window, heads,
    )
    path = k1_launches(torch, args[:-2], *args[-2:])
    op_row(torch, rows, f"K1 fused_swin_block FuXi V1 trunk {(Z, H, Wd, C)} [attention: {FA.attention_body(wlen, C // heads)} body] {path}",
           "skyrim_tpu_torch/csrc/fused_block.cu+attention.cuh+gemm.cu", "skyrim_tpu/ops/fused_block.py:202",
           FB.fused_swin_block, args, FB.reference_swin_block,
           2 * N * C * (4 * C + 2 * hidden) + 4 * 16 * 15 * heads * wlen * wlen * (C // heads),
           2 * N * C * 2 + 2 * C * (4 * C + 2 * hidden) + 4 * args[3].numel() + 4 * mask.numel(), iters=10)
    del rows[-1]["launches"]  # a forecast's kernel: its launches on FuXi V1's forecast
    rows[-1]["shape"] = (Z, H, Wd, C)
    del args, mask, bias
    torch.cuda.empty_cache()
    return rows


def message_launches(torch, wrapper, args, expect: int, path: str) -> str:
    """One call of K12, K13 or K14 with the launches of every kernel any of
    them may take counted (K12's one launch, K13's own, K14's messages, the
    segmented sum, the finish GEMM and the LayerNorm rows of the chains):
    K12 and K13 must be one launch and K14 two."""
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops import graph_kernels as GK

    def count():
        return (GK.fused_fixed_degree_messages.launches + GK.block_messages.launches + FM.segment_sum.launches
                + FM.finish_rows_ln.launches + FM.finish_gemm.launches + sum(FM.ln_rows.launches_by_shape.values()))

    before = count()
    wrapper(*args)
    torch.cuda.synchronize()
    n = count() - before
    check(n == expect, f"{wrapper.__name__} launched {n} kernels a call, expected {expect}")
    return f"[{path}: {n} launch{'es' if n > 1 else ''} a call]"


def message_guard_rows(torch, lib_fn, n, L, out, what) -> None:
    """A message kernel's output stored by TMA into a buffer with GUARD_ROWS
    rows past its n rows, which must come back bit-identical; the rows before
    them must equal the wrapper's output.  lib_fn(buf) launches it."""
    buf = torch.full((n + GUARD_ROWS, L), SENTINEL, device=out.device, dtype=torch.int16)
    err = lib_fn(buf)
    torch.cuda.synchronize()
    check(err == 0, f"{what} with guard rows: CUDA error {err}")
    check(bool((buf[n:] == SENTINEL).all()), f"{what} wrote a guard row past its {n} rows")
    check(bool(torch.equal(buf[:n].view(torch.bfloat16), out.view(n, L))), f"{what}: outputs differ between two runs")
    log(f"{what} stored into {GUARD_ROWS} guard rows past its {n} rows: unchanged; two runs: the same bits")


def finish_chain(torch, x, b0, wb, ln):
    """K12's two-launch chain on the same rows, kernels independent of its
    one launch: the finish GEMM (rowgemm_kernel, the swish in its A loader),
    then the LayerNorm rows kernel.  Returns (y, chain): the bf16 product
    and the chain's output."""
    from skyrim_tpu_torch.ops import fused_mlp as FM

    y = FM.finish_gemm(x, b0, wb)
    return y, FM.ln_rows(y, ln, out=torch.empty_like(y))


def chain_over(torch, outs, y, chain, ln) -> list[float]:
    """max |out - chain| / limit for each of outs, the limit 2 bf16 ulps of
    the chain's value plus four f32 roundings (2^-22) of the LayerNorm's last
    terms |(y - mean)·rstd·scale| + |shift| (where those cancel, the f32
    rounding of two LayerNorms can exceed a bf16 ulp of the result), as
    tests/test_torch_messages.py holds K12-K14 to the chain.  In f64, 2^17
    rows at a time."""
    from skyrim_tpu_torch.ops.fused_block import _EPS

    scale, shift = (v.double() for v in ln)
    worst = [0.0] * len(outs)
    for r0 in range(0, y.shape[0], 1 << 17):
        rows = slice(r0, r0 + (1 << 17))
        yy = y[rows].double()
        mean, var = yy.mean(1, keepdim=True), yy.var(1, unbiased=False, keepdim=True)
        terms = ((yy - mean) * torch.rsqrt(var + _EPS) * scale).abs() + shift.abs()
        c = chain[rows].double()
        tol = 2 * torch.exp2(torch.floor(torch.log2(c.abs().clamp_min(2.0**-100))) - 7) + 2.0**-22 * terms
        for i, out in enumerate(outs):
            worst[i] = max(worst[i], float(((out[rows].double() - c).abs() / tol).max()))
    return worst


def finish_faults(torch, args, y, chain, ref) -> dict:
    """K12's output under three faults, each refused by its check against the
    chain (and reported under the plain version's rule): b0 dropped (through
    the kernel); each row's LayerNorm statistics taken from the next row; the
    LayerNorm applied to the product before its bf16 rounding."""
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops.fused_block import _EPS, _layernorm_f32

    x, b0, wb, ln = args
    bf16 = torch.bfloat16

    def next_row_statistics():
        yf = y.float()
        nxt = torch.roll(yf, -1, 0)
        mean, var = nxt.mean(1, keepdim=True), nxt.var(1, unbiased=False, keepdim=True)
        return ((yf - mean) * torch.rsqrt(var + _EPS) * ln[0].float() + ln[1].float()).to(bf16)

    def layernorm_before_rounding():
        h = FM._swish_f32(x.float() + b0.float()).to(bf16)
        return _layernorm_f32(h.float() @ wb[0].to(bf16).float() + wb[1].float(), *ln).to(bf16)

    out = {}
    for fault, make in (("K12: b0 dropped", lambda: FM.fused_finish(x, torch.zeros_like(b0), wb, ln)),
                        ("K12: each row's LayerNorm statistics taken from the next row", next_row_statistics),
                        ("K12: the LayerNorm applied before the bf16 rounding of y", layernorm_before_rounding)):
        bad = make()
        out[fault] = {"chain": chain_over(torch, [bad], y, chain, ln)[0], "max": over_limit(torch, bad, ref, False)}
        del bad
        log(f"{fault}: max err/limit {out[fault]['chain']:.4g} under the chain check (2 ulps of the chain), "
            f"{out[fault]['max']:.4g} under the plain check (2 ulps of max|plain|)")
        check(out[fault]["chain"] > 1, f"K12's check passed a faulty output: {fault}")
    return out


def message_op_checks(torch, g) -> tuple[list[dict], dict, dict]:
    """Phase 3, the finish and untiled message ops at GraphCast's full width:
    K12 over the grid rows and the mesh edges, K13 over the grid rows (deg 3),
    K14 on the grid->mesh block plan.  Each names its path and launches a
    call and stores into 64 guard rows; K12 is also held within 2 ulps of its
    two-launch chain, timed beside it; the checks must refuse faulty outputs
    (K12 three, K13 three, K14 two).  Returns the rows, how far over its
    limit each faulty output lies, and the parts: K12's chain timed at both
    shapes, K13's single launches (least, median, most of 20) and K14's two
    launches timed apart."""
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops import graph as G
    from skyrim_tpu_torch.ops import graph_kernels as GK
    from skyrim_tpu_torch.ops.fused_block import _EPS

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cfg = GraphCastConfig()
    L, H, W = cfg.latent, cfg.lat, cfg.lon
    N = H * W
    graphs = G.build_graphs(cfg.lat, cfg.lon, cfg.mesh_refinements)  # cached by the tables' build
    src = "skyrim_tpu_torch/csrc/graph_finish.cu+fused_mlp.cu"
    stream = torch.cuda.current_stream().cuda_stream
    lib = GK._messages_lib()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)

    def finish_params(cout=L):
        return (randn(L, scale=0.1), (randn(L, cout, scale=L**-0.5), randn(cout, scale=0.1)),
                (1 + randn(cout, scale=0.1), randn(cout, scale=0.1)))

    def operands(b0, wb, ln):  # the launch's own f32 / bf16 operands, held by the caller
        return (b0.float().contiguous(), wb[0].to(bf16).contiguous(), wb[1].float().contiguous(),
                ln[0].float().contiguous(), ln[1].float().contiguous())

    rows, faults, parts = [], {}, {}
    flib = FM._finish_lib()
    for what, n in (("grid rows", N), ("mesh edges", len(graphs["mesh_dst"]))):
        args = (randn(n, L, dtype=bf16), *finish_params())
        check(FM.finish_path(L, L) == "rows_ln", f"K12 at ({n}, {L}) -> {L} takes {FM.finish_path(L, L)}")
        path = message_launches(torch, FM.fused_finish, args, 1, "rows_ln<1>, the swish in place")
        plain = lambda x, b0, wb, ln: FM.reference_finish(x, b0, wb, ln, bf16)  # noqa: E731
        out = op_row(torch, rows, f"K12 fused_finish {what} ({n}, {L})->{L} {path}", src,
                     "skyrim_tpu/ops/fused_mlp.py:247", FM.fused_finish, args, plain,
                     2 * n * L * L, 2 * n * 2 * L + 2 * L * L, iters=20, warmup=5)
        y, chain = finish_chain(torch, *args)
        over = chain_over(torch, [out], y, chain, args[3])[0]
        log(f"K12 {what}: max |one launch - chain| / limit = {over:.4g} (2 ulps of the chain)")
        check(over <= 1, f"K12 {what}: one launch {over:.3g}x its limit from the two-launch chain")
        parts[f"k12_{what.replace(' ', '_')}_chain_ms"] = time_ms(torch, lambda: finish_chain(torch, *args), 20, 5)
        ops = operands(*args[1:])
        message_guard_rows(torch, lambda buf: flib.skt_finish_rows_ln(
            args[0].data_ptr(), *(t.data_ptr() for t in ops), buf.data_ptr(), n, L, _EPS, stream), n, L, out,
            f"K12 {what}")
        if what == "grid rows":
            faults.update(finish_faults(torch, args, y, chain, plain(*args)))
        del args, out, y, chain, ops
        torch.cuda.empty_cache()
    log(f"K12's chain at full width: {parts}")

    # K13 over the grid rows, deg 3: one launch of rows_ln_kernel<3>
    deg = 3
    args = (randn(N, deg * L, scale=0.3, dtype=bf16), randn(N, deg * L, scale=0.3, dtype=bf16),
            randn(N, L, scale=0.3, dtype=bf16), *finish_params(), deg)
    path = message_launches(torch, GK.fused_fixed_degree_messages, args, 1,
                            f"rows_ln<{deg}>, {GK.rows_ln_tile(deg)[1]} points a tile")
    out = op_row(torch, rows, f"K13 fused_fixed_degree_messages ({N}, {deg}x{L}) -> ({N}, {L}) {path}", src,
                 "skyrim_tpu/ops/graph_kernels.py:112", GK.fused_fixed_degree_messages, args,
                 GK.reference_fixed_degree_messages, 2 * N * deg * L * L, 2 * N * (2 * deg * L + 2 * L) + 2 * L * L,
                 iters=20, warmup=5)
    # one launch at a time: the spread of single launches beside the mean of 20
    single = sorted(time_ms(torch, lambda: GK.fused_fixed_degree_messages(*args), 1, 0) for _ in range(20))
    parts["k13_single_launch_ms"] = {"min": single[0], "median": single[10], "max": single[-1]}
    log(f"K13 single launches at full width: {parts['k13_single_launch_ms']}")
    wide, bias_w, ad, b0, wb, ln = args[:6]
    ops = operands(b0, wb, ln)
    message_guard_rows(torch, lambda buf: lib.skt_fixed_degree_messages(
        wide.data_ptr(), bias_w.data_ptr(), ad.data_ptr(), *(t.data_ptr() for t in ops), buf.data_ptr(), N, L, deg,
        _EPS, stream),
        N, L, out, "K13")
    # the check's power at this shape: K13's output under three faults must
    # fail it -- slot 2's message dropped for every point within 10 degrees of
    # the equator (the kernel's output less the plain slot-2 message there),
    # slot 0's bias read for every slot, and each point's dst row (ad) taken
    # from the next point (the off-by-one a 21-point tile invites)
    ref = GK.reference_fixed_degree_messages(*args)
    lat = 90 - 180 * torch.arange(H, device=dev) / (H - 1)
    band = (lat.abs() < 10).nonzero().squeeze(1)
    h2 = (wide.view(H, W, deg * L)[band][..., 2 * L:].float() + bias_w.view(H, W, deg * L)[band][..., 2 * L:].float()
          + ad.view(H, W, L)[band].float())
    m2 = FM.reference_finish(h2.reshape(-1, L), b0, wb, ln, bf16).float().view(len(band), W, L)
    dropped = out.clone().view(H, W, L)
    dropped[band] = (dropped[band].float() - m2).to(bf16)
    del h2, m2, out
    bias0 = bias_w.view(N, deg, L)[:, :1].expand(N, deg, L).reshape(N, deg * L)
    ad_next = torch.roll(ad, -1, 0)
    for fault, make in ((f"K13: slot 2's message dropped for the {len(band)} latitude rows within 10 degrees "
                         "of the equator", lambda: dropped.view(N, L)),
                        ("K13: slot 0's bias read for every slot",
                         lambda: GK.fused_fixed_degree_messages(wide, bias0, *args[2:])),
                        ("K13: each point's dst row taken from the next point",
                         lambda: GK.fused_fixed_degree_messages(wide, bias_w, ad_next, *args[3:]))):
        bad = make()
        faults[fault] = {"max": over_limit(torch, bad, ref, False)}
        log(f"{fault}: max err/limit {faults[fault]['max']:.4g} under the check's rule (2 ulps of max|plain|)")
        check(faults[fault]["max"] > 1, f"K13's check passed a faulty output: {fault}")
        del bad
    del args, ref, dropped, bias0, ad_next, wide, bias_w, ad
    torch.cuda.empty_cache()

    # K14 on the grid->mesh block plan: the messages in one launch of
    # rows_ln_kernel<1>, then the segmented sum
    plan = G.build_block_plan(graphs["g2m_dst"], graphs["n_mesh"], target_rows=8192)
    B, M = plan["local"].shape
    SB, E = plan["SB"], plan["E"]
    local = torch.from_numpy(plan["local"]).to(dev)
    check(bool((local == SB).any()), "the grid->mesh block plan has no padding rows")
    check(int((local < SB).sum()) == E, "the block plan's real rows are not the grid->mesh edges")
    args = (randn(B, M, L, dtype=bf16), randn(B, M, L, scale=0.3, dtype=bf16), local, *finish_params(), SB)
    path = message_launches(torch, GK.fused_block_messages, args, 2, "rows_ln<1> messages + segsum")
    op_row(torch, rows, f"K14 fused_block_messages ({B}, {M}, {L}) SB {SB} {path}", src,
           "skyrim_tpu/ops/graph_kernels.py:223", GK.fused_block_messages, args, GK.reference_block_messages,
           # the work this data needs: the products and the source and bias
           # rows of the real edges, not of the padding rows; every output written
           2 * E * L * L, 2 * (2 * E * L + B * SB * L) + 4 * B * M + 2 * L * L, per_element=True, iters=20,
           warmup=5)
    src_rows, bias_rows, _, b0, wb, ln = (a.view(B * M, L) if i < 2 else a for i, a in enumerate(args[:6]))
    m = GK.block_messages(src_rows, bias_rows, b0, wb, ln)
    ops = operands(b0, wb, ln)
    message_guard_rows(torch, lambda buf: lib.skt_block_messages(
        src_rows.data_ptr(), bias_rows.data_ptr(), *(t.data_ptr() for t in ops), buf.data_ptr(), B * M, L, _EPS,
        stream),
                       B * M, L, m, "K14's messages")
    parts.update(k14_messages_ms=time_ms(torch, lambda: GK.block_messages(src_rows, bias_rows, b0, wb, ln), 20, 5),
                 k14_segment_sum_ms=time_ms(torch, lambda: FM.segment_sum(m, local, SB), 20, 5))
    log(f"K14 parts at full width: {parts['k14_messages_ms']}, {parts['k14_segment_sum_ms']} ms")
    del m
    # the check's power at this shape: with the first real row of every block
    # dropped from the aggregation, and with each row's bias taken from the
    # next row (the off-by-one an identity index invites), the kernel's output
    # must fail it
    dropped = local.clone()
    check(bool((dropped < SB).any(1).all()), "a block of the plan has no real row")
    dropped[torch.arange(B, device=dev), (dropped < SB).float().argmax(1)] = SB
    bias_next = torch.roll(bias_rows, -1, 0).view(B, M, L)
    ref = GK.reference_block_messages(*args)
    for fault, fargs in ((f"K14: one row dropped in each of {B} blocks", (*args[:2], dropped, *args[3:])),
                         ("K14: each row's bias taken from the next row", (args[0], bias_next, *args[2:]))):
        faults[fault] = {"per_element": over_limit(torch, GK.fused_block_messages(*fargs), ref, True)}
        log(f"{fault}: max err/limit {faults[fault]['per_element']:.4g} under the check's rule (|plain| per element)")
        check(faults[fault]["per_element"] > 1, f"K14's check passed a faulty output: {fault}")
    del args, ref, dropped, bias_next, local, src_rows, bias_rows
    torch.cuda.empty_cache()
    return rows, faults, parts


def sht_checks(torch, g) -> dict:
    """Phase 3, SFNO's transforms at fcnv2_sm's geometry (no kernel of the
    port: f32 PyTorch products).  With TF32 allowed for f32 matmuls outside
    them, the analysis of a (721, 1440, 256) field (block 0's) and the
    synthesis back onto that grid (block 11's) must stay within 1e-5 of
    max|ref| of the same products in float64 on the card; the analysis run
    with the transform's own precision guard taken out must fail that
    check.  Times of both, and of the pair on the 120x240 Gauss grid (the
    inner blocks'), by CUDA events."""
    from skyrim_tpu_torch.ops import sht as S

    dev = torch.device("cuda")
    x = torch.randn(721, 1440, 256, device=dev, generator=g).to(torch.bfloat16)
    outer, ref = S.SHT(721, 1440, 120, 121, device=dev), S.SHT(721, 1440, 120, 121, device=dev, dtype=torch.float64)
    inner = S.SHT(120, 240, 120, 121, grid="legendre-gauss", device=dev)

    def rel_err(out, exact):
        return float((out.double() - exact).abs().max() / exact.abs().max())

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 allowed outside the transforms
    guard = S.full_f32
    try:
        z = outer.analysis(x)
        y = outer.synthesis(z)
        S.full_f32 = contextlib.nullcontext  # the check's power: the analysis without its guard
        z_tf32 = outer.analysis(x)
    finally:
        S.full_f32 = guard
        torch.set_float32_matmul_precision(before)
    z64 = ref.analysis(x)
    out = {"analysis_rel_err": rel_err(z, z64), "synthesis_rel_err": rel_err(y, ref.synthesis(z)),
           "analysis_without_guard_rel_err": rel_err(z_tf32, z64)}
    del z64, z_tf32
    check(out["analysis_rel_err"] <= 1e-5 and out["synthesis_rel_err"] <= 1e-5, f"SFNO's transforms off f64: {out}")
    check(out["analysis_without_guard_rel_err"] > 1e-5, f"the SHT check passed a TF32 analysis: {out}")
    h = torch.randn(120, 240, 256, device=dev, generator=g).to(torch.bfloat16)
    out.update(analysis_721x1440_ms=time_ms(torch, lambda: outer.analysis(x), 5),
               synthesis_721x1440_ms=time_ms(torch, lambda: outer.synthesis(z), 5),
               pair_120x240_ms=time_ms(torch, lambda: inner.synthesis(inner.analysis(h)), 10))
    log(f"SHT at fcnv2_sm's geometry: {out}")
    del x, y, z, h
    torch.cuda.empty_cache()
    return out


def module_path(torch, net, g) -> dict:
    """The slice's own path: EarthAttention3D.forward of a full-width net's
    stage-1 and stage-2 modules (an unshifted and a shifted block each) against
    the plain composition, with K5's launches counted and no K1 launch."""
    from skyrim_tpu_torch.ops import flash_window_attention as FA
    from skyrim_tpu_torch.ops.windows import mask_tensor

    dev = torch.device("cuda")
    cfg = net.cfg
    window = tuple(cfg.window)
    by_shape, errs = {}, {}
    reset_counts()
    for s, valid_h in ((0, 181), (1, 91)):
        C = cfg.embed_dim * (1 if s == 0 else 2)
        dims = (8, -(-valid_h // window[1]) * window[1], 360 // (1 if s == 0 else 2))
        x = (torch.randn(*dims, C, device=dev, generator=g)).to(torch.bfloat16)
        before = FA.fused_window_attention_4d.launches
        for name in net.stages[s][:2]:
            blk = getattr(net, name)
            attn = blk.EarthAttention3D_0
            shift = tuple(w // 2 for w in window) if blk.shifted else (0, 0, 0)
            mask = mask_tensor(dims, window, shift, (8, valid_h, dims[2]), dev)
            out = attn(x, mask)
            torch.cuda.synchronize()
            qkv = x @ attn.qkv.kernel.to(x.dtype) + attn.qkv.bias.to(x.dtype)
            ref = FA.reference_window_attention_4d(qkv, attn.expanded_bias(), mask, window, attn.heads)
            ref = ref @ attn.proj.kernel.to(x.dtype) + attn.proj.bias.to(x.dtype)
            errs[f"{name}{' shifted' if blk.shifted else ''}"] = compare(torch, out, ref, f"EarthAttention3D.forward {name}")
            del out, qkv, ref
        by_shape[(*dims, C)] = FA.fused_window_attention_4d.launches - before
    counts, _ = read_counts()
    log(f"module path: EarthAttention3D.forward max_abs_err {errs}, launches {counts}")
    check(counts["K5"] == 4, f"the module path launched K5 {counts['K5']} times, expected 4")
    check(all(v == 0 for k, v in counts.items() if k != "K5"), f"the module path launched other kernels: {counts}")
    torch.cuda.empty_cache()
    return dict(by_shape=by_shape, max_abs_err=errs)


def counters():
    from skyrim_tpu_torch.ops import flash_window_attention as FA
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import graph_kernels as GK
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops import roll as RL
    from skyrim_tpu_torch.ops.fused_mlp import fused_finish, fused_mlp
    from skyrim_tpu_torch.ops.gemm import gemm, ln_gemm

    return {"K1": FB.fused_swin_block, "K2": RL.roll3d, "K3": RS.fused_downsample,
            "K4": RS.fused_upsample, "K5": FA.fused_window_attention_4d, "gemm": gemm, "ln_gemm": ln_gemm,
            "layernorm": FB.layernorm, "K6": fused_mlp,
            "K7": GK.fused_round_messages, "K8": GK.fused_m2g_tiled, "K9": GK.fused_g2m_tiled,
            "K10": FA.fused_window_attention, "K11": FA.flash_window_attention, "K12": fused_finish,
            "K13": GK.fused_fixed_degree_messages, "K14": GK.fused_block_messages}


BY_SHAPE = ("K1", "K2", "K6", "K7")  # kernels that run at several shapes on a path
FORECASTS = ("pangu", "graphcast", "fourcastnet_v2", "fengwu", "fuxi", "fourcastnet", "dlwp")  # the ported models
# phase 4's main paths, in order: every model at its published widths, and FuXi's V1 flavour
MAIN_PATHS = ("pangu", "graphcast", "fourcastnet_v2", "fengwu", "fuxi", "fuxi V1", "fourcastnet", "dlwp")
# phase 5's small configurations: the CPU tests' ones, FuXi's in both flavours and int8-served
SMALL_CONFIGS = ("pangu", "graphcast", "fourcastnet_v2", "fengwu", "fuxi", "fuxi V1", "fuxi int8", "fourcastnet",
                 "dlwp")


def forecast_launches(mp: dict, key: str, shape) -> tuple[str | None, int]:
    """The forecast of phase 4 that launched ``key`` (at ``shape`` where it
    is given for a kernel counted by shape, BY_SHAPE), and its launches
    there; K1 and K2 run on Pangu's, FengWu's and FuXi's, at their own
    shapes."""
    for name, run in mp.items():
        n = run["by_shape"][key].get(shape, 0) if key in BY_SHAPE and shape is not None else run["counts"][key]
        if n:
            return name, n
    return None, 0


def reset_counts() -> None:
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops.fused_mlp import ln_rows, mlp_finish

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    for k in BY_SHAPE:
        fns[k].launches_by_shape.clear()
    ln_rows.launches_by_shape.clear()
    mlp_finish.launches_by_shape.clear()
    FB.fused_swin_block.launches_by_path.clear()


# launches counted by shape apart: inside K6-K9, and K1's calls by path
ROW_KERNELS = ("ln_rows", "mlp_finish", "K1 path")


def read_counts() -> tuple[dict, dict]:
    """The kernels' launch counts, and by shape for BY_SHAPE; by_shape also
    holds the LayerNorm rows kernel's launches by (rows, C) under "ln_rows",
    K6's whole-row finish's by (rows, L, residual) under "mlp_finish" and
    K1's calls by ops.fused_block.block_path under "K1 path"."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops.fused_mlp import ln_rows, mlp_finish

    fns = counters()
    counts = {k: fn.launches for k, fn in fns.items()}
    by_shape = {k: {tuple(s): v for s, v in fns[k].launches_by_shape.items()} for k in BY_SHAPE}
    by_shape["ln_rows"] = dict(ln_rows.launches_by_shape)
    by_shape["mlp_finish"] = dict(mlp_finish.launches_by_shape)
    by_shape["K1 path"] = dict(FB.fused_swin_block.launches_by_path)
    return counts, by_shape


def expected_launches(model, n_steps: int) -> tuple[dict, dict]:
    """Launches per n_steps forwards of the main path: every kernel of the
    port is listed, so the other model's kernels must stay at 0."""
    counts = dict.fromkeys(counters(), 0)
    by_shape = {k: {} for k in (*BY_SHAPE, *ROW_KERNELS)}
    if model.name in ("fourcastnet_v2", "fourcastnet", "dlwp"):  # PyTorch compositions: no kernel of the port
        return counts, by_shape
    if model.name == "fuxi":
        # both flavours: the trunk's 24 shifted blocks each between two K2
        # rolls on the (96, 180) token grid; V1's 48 blocks at C 1536 take
        # K1's chain (4 products through ops.gemm and 2 LayerNorm rows
        # launches a block); Swin-V2's blocks are a PyTorch composition
        cfg = model.cfg
        Ht, Wt = cfg.tokens
        Hd, wh = (Ht + Ht % 2) // 2, cfg.window[0]
        shape = (1, -(-Hd // wh) * wh, Wt // 2, cfg.embed_dim)
        rolls, n_blocks = cfg.depth * n_steps, cfg.depth * n_steps
        counts.update(K2=rolls)
        by_shape["K2"] = {shape: rolls}
        if not cfg.attn_v2:
            counts.update(K1=n_blocks, gemm=4 * n_blocks, layernorm=2 * n_blocks)
            by_shape["K1"], by_shape["K1 path"] = {shape: n_blocks}, {"chain": n_blocks}
        return counts, by_shape
    if model.name == "fengwu":
        # the fuser's 16 blocks at C 1152 take K1's chain (block_path: C >
        # 512): LN1, qkv, attention, proj + residual, LN2, fc1 + GELU, fc2 +
        # residual, so 4 products through ops.gemm and 2 LayerNorm rows
        # launches a block, none through ln_gemm; 8 shifted blocks, each
        # between two K2 rolls
        cfg = model.cfg
        n_blocks = cfg.depth * n_steps
        Ht, Wt = cfg.tokens
        shape = (1, -(-Ht // cfg.window[0]) * cfg.window[0], Wt, cfg.fuser_dim)
        counts.update(K1=n_blocks, K2=2 * (cfg.depth // 2) * n_steps, gemm=4 * n_blocks, layernorm=2 * n_blocks)
        by_shape["K1"], by_shape["K2"] = {shape: n_blocks}, {shape: 2 * (cfg.depth // 2) * n_steps}
        by_shape["K1 path"] = {"chain": n_blocks}
        return counts, by_shape
    if model.name == "pangu":
        # the row GEMM through ops.gemm: K1's proj and fc2; K1's LN1 + qkv
        # and LN2 + fc1 each one ln_gemm launch (both widths take that
        # path), no LayerNorm rows launch; K3 and K4 one launch each of
        # their own kernel
        counts.update(K1=16 * n_steps, K2=16 * n_steps, K3=n_steps, K4=n_steps, gemm=16 * 2 * n_steps,
                      ln_gemm=16 * 2 * n_steps)
        # per forward: 4 blocks (and rolls) at stage 1/4, 12 at stage 2/3
        for k in ("K1", "K2"):
            by_shape[k] = {(8, 186, 360, 192): 4 * n_steps, (8, 96, 180, 384): 12 * n_steps}
        by_shape["K1 path"] = {"ln_gemm": 16 * n_steps}
        return counts, by_shape
    cfg, t = model.cfg, model.tables
    L, N, rounds = cfg.latent, cfg.lat * cfg.lon, cfg.processor_rounds
    counts.update(K6=(5 + rounds) * n_steps, K7=rounds * n_steps, K8=n_steps, K9=n_steps)
    by_shape["K6"] = {
        (N, model.n_grid_in, 0, L): n_steps,  # embed_grid, feature-major
        (N, L, 0, L): n_steps,  # grid_update
        (N, L, L, L): n_steps,  # m2g.MLP_0
        (N, L, 0, cfg.in_channels): n_steps,  # head
        (t["n_mesh"], L, L, L): (1 + rounds) * n_steps,  # g2m.MLP_0 and each round's MLP_1
    }
    B, M = t["mesh_src_blocks"].shape
    by_shape["K7"] = {(B, M, L, t["mesh_SB"]): rounds * n_steps}
    # K6's whole-row finish: every call with a LayerNorm (H == Cout == L),
    # so all but the head's
    by_shape["mlp_finish"] = {(N, L, False): n_steps, (N, L, True): 2 * n_steps,  # embed_grid; grid_update, m2g.MLP_0
                              (t["n_mesh"], L, True): (1 + rounds) * n_steps}
    # the LayerNorm rows kernel: after K7's products only; K6, K8 and K9
    # normalise inside one kernel
    by_shape["ln_rows"] = {(B * M, L): rounds * n_steps}
    return counts, by_shape


@contextlib.contextmanager
def weights_dir(path):
    """SKYRIM_WEIGHTS_DIR set to path inside the block, restored after."""
    before = os.environ.get("SKYRIM_WEIGHTS_DIR")
    os.environ["SKYRIM_WEIGHTS_DIR"] = str(path)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("SKYRIM_WEIGHTS_DIR")
        else:
            os.environ["SKYRIM_WEIGHTS_DIR"] = before


def fuxi_params(torch, label: str):
    """FuXi's GlobalModel arguments for phase 4: the published V2 cascade
    (3 stages) or the V1 flavour (1 stage), its seed-0 parameters drawn on
    the card (4.1 B draws on the host would take about a minute)."""
    from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

    cfg = FuXiConfig() if label == "fuxi" else FuXiConfig(attn_v2=False, n_stages=1)
    params = FuXiModel(cfg, device="cuda").init_params(torch.Generator(device="cuda").manual_seed(0))
    return dict(model_kwargs={"cfg": cfg}, params=params)


def main_path(torch, label: str, g) -> dict:
    """Phase 4: a full-width forecast through GlobalModel, with the launch
    counts of the forecast, then per-step times, a profile and a saved
    rollout; for FuXi's cascade also the stage switch and the int8 tiers."""
    import numpy as np

    from skyrim_tpu_torch.core import GlobalModel
    from skyrim_tpu_torch.io import SaveConfig, load_forecast

    model_name = label.split()[0]
    t_path = time.perf_counter()
    gc.collect()  # the earlier phases' tensors and the objects that held them, gone before the forecast is timed
    torch.cuda.empty_cache()
    reset_counts()
    with tempfile.TemporaryDirectory() as empty, weights_dir(empty):  # the seed-0 init, whatever HOME holds
        t0 = time.perf_counter()
        kwargs = fuxi_params(torch, label) if model_name == "fuxi" else {}
        gm = GlobalModel(model_name, ic_source="synthetic", seed=0, device="cuda", **kwargs)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        del kwargs
    setup_counts = {k: v for k, v in read_counts()[0].items() if v}
    log(f"{label}: set-up {setup_s:.1f} s (tables, parameters, cache), launches {setup_counts}")
    if model_name == "graphcast":  # the cache: embed_mesh, embed_mm and the two edge embeddings
        check(setup_counts == {"K6": 4}, f"graphcast cache build launched {setup_counts}, expected 4 K6")
    start = datetime.datetime(2024, 1, 1, 0)
    n_steps = 4
    shape = (len(gm.model.channels), *gm.model.grid.shape)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fc = gm.forecast(start, n_steps=n_steps)
    torch.cuda.synchronize()
    forecast_s = time.perf_counter() - t0
    counts, by_shape = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: forecast of {n_steps} steps in {forecast_s:.2f} s, launches {counts}, "
        f"by shape {by_shape}, peak {peak_gb:.2f} GB allocated")
    check_launches(gm.model, n_steps, counts, by_shape, f"{label} main path")
    check(fc.data.shape == (n_steps + 1, *shape), f"forecast shape {fc.data.shape}")
    check(bool(np.isfinite(fc.data).all()), "forecast has non-finite values")
    check(float(np.abs(fc.data[1:] - fc.data[:1]).max()) > 0, "forecast did not change the state")

    # per-step device time of the same advance the forecast ran
    model, params = gm.model, gm.params
    state, _ = gm._initial_state(start)
    step_ms = []
    for _ in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = model.advance(params, state)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    frames = model.frames_out
    log(f"{label}: per-call ms {['%.2f' % t for t in step_ms]}" + (f", per 6-h frame {['%.2f' % (t / frames) for t in step_ms]}" if frames > 1 else ""))
    profile = profile_step(torch, model, params, state, keep=None if model_name == "dlwp" else 8)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = SaveConfig(forecast_id="smoke", output_dir=tmp)
        last, paths = gm.rollout(start, n_steps=2, save=True, save_config=cfg)
        check(len(paths) == 2, f"rollout saved {len(paths)} files")
        for i, p in enumerate(paths):
            f = load_forecast(p)
            check(f.data.shape == (1, *shape), f"reloaded {p}: shape {f.data.shape}")
            check(bool(np.isfinite(f.data).all()), f"reloaded {p}: non-finite")
            # the same kernels on the same IC: the saved steps are the forecast's
            diff = float(np.abs(f.data[0] - fc.data[i + 1]).max())
            check(diff <= 1e-3 * float(np.abs(fc.data[i + 1]).max()), f"saved step {i + 1} differs from forecast by {diff}")
        np.testing.assert_array_equal(load_forecast(paths[-1]).data, last.data)
        log(f"{label}: rollout saved {[Path(p).name for p in paths]} and reloaded them")
    modules = module_path(torch, params["net6"], g) if model_name == "pangu" else None
    cascade = int8 = None
    if label == "fuxi":
        state, _ = gm._initial_state(start)
        cascade = fuxi_cascade(torch, model, params, state)
        int8 = fuxi_int8(torch, model, params, state)
    del gm, model, params, state, fc
    torch.cuda.empty_cache()
    return dict(counts=counts, by_shape=by_shape, n_steps=n_steps, setup_launches=setup_counts, setup_s=setup_s,
                forecast_s=forecast_s, step_ms=step_ms, frames_out=frames, peak_gb=peak_gb, profile=profile,
                modules=modules, cascade=cascade, int8=int8, wall_s=time.perf_counter() - t_path)


def check_launches(model, n_steps: int, counts: dict, by_shape: dict, what: str) -> None:
    expect, expect_shape = expected_launches(model, n_steps)
    for k, v in expect.items():
        check(counts[k] == v, f"{what} launched {k} {counts[k]} times, expected {v}")
    for k in (*BY_SHAPE, *ROW_KERNELS):
        check(by_shape[k] == expect_shape[k], f"{what} launched {k} by shape {by_shape[k]}, expected {expect_shape[k]}")


def fuxi_cascade(torch, model, params, state) -> dict:
    """FuXi's stage switch at full width: from the IC's state at step 19, two
    advances take stage 0 (19 // 20), then stage 1 (20 // 20); each output
    equals _forward of that stage on the same history bit for bit, and the
    second differs from stage 0's."""
    stages = params["stages"]
    state = state.replace(step=model.cfg.stage_steps - 1)
    s1, y1 = model.advance(params, state)
    s2, y2 = model.advance(params, s1)
    check(s2.step == model.cfg.stage_steps + 1, f"cascade steps {s1.step}, {s2.step}")
    check(bool(torch.equal(y1[0], model._forward(stages[0], params, state.x))), "step 19 did not take stage 0")
    check(bool(torch.equal(y2[0], model._forward(stages[1], params, s1.x))), "step 20 did not take stage 1")
    other = float((y2[0] - model._forward(stages[0], params, s1.x)).abs().max())
    check(other > 0, "stages 0 and 1 gave the same step 20")
    log(f"fuxi cascade: step 19 took stage 0, step 20 stage 1 (bit for bit), stage 0 at step 20 differs by "
        f"max {other:.4g}")
    return dict(stage1_vs_stage0_max_abs=other)


def fuxi_int8(torch, model, params, state) -> dict:
    """FuXi's two int8 tiers on stage 0 at full width (min_size 65536): the
    resident bytes (quantize.tree_nbytes), the first step's mean |diff| /
    mean |bf16| against the bf16 stage (below 0.15, tests/test_quantize.py:102),
    its launches (48 K2, nothing else), step ms (CUDA events, 3 steps each,
    bf16 in the same run) and peak; then torch._int_mm beside torch.matmul
    and quantize.int8_dot at the trunk's four product shapes, timed only."""
    from skyrim_tpu_torch.quantize import QuantizedTensor, int8_dot, quantize_array, tree_nbytes
    from skyrim_tpu_torch.models.fuxi import stage_tree

    one = model.trim_stages(params, 1)

    def steps(p):
        model.advance(p, state)  # warm
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            model.advance(p, state)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return ms

    _, y0 = model.advance(one, state)
    out = {"bf16": dict(step_ms=steps(one), nbytes=tree_nbytes(stage_tree(one["stages"][0])))}
    for tier, serve in (("at rest", False), ("serving", True)):
        t0 = time.perf_counter()
        qp = model.quantize_params(one, serve_int8=serve)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _, y = model.advance(qp, state)
        torch.cuda.synchronize()
        counts, by_shape = read_counts()
        check_launches(model, 1, counts, by_shape, f"fuxi int8 {tier}")
        rel = float((y - y0).abs().mean() / y0.abs().mean())
        check(bool(torch.isfinite(y).all()) and rel < 0.15, f"fuxi int8 {tier}: mean |diff| / mean |bf16| = {rel:.4g}")
        out[tier] = dict(step_ms=steps(qp), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         nbytes=tree_nbytes(qp["stages"][0]), rel_diff=rel, quantize_s=quantize_s)
        log(f"fuxi int8 {tier}: {out[tier]}")
        del qp, y
    log(f"fuxi bf16 stage: {out['bf16']}")

    # the trunk's products: 240 windows x 72 tokens, timed only; the int8
    # weight column-major as split_dense_int8 stores it, and row-major
    g = torch.Generator(device="cuda").manual_seed(1)
    M, C = 240 * 72, model.cfg.embed_dim
    prod = {}
    for name, (K, N) in (("qkv", (C, 3 * C)), ("proj", (C, C)), ("Dense_0", (C, 4 * C)), ("Dense_1", (4 * C, C))):
        x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
        w = (torch.randn(K, N, device="cuda", generator=g) * K**-0.5).to(torch.bfloat16)
        qw = quantize_array(w)
        qcol = qw.q.t().contiguous().t()
        xq = torch.randint(-127, 128, (M, K), device="cuda", generator=g, dtype=torch.int8)
        qt = QuantizedTensor(qcol, qw.scale, torch.bfloat16)
        prod[name] = dict(shape=[M, K, N], int_mm_ms=time_ms(torch, lambda: torch._int_mm(xq, qcol), 10),
                          int_mm_row_major_ms=time_ms(torch, lambda: torch._int_mm(xq, qw.q), 10),
                          matmul_ms=time_ms(torch, lambda: x @ w, 10), int8_dot_ms=time_ms(torch, lambda: int8_dot(x, qt), 10))
        log(f"fuxi trunk product {name} {prod[name]}")
        del x, w, qw, qcol, xq, qt
    out["products"] = prod
    torch.cuda.empty_cache()
    return out


def facade_path(torch) -> dict:
    """Phase 4, the facade: Skyrim("pangu", ic_source="file:<IC>").predict
    at full width, the IC the synthetic source's frame written as NetCDF
    by the port, the parameters a seed-1 init saved as the port's
    checkpoint and found by weights.load_params (no params given; the
    facade's own seed is 0, so a fall-back to the init would differ from
    the checkpoint, which the loaded tree is held equal to leaf for leaf).
    13 h must floor to 12 h (2 steps, 2 files, 2 forwards' launches), the
    last file must read back as the returned prediction, and the prediction
    must equal GlobalModel.rollout's final frame from the same IC and
    parameters bit for bit (every kernel of Pangu's path gives the same bits
    on every run, phase 3).  The wall time split on the host clock into IC
    read (file to device state), NetCDF writes and the rest (the steps'
    launches and the device-to-host copies), beside the steps' device time
    by CUDA events around each model.advance."""
    import numpy as np

    from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
    from skyrim_tpu_torch.core import model as core_model
    from skyrim_tpu_torch.data import get_data_source
    from skyrim_tpu_torch.io import SaveConfig, write_netcdf
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.params import flatten, to_tree
    from skyrim_tpu_torch.weights import save_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    start = datetime.datetime(2024, 1, 1, 0)
    spent = {"ic_read_s": 0.0, "netcdf_write_s": 0.0}
    events = []

    def timed(fn, key, sync=False):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out

        return wrapper

    with tempfile.TemporaryDirectory() as tmp, weights_dir(Path(tmp) / "weights"):
        model = MODELS["pangu"](device="cuda")
        ic_field = get_data_source(model.in_channel_names, "synthetic", grid=model.grid).fetch(start)
        ic = Path(tmp) / "ic.nc"
        write_netcdf(ic_field, ic)
        tree = to_tree(model.init_params(torch.Generator().manual_seed(1)))
        save_checkpoint("pangu", tree)
        saved = flatten(tree)
        del model
        check(Skyrim.list_available_models() == list(FORECASTS), f"the facade lists {Skyrim.list_available_models()}")
        sky = Skyrim("pangu", ic_source=f"file:{ic}")
        loaded = flatten(to_tree(sky.model.params))
        check(loaded.keys() == saved.keys() and all(np.array_equal(loaded[k], saved[k]) for k in saved),
              "the facade's parameters are not the checkpoint's")
        del tree, saved, loaded
        init_state, save = GlobalModel._initial_state, core_model.save_forecast
        GlobalModel._initial_state = timed(init_state, "ic_read_s", sync=True)
        core_model.save_forecast = timed(save, "netcdf_write_s")
        try:
            with timed_advances(torch, sky.model.model, events):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred, paths = sky.predict(start.strftime("%Y%m%d"), "0000", lead_time=13, save=True,
                                          save_config=SaveConfig(forecast_id="smoke",
                                                                 output_dir=str(Path(tmp) / "out")))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                counts, by_shape = read_counts()
        finally:
            GlobalModel._initial_state, core_model.save_forecast = init_state, save
        expect, expect_shape = expected_launches(sky.model.model, 2)
        for k, v in expect.items():
            check(counts[k] == v, f"the facade launched {k} {counts[k]} times, expected {v}")
        check(by_shape["K1"] == expect_shape["K1"], f"the facade launched K1 by shape {by_shape['K1']}")
        check(isinstance(pred, GlobalPrediction) and len(paths) == 2 and len(events) == 2,
              f"predict(lead_time=13) saved {len(paths)} files in {len(events)} steps")
        # the first file's name embeds the whole ic_source, as in the JAX package
        check(paths[0].endswith(f"pangu__file:{ic}__20240101_00:00__20240101_06:00.nc")
              and Path(paths[1]).name == "pangu__file__20240101_06:00__20240101_12:00.nc",
              f"the facade's files {paths}")
        data = pred.prediction.data
        check(data.shape == (1, 69, 721, 1440) and bool(np.isfinite(data).all()), f"prediction {data.shape}")
        np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, data)
        last, _ = GlobalModel("pangu", ic_source=f"file:{ic}", params=sky.model.params).rollout(start, n_steps=2,
                                                                                               save=False)
        diff = float(np.abs(last.data.astype(np.float64) - data).max())
        check(diff == 0.0, f"the facade's prediction differs from GlobalModel.rollout's by {diff}")
        del sky, pred, last
    torch.cuda.empty_cache()
    steps_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    rest_s = wall_s - spent["ic_read_s"] - spent["netcdf_write_s"]
    log(f"facade: predict(lead_time=13) -> 2 steps, {[Path(p).name for p in paths]}, equal to GlobalModel.rollout, "
        f"parameters the checkpoint's; wall {wall_s:.3f} s = IC read {spent['ic_read_s']:.3f} + NetCDF writes "
        f"{spent['netcdf_write_s']:.3f} + other host {rest_s:.3f} s (host clock); the steps on the device "
        f"{['%.2f' % t for t in steps_ms]} ms (CUDA events)")
    return dict(wall_s=wall_s, rest_s=rest_s, steps_device_ms=steps_ms, **spent)


@contextlib.contextmanager
def timed_advances(torch, owner, events: list):
    """Inside the block, CUDA events around each ``advance`` of ``owner`` (a
    model, or a model class for the models a callee builds) go into
    ``events``.  Restored after: a model's wrapper is deleted, which also
    breaks the reference cycle it makes with the model."""
    own, advance = vars(owner).get("advance"), owner.advance

    def timed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = advance(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    owner.advance = timed
    try:
        yield
    finally:
        if own is None:
            del owner.advance
        else:
            owner.advance = own


def ensemble_paths(torch) -> tuple[dict, dict]:
    """Phase 4, the ensembles at full width from one NetCDF IC the port
    writes (the synthetic source's union of Pangu's and DLWP's channels, 70,
    and DLWP's two history frames), Pangu's parameters a seed-1 init drawn
    on the card and saved as the port's checkpoint, DLWP's the seed-0 init.

    Skyrim("pangu", "dlwp", ic_source="file:<IC>").predict(lead_time=12,
    save=True): two Pangu steps and one DLWP call, 2 + 2 member files and
    the mean's; each member's step ms (CUDA events) and peak; after each
    member's release torch.cuda.memory_allocated() back within 64 MB of its
    value before the member; the mean over the 6 shared channels equal bit
    for bit to the numpy mean of the two members' own GlobalModel.rollout
    finals; Pangu's K1-K4 launches those of 2 steps, every other count 0; the
    wall time split into IC read, NetCDF writes and other host time.

    Then ic_ensemble_forecast("pangu", n_members=4, n_steps=2) from the same
    IC on the checkpoint's parameters, loaded once: the control member equal
    bit for bit to GlobalModel.forecast from that IC, members 1-3 different,
    8 steps' launches; ms a member-step (CUDA events around each advance)
    and the wall time a member-step (host clock, the perturbations and the
    copies to the host included)."""
    import numpy as np

    from skyrim_tpu_torch.core import GlobalEnsemble, GlobalModel, GlobalPrediction, Skyrim
    from skyrim_tpu_torch.core import ensemble as core_ensemble
    from skyrim_tpu_torch.core import model as core_model
    from skyrim_tpu_torch.core.ic_ensemble import ic_ensemble_forecast
    from skyrim_tpu_torch.data import get_data_source
    from skyrim_tpu_torch.io import SaveConfig, write_netcdf
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.weights import load_params, save_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    start = datetime.datetime(2024, 1, 1, 0)
    names = ("pangu", "dlwp")
    spent = {"ic_read_s": 0.0, "netcdf_write_s": 0.0}

    def timed(fn, key, sync=False):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out

        return wrapper

    with tempfile.TemporaryDirectory() as tmp, weights_dir(Path(tmp) / "weights"):
        channels = list(dict.fromkeys(c for n in names for c in MODELS[n].channels))
        pangu = MODELS["pangu"](device="cuda")
        ic = Path(tmp) / "ic.nc"
        write_netcdf(get_data_source(channels, "synthetic", grid=pangu.grid).fetch(start, 2), ic)
        save_checkpoint("pangu", pangu.init_params(torch.Generator(device="cuda").manual_seed(1)))
        del pangu
        gc.collect()
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t_phase

        members = []
        run_member = GlobalEnsemble._run_member

        def measured(self, name, fn):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            events = []

            def run(m):
                with timed_advances(torch, m.model, events):
                    return fn(m)

            out = run_member(self, name, run)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            members.append(dict(name=name, steps_ms=[e0.elapsed_time(e1) for e0, e1 in events],
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                allocated_before_mb=before / 2**20, allocated_after_mb=after / 2**20))
            log(f"ensemble member {name}: {members[-1]}")
            check(abs(after - before) <= 64 * 2**20,
                  f"ensemble member {name}: {after / 2**20:.1f} MB allocated after its release, "
                  f"{before / 2**20:.1f} MB before it")
            return out

        init_state, save, ens_save = GlobalModel._initial_state, core_model.save_forecast, core_ensemble.save_forecast
        GlobalEnsemble._run_member = measured
        GlobalModel._initial_state = timed(init_state, "ic_read_s", sync=True)
        core_model.save_forecast = timed(save, "netcdf_write_s")
        core_ensemble.save_forecast = timed(ens_save, "netcdf_write_s")
        try:
            sky = Skyrim(*names, ic_source=f"file:{ic}")
            check(isinstance(sky.model, GlobalEnsemble), f"Skyrim{names} built {type(sky.model).__name__}")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred, paths = sky.predict(start.strftime("%Y%m%d"), "0000", lead_time=12, save=True,
                                      save_config=SaveConfig(forecast_id="ens", output_dir=str(Path(tmp) / "out")))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts, by_shape = read_counts()
        finally:
            GlobalEnsemble._run_member = run_member
            GlobalModel._initial_state, core_model.save_forecast = init_state, save
            core_ensemble.save_forecast = ens_save
        expect, _ = expected_launches(MODELS["pangu"](device="cuda"), 2)
        for k, v in expect.items():
            check(counts[k] == v, f"the ensemble launched {k} {counts[k]} times, expected {v} (Pangu's 2 steps)")
        check([m["name"] for m in members] == list(names) and [len(m["steps_ms"]) for m in members] == [2, 1],
              f"the ensemble ran {[(m['name'], len(m['steps_ms'])) for m in members]}")
        rel = [str(Path(p).relative_to(Path(tmp) / "out")) for p in paths]
        check(len(paths) == 5 and [r.split("/")[1] for r in rel] == ["pangu", "pangu", "dlwp", "dlwp", "mean"],
              f"the ensemble saved {rel}")
        data = pred.prediction.data
        common = list(pred.prediction.coords["channel"])
        check(len(common) == 6 and data.shape == (1, 6, 721, 1440) and bool(np.isfinite(data).all()),
              f"the ensemble mean has channels {common}, shape {data.shape}")
        np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, data)
        finals = [GlobalModel(n, ic_source=f"file:{ic}").rollout(start, n_steps=2, save=False)[0] for n in names]
        expect_mean = np.stack([f.sel(channel=common).data for f in finals]).mean(axis=0)
        diff = float(np.abs(expect_mean.astype(np.float64) - data).max())
        check(diff == 0.0, f"the ensemble mean differs from the members' own rollouts' mean by {diff}")
        rest_s = wall_s - spent["ic_read_s"] - spent["netcdf_write_s"]
        log(f"ensemble: predict(lead_time=12) -> {rel}, mean over {common} equal to the members' own rollouts; "
            f"wall {wall_s:.3f} s = IC read {spent['ic_read_s']:.3f} + NetCDF writes {spent['netcdf_write_s']:.3f} + "
            f"other host {rest_s:.3f} s (host clock)")
        ensemble = dict(members=members, wall_s=wall_s, rest_s=rest_s, common_channels=common, **spent,
                        setup_s=setup_s)
        del sky, pred, finals
        gc.collect()
        torch.cuda.empty_cache()
        ensemble["seconds"] = time.perf_counter() - t_phase

        # the IC ensemble: 4 members in turn against one resident parameter set
        t_ic = time.perf_counter()
        model = MODELS["pangu"](device="cuda")
        params = load_params(model)
        n_members, n_steps = 4, 2
        events = []
        with timed_advances(torch, MODELS["pangu"], events):  # the member model ic_ensemble_forecast builds
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ic_ensemble_forecast("pangu", start, n_steps=n_steps, n_members=n_members,
                                       ic_source=f"file:{ic}", params=params)
            torch.cuda.synchronize()
            ens_wall_s = time.perf_counter() - t0
            counts, _ = read_counts()
        expect, _ = expected_launches(model, n_members * n_steps)
        for k, v in expect.items():
            check(counts[k] == v, f"the IC ensemble launched {k} {counts[k]} times, expected {v}")
        check(out.dims == ("number", "time", "channel", "lat", "lon") and out.data.shape == (4, 2, 69, 721, 1440),
              f"the IC ensemble gave {out.dims} {out.data.shape}")
        control = GlobalModel("pangu", ic_source=f"file:{ic}", params=params).forecast(start, n_steps=n_steps)
        check(bool(np.array_equal(out.data[0], control.data[1:])), "the IC ensemble's control differs from "
              "GlobalModel.forecast from the same IC")
        spread = [float(np.abs(out.data[m] - out.data[0]).max()) for m in range(1, n_members)]
        check(all(d > 0 for d in spread), f"IC ensemble members equal to the control: {spread}")
        member_step_ms = [e0.elapsed_time(e1) for e0, e1 in events]
        ic_ensemble = dict(member_step_ms=member_step_ms, wall_s=ens_wall_s,
                           wall_ms_per_member_step=1e3 * ens_wall_s / (n_members * n_steps),
                           max_abs_from_control=spread)
        log(f"IC ensemble: 4 members x 2 steps, control equal to GlobalModel.forecast bit for bit, members 1-3 "
            f"max |diff| from it {spread}; member-step ms {['%.2f' % t for t in member_step_ms]} (CUDA events), "
            f"wall {ens_wall_s:.3f} s = {ic_ensemble['wall_ms_per_member_step']:.1f} ms a member-step (host clock)")
        del model, params, out, control
        gc.collect()
        torch.cuda.empty_cache()
        ic_ensemble["seconds"] = time.perf_counter() - t_ic
    return ensemble, ic_ensemble


def gfs_messages(start) -> tuple[dict, dict, dict]:
    """Pangu's 69 input channels as a GFS cycle: one simple-packed GRIB2
    message per channel on the 721x1440 grid (encoded in parallel), the
    matching NOAA .idx text, and a fake transport over them -- a dict keyed
    by URL that honours offset/length, as tests/test_torch_fetchers.py
    serves them.  The fields are the synthetic source's, HGT in metres
    (geopotential / 9.81, as NOAA publishes it).  Returns (files, the
    encoded fields by channel in float64, each message's quantum 2^E)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from skyrim_tpu_torch.channels import PANGU
    from skyrim_tpu_torch.data import get_data_source, grib
    from skyrim_tpu_torch.data.gfs import BUCKET_URL, gfs_key
    from skyrim_tpu_torch.data.vocab import GFS_VOCAB

    ic = get_data_source(PANGU, "synthetic").fetch(start).data[0]
    fields = {ch: ic[i].astype(np.float64) / GFS_VOCAB[ch].scale for i, ch in enumerate(PANGU)}
    with ThreadPoolExecutor(8) as pool:
        msgs = list(pool.map(grib.encode_simple, fields.values()))
    parts, lines, offset, quantum = [], [], 0, {}
    for i, (ch, msg) in enumerate(zip(PANGU, msgs)):
        e = GFS_VOCAB[ch]
        lines.append(f"{i + 1}:{offset}:d={start:%Y%m%d%H}:{e.provider_id}:{e.levtype}:anl:")
        parts.append(msg)
        offset += len(msg)
        f = fields[ch]
        quantum[ch] = 2.0 ** int(np.ceil(np.log2((f.max() - f.min()) / (2**16 - 1))))
    url = f"{BUCKET_URL}/{gfs_key(start, 0)}"
    return {url: b"".join(parts), url + ".idx": "\n".join(lines).encode()}, fields, quantum


class FakeTransport:
    """Serves ``files`` by URL, honouring byte ranges; counts ranged reads."""

    def __init__(self, files: dict):
        self.files, self.ranged = files, 0

    def __call__(self, url, offset=None, length=None):
        data = self.files[url]
        if offset is None:
            return data
        self.ranged += 1
        return data[offset:offset + length]


@contextlib.contextmanager
def ic_cache(path):
    """The NWP fetchers' byte-range cache (SKYRIM_CACHE, read by
    io.save.LOCAL_CACHE at import) in ``path`` inside the block."""
    from skyrim_tpu_torch.data import nwp_base

    before = os.environ.get("SKYRIM_CACHE"), nwp_base.LOCAL_CACHE
    os.environ["SKYRIM_CACHE"] = nwp_base.LOCAL_CACHE = str(path)
    try:
        yield
    finally:
        if before[0] is None:
            os.environ.pop("SKYRIM_CACHE")
        else:
            os.environ["SKYRIM_CACHE"] = before[0]
        nwp_base.LOCAL_CACHE = before[1]


def store_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def data_io_path(torch) -> dict:
    """Phase 4, the data and IO layers: Pangu at full width from a
    GFS-format IC, then streamed to Zarr.

    The 69 channels are encoded as GFS GRIB2 messages with an .idx and
    served by a fake transport put in place of the GFS source's
    (Skyrim(...).model.data_source.client.transport), the byte-range cache
    in a temporary SKYRIM_CACHE.  The native GRIB decoder must have built
    (g++); the fetched IC must be finite and within each message's
    simple-packing quantum (2^E / 2, times 9.81 for HGT -> z) of the encoded
    field; a second fetch must come from the cache; the 69 messages decoded
    by the native path and by numpy must be equal bit for bit (both
    timed).  Skyrim("pangu", ic_source="gfs").predict(lead_time=12,
    save=True) on a seed-2 checkpoint: 2 steps, 2 files, 2 forwards'
    launches, the first file equal bit for bit to GlobalModel's rollout from
    a file: IC holding the fetched field.  stream_save_forecast of the same
    model and IC, 4 steps, into a local Zarr store, in float32 (equal bit
    for bit to stream_rollout's frames; its steps timed by CUDA events) and
    in float16 with three channels (equal bit for bit to those frames cast
    on the card); beside it, the NetCDF writes of the same 4 frames, and
    each store's bytes."""
    import numpy as np

    from skyrim_tpu_torch.core import GlobalModel, Skyrim
    from skyrim_tpu_torch.core import model as core_model
    from skyrim_tpu_torch.data import grib, gribcore
    from skyrim_tpu_torch.field import Field
    from skyrim_tpu_torch.io import SaveConfig, load_forecast, read_zarr, save_forecast, stream_save_forecast
    from skyrim_tpu_torch.io import write_netcdf
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.params import to_tree
    from skyrim_tpu_torch.rollout import initial_condition_from_field, stream_rollout
    from skyrim_tpu_torch.weights import save_checkpoint

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(gribcore.available(), "the native GRIB decoder (skyrim_tpu_torch/native/gribcore.cc) did not build")
    start = datetime.datetime(2024, 1, 1, 0)
    t0 = time.perf_counter()
    files, fields, quantum = gfs_messages(start)
    encode_s = time.perf_counter() - t0
    url = next(u for u in files if not u.endswith(".idx"))
    blob = files[url]

    # the 69 messages decoded by the native path and by numpy, bit for bit
    from skyrim_tpu_torch.data.idx import parse_idx

    entries = sorted(parse_idx(files[url + ".idx"].decode()).values(), key=lambda e: e.offset)
    msgs = [blob[e.offset:e.offset + e.length] if e.length else blob[e.offset:] for e in entries]
    grib._install_native()
    t0 = time.perf_counter()
    native = [grib.decode_message(m).values for m in msgs]
    decode_native_s = time.perf_counter() - t0
    hooks = grib._unpack_bits_impl, grib._decode_simple_impl
    grib._unpack_bits_impl, grib._decode_simple_impl = grib._unpack_bits_numpy, None
    try:
        t0 = time.perf_counter()
        pure = [grib.decode_message(m).values for m in msgs]
        decode_numpy_s = time.perf_counter() - t0
    finally:
        grib._unpack_bits_impl, grib._decode_simple_impl = hooks
    check(all(np.array_equal(a, b) for a, b in zip(native, pure)), "native and numpy GRIB decodes differ")
    del native, pure, msgs

    out = {"encode_s": encode_s, "decode_native_s": decode_native_s, "decode_numpy_s": decode_numpy_s,
           "messages": len(entries), "grib_bytes": len(blob)}
    with tempfile.TemporaryDirectory() as tmp, weights_dir(Path(tmp) / "weights"), ic_cache(Path(tmp) / "cache"):
        model = MODELS["pangu"](device="cuda")
        save_checkpoint("pangu", to_tree(model.init_params(torch.Generator().manual_seed(2))))
        del model
        sky = Skyrim("pangu", ic_source="gfs")
        check(sky.model.data_source.name == "gfs", f"Skyrim's default IC source is {sky.model.data_source.name}")
        transport = sky.model.data_source.client.transport = FakeTransport(files)
        model, params = sky.model.model, sky.model.params

        # the IC: fetched and decoded on the host (8 threads), then from the cache
        t0 = time.perf_counter()
        ic_field = sky.model.data_source.fetch(start)
        out["ic_fetch_s"] = time.perf_counter() - t0
        ic = ic_field.data
        check(ic.shape == (1, 69, 721, 1440) and bool(np.isfinite(ic).all()), f"the GFS IC {ic.shape} is not finite")
        worst = 0.0
        for i, ch in enumerate(ic_field.coords["channel"]):
            scale = sky.model.data_source.client.vocabulary[ch].scale
            want = fields[ch] * scale
            err = float(np.abs(ic[0, i].astype(np.float64) - want).max())
            bound = scale * quantum[ch] / 2 + 4 * 2.0**-24 * float(np.abs(want).max())
            check(err <= bound, f"the GFS IC's {ch} is {err} off its encoded field (bound {bound})")
            worst = max(worst, err / bound)
        ranged = transport.ranged
        t0 = time.perf_counter()
        again = sky.model.data_source.fetch(start)
        out["ic_fetch_cached_s"] = time.perf_counter() - t0
        check(transport.ranged == ranged == 69 and np.array_equal(again.data, ic),
              f"the second fetch made {transport.ranged - ranged} ranged reads")
        out["ic_err_over_bound"] = worst
        del again

        # the facade: 12 h = 2 steps, 2 files, IC read through the cache
        events = []
        save_t = {"s": 0.0}
        save = core_model.save_forecast

        def timed_save(*a, **kw):
            t = time.perf_counter()
            path = save(*a, **kw)
            save_t["s"] += time.perf_counter() - t
            return path

        core_model.save_forecast = timed_save
        try:
            with timed_advances(torch, model, events):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred, paths = sky.predict(start.strftime("%Y%m%d"), "0000", lead_time=12, save=True,
                                          save_config=SaveConfig(forecast_id="gfs", output_dir=str(Path(tmp) / "out")))
                torch.cuda.synchronize()
                out["predict_wall_s"] = time.perf_counter() - t0
                counts, by_shape = read_counts()
        finally:
            core_model.save_forecast = save
        out["predict_netcdf_write_s"] = save_t["s"]
        out["predict_steps_device_ms"] = [e0.elapsed_time(e1) for e0, e1 in events]
        expect, expect_shape = expected_launches(model, 2)
        for k, v in expect.items():
            check(counts[k] == v, f"the GFS forecast launched {k} {counts[k]} times, expected {v}")
        check(by_shape["K1"] == expect_shape["K1"], f"the GFS forecast launched K1 by shape {by_shape['K1']}")
        check(len(paths) == 2 and Path(paths[0]).name == "pangu__gfs__20240101_00:00__20240101_06:00.nc",
              f"the GFS forecast's files {paths}")
        ic_nc = Path(tmp) / "ic.nc"
        write_netcdf(ic_field, ic_nc)
        _, file_paths = GlobalModel("pangu", ic_source=f"file:{ic_nc}", params=params).rollout(
            start, n_steps=2, save=True, save_config=SaveConfig(forecast_id="file", output_dir=str(Path(tmp) / "out")))
        for a, b in zip(paths, file_paths):
            diff = float(np.abs(load_forecast(a).data.astype(np.float64) - load_forecast(b).data).max())
            check(diff == 0.0, f"the GFS forecast's {Path(a).name} differs from the file: IC's by {diff}")
        del pred

        # the stream: 4 steps to Zarr, f32 then f16 with three channels
        x0 = initial_condition_from_field(model, ic_field)
        ref = np.stack(list(stream_rollout(model, params, model.init_state(params, x0, start_time=start), 4)))
        check(ref.shape == (4, 69, 721, 1440) and bool(np.isfinite(ref).all()), f"stream_rollout {ref.shape}")
        events = []
        with timed_advances(torch, model, events):
            t0 = time.perf_counter()
            target = stream_save_forecast(model, params, x0, start, 4, ic_source="gfs",
                                          config=SaveConfig(forecast_id="s32", output_dir=str(Path(tmp) / "zarr")))
            out["stream_f32_wall_s"] = time.perf_counter() - t0
        out["stream_f32_steps_device_ms"] = [e0.elapsed_time(e1) for e0, e1 in events]
        back = read_zarr(target)
        check(back.data.dtype == np.float32 and np.array_equal(back.data, ref),
              "the float32 Zarr frames are not stream_rollout's")
        check(list(back.coords["channel"]) == list(model.channels) and back.sizes["time"] == 4,
              f"the float32 store holds {back.sizes}")
        out["zarr_bytes_f32"] = store_bytes(target)
        del back
        keep = ("z500", "t850", "u10m")
        idx = [list(model.channels).index(c) for c in keep]
        t0 = time.perf_counter()
        target16 = stream_save_forecast(model, params, x0, start, 4, ic_source="gfs", save_dtype="float16",
                                        config=SaveConfig(forecast_id="s16", output_dir=str(Path(tmp) / "zarr"),
                                                          filter_vars=keep))
        out["stream_f16_wall_s"] = time.perf_counter() - t0
        back = read_zarr(target16)
        want = torch.from_numpy(ref[:, idx]).cuda().half().cpu().numpy()
        check(back.data.dtype == np.float16 and np.array_equal(back.data, want)
              and list(back.coords["channel"]) == list(keep), "the float16 Zarr frames are not the cast frames")
        out["zarr_bytes_f16"] = store_bytes(target16)

        # the facade's path for the same 4 frames: one NetCDF file a step
        cfg = SaveConfig(forecast_id="nc", output_dir=str(Path(tmp) / "nc"))
        t0 = time.perf_counter()
        for k in range(4):
            t = start + (k + 1) * model.time_step
            f = Field.from_canonical(ref[k][None], [t], model.channels, model.grid.lat, model.grid.lon,
                                     attrs={"model": "pangu"})
            save_forecast(f, "pangu", t - model.time_step, t, "gfs", cfg)
        out["netcdf_4_steps_s"] = time.perf_counter() - t0
        out["netcdf_bytes"] = store_bytes(Path(tmp) / "nc")
        del sky, ref, back, model, params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"data_io: GFS IC of 69 messages ({len(blob)} B) fetched and decoded in {out['ic_fetch_s']:.3f} s "
        f"(cached {out['ic_fetch_cached_s']:.3f} s), decode native {decode_native_s:.3f} s vs numpy "
        f"{decode_numpy_s:.3f} s, equal; predict(lead_time=12) {out['predict_wall_s']:.3f} s, files equal to "
        f"the file: IC's; stream_save_forecast 4 steps f32 {out['stream_f32_wall_s']:.3f} s "
        f"({out['zarr_bytes_f32']} B; steps {['%.2f' % t for t in out['stream_f32_steps_device_ms']]} ms), "
        f"f16 x3 channels {out['stream_f16_wall_s']:.3f} s ({out['zarr_bytes_f16']} B); NetCDF writes of the "
        f"4 steps {out['netcdf_4_steps_s']:.3f} s ({out['netcdf_bytes']} B); phase {out['seconds']:.1f} s")
    return out


def profile_step(torch, model, params, state, keep: int | None = 8) -> dict:
    """``profile_call`` of one forecast step."""
    return profile_call(torch, lambda: model.advance(params, state), keep)


def profile_call(torch, fn, keep: int | None = 8) -> dict:
    """Device time by kernel over one call of ``fn`` (every kernel logged,
    the ``keep`` longest returned, all of them for None), and the device's
    idle share of the call's host wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key[:80]] = getattr(e, "device_time_total", 0.0) / 1e3
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        log("profile: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None, "idle_share": None, "top": []}
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, ms in ranked:  # every kernel of the step, so that one gone from it shows
        log(f"profile: {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {name}")
    top = ranked[:keep]
    idle = 1 - busy_ms / wall_ms
    log(f"profile: step wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share {idle:.3f}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": idle,
            "top": [[n, ms] for n, ms in top]}


def small_config(torch, label: str) -> dict:
    """Phase 5: the CPU tests' configuration, card (kernels) vs CPU (plain)."""
    import numpy as np

    from skyrim_tpu_torch.rollout import scan_rollout

    model_name = label.split()[0]
    start = datetime.datetime(2024, 5, 1, 9)
    quantize = None
    if model_name == "fuxi":
        from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel

        # tests/test_golden.py:43-45, a pair a step: Swin-V2 (2 K2 rolls a
        # step), V1 (2 K1 a step), and Swin-V2 int8-served with min_size 256
        # (tests/test_quantize.py:56), its trunk products on torch._int_mm
        cfg = FuXiConfig(lat=49, lon=96, in_channels=5, embed_dim=16, depth=2, num_heads=2,
                         attn_v2=label != "fuxi V1")
        x = np.random.default_rng(0).normal(size=(2, 5, 49, 96)).astype(np.float32)
        make, key, launches = (lambda device: FuXiModel(cfg, device=device)), ("K1" if label == "fuxi V1" else "K2"), 8
        if label == "fuxi int8":
            quantize = dict(min_size=256, serve_int8=True)
    elif model_name == "fourcastnet":
        from skyrim_tpu_torch.models.afno import AFNOConfig, FourCastNetModel

        # tests/test_golden.py:40-42; no kernel of the port on its path
        cfg = AFNOConfig(lat=48, lon=96, in_channels=5, patch=8, embed_dim=16, depth=2, num_blocks=2)
        x = np.random.default_rng(0).normal(size=(5, 48, 96)).astype(np.float32)
        make, key, launches = (lambda device: FourCastNetModel(cfg, device=device)), None, 0
    elif model_name == "dlwp":
        from skyrim_tpu_torch.grid import LatLonGrid
        from skyrim_tpu_torch.models.dlwp import DLWPModel

        # tests/models/test_dlwp.py:9-18: face 16, features (8, 16), 73x144, 2 frames a call; no kernel of the
        # port on its path
        x = np.random.default_rng(0).normal(size=(2, 7, 73, 144)).astype(np.float32)
        make, key, launches = (lambda device: DLWPModel(16, (8, 16), grid=LatLonGrid(73, 144), device=device)), None, 0
    elif model_name == "pangu":
        from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

        cfg = PanguConfig(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
        x = np.random.default_rng(0).normal(size=(69, 49, 96)).astype(np.float32)
        make, key, launches = (lambda device: PanguModel("pangu", cfg=cfg, device=device)), "K1", 32
    elif model_name == "fourcastnet_v2":
        from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig

        # tests/test_golden.py:39-40; no kernel of the port on its path
        cfg = SFNOConfig(lat=49, lon=96, in_channels=5, embed_dim=16, num_layers=2, scale_factor=4)
        x = np.random.default_rng(0).normal(size=(5, 49, 96)).astype(np.float32)
        make, key, launches = (lambda device: FourCastNetV2Model(cfg, device=device)), None, 0
    elif model_name == "fengwu":
        from skyrim_tpu_torch.models.fengwu import FengWuConfig, FengWuModel

        # tests/test_golden.py:46-49: 2 fuser blocks a step through K1
        cfg = FengWuConfig(lat=49, lon=96, levels=3, surface_channels=2, level_vars=2, modal_dim=8, fuser_dim=24,
                           depth=2, num_heads=2)
        x = np.random.default_rng(0).normal(size=(2, 8, 49, 96)).astype(np.float32)
        make, key, launches = (lambda device: FengWuModel(cfg, device=device)), "K1", 8
    else:
        from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

        # tests/test_golden.py:50-53
        cfg = GraphCastConfig(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
        x = np.random.default_rng(0).normal(size=(2, 4, 19, 36)).astype(np.float32)
        make, key, launches = (lambda device: GraphCastModel(cfg, device=device)), "K7", 8
    outs = {}
    for device in ("cuda", "cpu"):
        model = make(device)
        params = model.init_params(torch.Generator().manual_seed(0))
        if quantize:
            params = model.quantize_params(params, **quantize)
        reset_counts()
        _, ys = scan_rollout(model, params, model.init_state(params, x, start_time=start), 4)
        outs[device] = ys.float().cpu().numpy()
        if device == "cuda" and key is None:
            ran = {k: fn.launches for k, fn in counters().items() if fn.launches}
            check(not ran, f"small {label} config launched kernels of the port: {ran}")
        elif device == "cuda":
            check(counters()[key].launches == launches, f"small {label} config did not run {key} on the card")
    worst = 0.0
    for step in range(4):
        ref, out = outs["cpu"][step].astype(np.float64), outs["cuda"][step].astype(np.float64)
        tol = GOLDEN * ref.std()
        d = out - ref
        check(abs(out.mean() - ref.mean()) < tol and abs(out.std() - ref.std()) < tol,
              f"small {label} config step {step + 1}: mean/std differ beyond {tol:.3g}")
        check(float(np.sqrt((d**2).mean())) < tol, f"small {label} config step {step + 1}: rms diff over {tol:.3g}")
        check(float(np.abs(d).max()) < 10 * tol, f"small {label} config step {step + 1}: max diff over {10 * tol:.3g}")
        worst = max(worst, float(np.abs(d).max() / ref.std()))
    log(f"small {label} config: card vs CPU over 4 steps, worst max|diff|/std = {worst:.4f}")
    return dict(worst_max_over_std=worst)


# --- the train phase ------------------------------------------------------------------


def _flat_tensors(args):
    out = []
    for a in args:
        if isinstance(a, (tuple, list)):
            out += _flat_tensors(a)
        elif hasattr(a, "requires_grad"):
            out.append(a)
    return out


def grad_check(torch, g, name, fn, plain, args, exact=False) -> dict:
    """The gradients of ``fn(*args)`` (a wrapper's Function: the kernel
    forward, its backward) against autograd through ``plain(*args)`` on the
    same inputs and cotangent, for every input that requires a gradient:
    within 1e-5 of the largest plain gradient (the backward replays the
    plain composition on the saved inputs, so only summation order may
    differ), exactly for ``exact``.  Raises SmokeError where the output is
    cut from the graph or a gradient is missing.  Returns the worst error
    over its limit's scale and the ms of a forward + backward of each."""
    leaves = [t for t in _flat_tensors(args) if t.requires_grad]
    out = fn(*args)
    check(out.grad_fn is not None, f"{name}: the output is cut from the autograd graph")
    cot = torch.randn(out.shape, device=out.device, generator=g).to(out.dtype)
    got = torch.autograd.grad(out, leaves, cot, allow_unused=True)
    check(all(x is not None for x in got), f"{name}: an input got no gradient")
    ref = torch.autograd.grad(plain(*args), leaves, cot)
    worst = 0.0
    for a, b in zip(got, ref):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite gradient")
        err, scale = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        worst = max(worst, err / scale if scale else err)
    check(worst == 0 if exact else worst <= 1e-5, f"{name}: gradient off by {worst:.3g} of its largest element")
    del out, got, ref

    def both(f):
        return lambda: torch.autograd.grad(f(*args), leaves, cot)

    return dict(rel_err=worst, ms=time_ms(torch, both(fn), 3), plain_ms=time_ms(torch, both(plain), 3))


def kernel_grad_checks(torch, g) -> dict:
    """K1 (both Pangu stages, shifted, earth bias at 0.5), K2 (both shapes;
    its backward one K2 launch, equal to torch.roll's gradient bit for bit),
    K3 and K4 (on the stage buffers' views) at full width: each Function's
    gradients against autograd through its plain version; then a K1 whose
    output is detached (its kernel path without the Function), which the
    check must refuse."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops import roll as RL
    from skyrim_tpu_torch.ops.windows import shift_attention_mask

    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32, grad=True):
        t = (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)
        return t.requires_grad_(grad)

    out = {}
    window = (2, 6, 12)
    for stage, (Z, H, Wd, C, heads, valid_h) in (("stage 1/4", (8, 186, 360, 192, 6, 181)),
                                                  ("stage 2/3", (8, 96, 180, 384, 12, 91))):
        hidden, wlen = 4 * C, 144
        mask = torch.from_numpy(shift_attention_mask((Z, H, Wd), window, (1, 3, 6), (Z, valid_h, Wd))).to(dev)
        args = (randn(Z, H, Wd, C, dtype=bf16), (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
                (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)),
                randn(Z // 2 * H // 6, heads, wlen, wlen, scale=ATTN_BIAS_SCALE), mask,
                (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)), (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
                (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1), randn(hidden, C, scale=hidden**-0.5),
                 randn(C, scale=0.1)), window, heads)
        out[f"K1 {stage}"] = grad_check(torch, g, f"K1 {stage}", FB.fused_swin_block, FB.reference_swin_block, args)
        if stage == "stage 1/4":
            try:  # the planted fault: K1's kernel path returning a detached output, as before its Function
                grad_check(torch, g, "K1 cut from the graph", lambda *a: FB._swin_block(*a).detach(),
                           FB.reference_swin_block, args)
            except SmokeError as e:
                out["K1 cut from the graph"] = f"refused: {e}"
            check("K1 cut from the graph" in out, "the gradient check took a K1 output cut from the graph")
        x = args[0]
        before = RL.roll3d.launches
        y = RL.roll3d(x, (1, 3, 6))
        torch.autograd.grad(y, x, torch.ones_like(y))
        check(RL.roll3d.launches == before + 2, "K2's backward did not launch K2")
        out[f"K2 {stage}"] = grad_check(torch, g, f"K2 {stage}", RL.roll3d, RL.plain_roll3d, (x, (1, 3, 6)),
                                        exact=True)
        del args, x, y
        torch.cuda.empty_cache()
    down_buf, up_buf = randn(8, 186, 360, 192, dtype=bf16), randn(8, 96, 180, 384, dtype=bf16)
    down = (down_buf[:, :181], (1 + randn(768, scale=0.1), randn(768, scale=0.3)),
            (randn(768, 384, scale=768**-0.5), randn(384, scale=0.1)))
    out["K3"] = grad_check(torch, g, "K3", RS.fused_downsample, RS._plain_downsample, down)
    up = (up_buf[:, :91], (randn(384, 768, scale=384**-0.5), randn(768, scale=0.1)),
          (1 + randn(192, scale=0.1), randn(192, scale=0.3)))
    out["K4"] = grad_check(torch, g, "K4", RS.fused_upsample, RS._plain_upsample, up)
    for k, v in out.items():
        log(f"train: gradient {k}: {v}")
    del down, up, down_buf, up_buf
    torch.cuda.empty_cache()
    return out


def graphcast_grad_checks(torch, g) -> dict:
    """K6-K9 at phase 5's small GraphCast configuration: the first call of
    each on a card forward, its inputs recorded, then each Function's
    gradients on those inputs against its plain version's (grad_check)."""
    import numpy as np

    import skyrim_tpu_torch.models.graphcast as GCM
    from skyrim_tpu_torch.ops import fused_mlp as FM
    from skyrim_tpu_torch.ops import graph_kernels as GK

    cfg = GCM.GraphCastConfig(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
    model = GCM.GraphCastModel(cfg, device="cuda")
    params = model.init_params(torch.Generator().manual_seed(0))
    kernels = {"K6": ("fused_mlp", FM.reference_mlp), "K7": ("fused_round_messages", GK.reference_round_messages),
               "K8": ("fused_m2g_tiled", GK.reference_m2g_tiled), "K9": ("fused_g2m_tiled", GK._plain_g2m_tiled)}
    seen = {}
    originals = {k: getattr(GCM, attr) for k, (attr, _) in kernels.items()}

    def recorder(key):
        def call(*args, **kw):
            seen.setdefault(key, (args, kw))
            return originals[key](*args, **kw)

        return call

    for k, (attr, _) in kernels.items():
        setattr(GCM, attr, recorder(k))
    try:
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 19, 36)).astype(np.float32)).cuda()
        with torch.no_grad():
            model.apply(params, x)
    finally:
        for k, (attr, _) in kernels.items():
            setattr(GCM, attr, originals[k])

    def fresh(a):
        if isinstance(a, (tuple, list)):
            return type(a)(fresh(v) for v in a)
        if hasattr(a, "is_floating_point") and a.is_floating_point():
            return a.detach().clone().requires_grad_(True)
        return a

    out = {}
    for k, (attr, plain) in kernels.items():
        args, kw = seen[k]
        args = fresh(args)
        kw = {n: fresh(v) for n, v in kw.items()}
        fn = originals[k]
        if k == "K7":  # two outputs: their gradients through one weighted sum
            def fn(*a, _f=fn):
                return sum((o.float() * (i + 1)).sum() for i, o in enumerate(_f(*a)))

            plain = (lambda _p: lambda *a: sum((o.float() * (i + 1)).sum() for i, o in enumerate(_p(*a))))(plain)
        out[k] = grad_check(torch, g, f"{k} (small GraphCast)", lambda *a, _f=fn: _f(*a, **kw),
                            lambda *a, _p=plain: _p(*a, **kw), args)
        log(f"train: gradient {k} at the small GraphCast configuration: {out[k]}")
    return out


def gradient_agreement(kernel: dict, plain: dict, exact: dict) -> dict:
    """Leaf gradients of one step on the kernel path against the plain
    path's, both bf16, by relative L2 error: within 2e-2, or, where the two
    bf16 paths differ by more, the kernel path no further from ``exact``
    (the plain path in f32) than 1.25x the bf16 plain path's own distance
    from it.  The earth-bias tables need the second: each table's gradient
    sums the score gradients of every window of its type, and two bf16
    computations of it differ by about 2 % whatever computes them (the
    plain path alone is 2.3 % from f32 at full width).  Returns the largest
    errors."""
    check(kernel.keys() == plain.keys() == exact.keys() and kernel, "the paths differentiate other leaves")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    leaves = [k for k, r in exact.items() if float(r.norm()) > 0]
    to_plain = {k: rel(kernel[k], plain[k]) for k in leaves}
    worst = max(to_plain, key=to_plain.get)
    floor = {}
    for k in leaves:
        if to_plain[k] > 2e-2:
            floor[k] = (rel(kernel[k], exact[k]), rel(plain[k], exact[k]))
            check(floor[k][0] <= 1.25 * floor[k][1],
                  f"{k}: kernel path {to_plain[k]:.4g} from the plain path and {floor[k][0]:.4g} from f32, "
                  f"the plain path {floor[k][1]:.4g} from f32")
    log(f"train: kernel vs plain path gradients, largest relative L2 error {to_plain[worst]:.4g} ({worst}); "
        f"{len(floor)} leaves past 2e-2, each as close to f32 as the plain path: "
        + ", ".join(f"{k.split('/')[1]} {a:.4g} vs {b:.4g}" for k, (a, b) in floor.items()))
    return {"max": to_plain[worst], "leaf": worst, "leaves": len(leaves),
            "past_2e-2": {k: {"to_plain": to_plain[k], "to_f32": a, "plain_to_f32": b} for k, (a, b) in floor.items()}}


@contextlib.contextmanager
def plain_pangu():
    """Pangu's blocks, rolls and resamplers on their plain versions on the
    card, each block under its own torch.utils.checkpoint so that a
    full-width plain step fits the card's memory."""
    import skyrim_tpu_torch.models.pangu as PM
    from torch.utils.checkpoint import checkpoint

    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops.roll import plain_roll3d

    def shift(x, s, forward):
        s = tuple(int(v) for v in s)
        return x if not any(s) else plain_roll3d(x, s if forward else tuple(-v for v in s))

    plain = {"fused_swin_block": lambda *a: checkpoint(FB.reference_swin_block, *a, use_reentrant=False),
             "fused_downsample": RS._plain_downsample, "fused_upsample": RS._plain_upsample, "shift_roll": shift}
    saved = {k: getattr(PM, k) for k in plain}
    for k, v in plain.items():
        setattr(PM, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(PM, k, v)


def write_training_set(root: Path, channels, frames: int, seed: int) -> None:
    """A CDS dataset-factory layout (metadata.json and one NetCDF slice) of
    ``frames`` 6-hourly 721x1440 frames of the channels, seeded normals."""
    import numpy as np

    from skyrim_tpu_torch.field import Field
    from skyrim_tpu_torch.grid import GRID_721x1440
    from skyrim_tpu_torch.io.netcdf import write_netcdf

    data = np.random.default_rng(seed).standard_normal((frames, len(channels), 721, 1440), dtype=np.float32)
    times = [datetime.datetime(2024, 1, 1) + datetime.timedelta(hours=6 * k) for k in range(frames)]
    write_netcdf(Field.from_canonical(data, times, list(channels), GRID_721x1440.lat, GRID_721x1440.lon),
                 root / "slice_00000.nc")
    (root / "metadata.json").write_text(json.dumps({
        "channels": list(channels), "files": ["slice_00000.nc"], "n_slices": 1, "slice_size": frames,
        "times": [t.isoformat() for t in times]}))


def train_path(torch) -> dict:
    """The train phase: Pangu (the published widths, 721x1440, 69 channels,
    embed 192, depths 2-6-6-2) finetuned through the kernels on a seeded
    synthetic dataset in the CDS layout (4 frames, 3 pairs); see the
    module's docstring."""
    import numpy as np

    from skyrim_tpu_torch.finetune import FineTuneDataset, TrainConfig, Trainer
    from skyrim_tpu_torch.models.base import make_norm_params
    from skyrim_tpu_torch.models.pangu import PanguModel
    from skyrim_tpu_torch.weights import load_params

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = kernel_grad_checks(torch, g)
    gc_grads = graphcast_grad_checks(torch, g)
    gc.collect()
    torch.cuda.empty_cache()

    res = {"kernel_gradients": grads, "graphcast_gradients": gc_grads}
    with tempfile.TemporaryDirectory() as tmp, weights_dir(Path(tmp) / "weights"):
        model = PanguModel("pangu", device="cuda")
        t0 = time.perf_counter()
        write_training_set(Path(tmp), model.channels, frames=4, seed=0)
        ds = FineTuneDataset(tmp, n_history=1, frames_out=1)
        mean, std = ds.normalization_stats()
        res["dataset_s"] = time.perf_counter() - t0
        res["dataset_gb"] = (Path(tmp) / "slice_00000.nc").stat().st_size / 1e9
        check(len(ds) == 3, f"the dataset holds {len(ds)} pairs, expected 3")
        params = model.init_params(torch.Generator().manual_seed(0))
        params["norm"] = make_norm_params(len(model.channels), mean, std, device="cuda")
        cfg = TrainConfig(batch_size=1, remat=True)
        trainer = Trainer(model, params, cfg)
        check("cache" not in trainer.params, "the trainer kept the derived cache")
        before = {k: v.detach().clone() for k, v in trainer.leaves.items()}

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fit = trainer.fit(ds)
        torch.cuda.synchronize()
        res["fit_s"] = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts()[0].items() if v}
        log(f"train: fit of {fit['steps']} steps in {res['fit_s']:.2f} s, loss {fit['loss']}, launches {counts}")
        check(fit["steps"] == 3 and np.isfinite(fit["loss"]).all(), f"fit: {fit}")
        for k in ("K1", "K2", "K3", "K4"):
            check(counts.get(k, 0) > 0, f"fit did not launch {k}")
        res.update(fit_loss=fit["loss"], fit_launches=counts)

        decay = 1 - cfg.learning_rate * cfg.weight_decay
        for k, p in trainer.leaves.items():
            if k.startswith("net24/"):  # apply runs net6: net24 takes the decay alone, and its step count
                want = before[k].clone()
                for _ in range(fit["steps"]):
                    want.mul_(decay)
                check(torch.equal(p.detach(), want), f"{k} moved by more than the decay")
                check(int(trainer.opt.state[p]["step"]) == fit["steps"], f"{k}: the optimizer skipped it")
            else:
                check(not torch.equal(p.detach(), before[k]), f"{k} did not change")
        del before

        # the same pair three times: the loss falls; each step timed by parts
        x, y = (torch.from_numpy(a[None]).cuda() for a in ds[0])
        losses, parts = [], []
        for i in range(3):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = trainer.loss(x, y)
            ev[1].record()
            loss.backward()
            ev[2].record()
            trainer.update()
            ev[3].record()
            torch.cuda.synchronize()
            trainer.step_count += 1
            losses.append(float(loss.detach()))
            parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
            if i == 1:
                step_counts, step_shapes = read_counts()
                res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del loss
        check(losses[2] < losses[0], f"the same pair three times: losses {losses}")
        fwd, bwd, opt = parts[1]
        step = {k: v for k, v in step_counts.items() if v}
        log(f"train: step ms forward {fwd:.2f} backward {bwd:.2f} optimizer {opt:.2f}, peak {res['peak_gb']:.2f} GB, "
            f"launches {step}, K1 by path {step_shapes['K1 path']}, losses {losses}")
        # remat: the forward twice (16 K1, 16 K2, K3 and K4 each), K2's 16 backward launches
        expect = {"K1": 32, "K2": 48, "K3": 2, "K4": 2, "ln_gemm": 64, "gemm": 64}
        check(step == expect, f"one train step launched {step}, expected {expect}")
        res.update(same_pair_losses=losses, step_ms={"forward": fwd, "backward": bwd, "optimizer": opt,
                                                     "total": fwd + bwd + opt}, step_launches=step)

        def one_step():
            trainer.loss(x, y).backward()
            trainer.update()

        res["profile"] = profile_call(torch, one_step)
        trainer.step_count += 1
        path = trainer.save()

        # round trip: the checkpoint, loaded and rebuilt, forecasts what the trained tree forecasts
        loaded = load_params(model, allow_init=False)
        trained = model.prepare_params({k: v for k, v in trainer.params.items()})
        state = model.init_state(trained, x[0])
        _, y_trained = model.advance(trained, state)
        _, y_loaded = model.advance(loaded, model.init_state(loaded, x[0]))
        check(torch.equal(y_trained, y_loaded), f"the checkpoint {Path(path).name} forecasts otherwise")
        res["checkpoint"] = Path(path).name
        del trainer, loaded, trained, state, y_trained, y_loaded
        gc.collect()
        torch.cuda.empty_cache()

        # one step's gradients on the kernel path, the plain path and the plain path in f32, from the same
        # parameters and pair
        got = []
        for plain, dtype in ((False, None), (True, None), (True, torch.float32)):
            if dtype is not None:
                model.compute_dtype = dtype
            tr = Trainer(model, params, TrainConfig(batch_size=1, remat=not plain))
            with plain_pangu() if plain else contextlib.nullcontext():
                tr.loss(x, y).backward()
            got.append({k: p.grad.float() for k, p in tr.leaves.items() if p.grad is not None})
            del tr
            if dtype is not None:
                del model.compute_dtype  # back to the class's bf16
            gc.collect()
            torch.cuda.empty_cache()
        res["kernel_vs_plain_rel_l2"] = gradient_agreement(*got)
        del got, params
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# --- the multi_device phase ---------------------------------------------------------------

# a sharded run against the same model, parameters and IC on one process, both through the kernels: the
# max |sharded - one process| over the mean |one process| of each step (JAX's tests/parallel/
# test_fused_shard.py:186-193 bound for its manual path)
MD_TOL = 1e-2
MD_LAUNCH_TIMEOUT_S = 480  # one launch of ranks, all of them
MD_GROUP_TIMEOUT_S = 300  # a collective or the rendezvous
# per world: (label, kind, model, mesh (dp, lat, lon), steps); every model at its published widths
MD_LAUNCHES = {
    2: (("pangu", "forecast", "pangu", (1, 1, 2), 2),
        ("fengwu", "forecast", "fengwu", (1, 1, 2), 1),
        ("dlwp", "forecast", "dlwp", (1, 1, 2), 1),
        ("ic_ensemble", "ensemble", "pangu", (2, 1, 1), 2)),
    4: (("pangu", "forecast", "pangu", (1, 1, 4), 1),
        ("ic_ensemble", "ensemble", "pangu", (2, 1, 2), 2)),
}
MD_MODES = {"pangu": "manual", "fengwu": "manual", "dlwp": "gather"}
# planted in the 4-rank Pangu, each of which the comparison must refuse: every halo of the window covers
# from the other side of the ring; the cover's offset (mis) one window token off; Pangu's constant masks
# left uncut, every rank reading rank 0's columns
MD_FAULTS = ("wrong_neighbour", "cover_offset", "consts_uncut")
MD_ENSEMBLE_MEMBERS = 2
PLAIN_VERSIONS = (("fused_block", "reference_swin_block"), ("roll", "plain_roll3d"),
                  ("resample", "_plain_downsample"), ("resample", "_plain_upsample"))  # K1-K4's, on CPU tensors


def count_plain_calls() -> dict:
    """Wrap the plain versions that K1-K4's wrappers take on a CPU tensor with
    a counter (the wrappers look them up at each call); returns the counts."""
    import importlib

    calls = {}
    for module, name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"skyrim_tpu_torch.ops.{module}")
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    return calls


@contextlib.contextmanager
def planted(fault: str):
    """One of MD_FAULTS in parallel/fused_shard.py for the block, restored after."""
    from skyrim_tpu_torch.parallel import fused_shard as FS

    name = {"wrong_neighbour": "ring_exchange", "cover_offset": "cover_offset",
            "consts_uncut": "local_lon_slice"}[fault]
    real = getattr(FS, name)
    if fault == "wrong_neighbour":
        setattr(FS, name, lambda mesh, axis, sends: real(mesh, axis, [(t, -hop) for t, hop in sends]))
    elif fault == "cover_offset":
        setattr(FS, name, lambda start, s2, ww: real(start, s2, ww) + 1)
    else:
        setattr(FS, name, lambda x, axis: x if FS.current() is None else x.narrow(axis, 0, x.shape[axis] // FS.current().n))
    try:
        yield
    finally:
        setattr(FS, name, real)


def step_errors(torch, out, ref) -> list[float]:
    """Per frame (dim 0; members by frame for an ensemble): max |out - ref| /
    mean |ref|."""
    out, ref = torch.as_tensor(out).float(), torch.as_tensor(ref).float()
    out, ref = out.reshape(-1, *out.shape[-3:]), ref.reshape(-1, *ref.shape[-3:])
    return [float((o - r).abs().max() / (r.abs().mean() + 1e-6)) for o, r in zip(out, ref)]


def md_forecast(torch, name: str, sizes, steps: int, faults: bool) -> dict:
    """One rank of a sharded forecast of ``name`` at its published widths over
    a (dp, lat, lon) = ``sizes`` mesh: seed-0 parameters drawn on the card (and
    Pangu's constant masks at random, so that a rank reading another's
    columns shows), replicated from rank 0; a seeded IC; ``steps`` sharded
    advances with every count set to 0 just before and read just after; the
    output gathered; on rank 0 the same advances on one process through the
    kernels, and the per-step errors.  With ``faults`` each of MD_FAULTS
    planted for one more step from the same IC, its ratio to MD_TOL on rank 0."""
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.parallel.mesh import make_mesh
    from skyrim_tpu_torch.parallel.sharding import gather, leaf_spec, replicate, shard_state, sharded_advance

    mesh = make_mesh(*sizes)
    model = MODELS[name](device=mesh.device)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    if name == "pangu":
        params["consts"] = torch.randn(params["consts"].shape, generator=torch.Generator(device="cuda").manual_seed(2),
                                       device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replicate(mesh, params)
    torch.cuda.synchronize()
    replicate_s = time.perf_counter() - t0
    x0 = torch.randn(model.state_shape, generator=torch.Generator(device="cuda").manual_seed(1), device=mesh.device)
    advance = sharded_advance(model, mesh)
    state0 = shard_state(mesh, model.init_state(params, x0))

    def run(n):
        """n sharded advances from the IC; the outputs gathered."""
        state, ys = state0, []
        for _ in range(n):
            state, y = advance(params, state)
            ys.append(y)
        ys = torch.cat(ys, dim=0)
        return gather(mesh, ys, leaf_spec(mesh, (*ys.shape[:-2], *model.grid.shape)))

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = run(steps)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    counts, by_shape = read_counts()
    res = dict(mode=advance.mode, counts=counts, by_shape={k: {str(s): v for s, v in by_shape[k].items()}
                                                           for k in ("K1", "K2")},
               forwards=steps, replicate_s=replicate_s, sharded_s=sharded_s, finite=bool(torch.isfinite(out).all()))
    if mesh.rank == 0:
        ref_state, refs = model.init_state(params, x0), []
        for _ in range(steps):
            ref_state, y = model.advance(params, ref_state)
            refs.append(y)
        ref = torch.cat(refs, dim=0)
        res.update(step_err=step_errors(torch, out, ref), bitwise=bool(torch.equal(out, ref)),
                   shape=tuple(out.shape))
    if faults:
        for fault in MD_FAULTS:
            with planted(fault):
                y = run(1)
            if mesh.rank == 0:
                res[f"fault {fault}"] = max(step_errors(torch, y, ref[: y.shape[0]])) / MD_TOL
    del model, params, state0, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def md_ensemble(torch, sizes, steps: int) -> dict:
    """One rank of ic_ensemble_forecast("pangu", n_members=2) at full width
    over a ``sizes`` mesh (seed-0 parameters drawn on the card, the synthetic
    IC), the counts set to 0 just before and read just after; on rank 0 the
    same call with mesh=None (the members in turn on one process) and the
    per member-step errors."""
    from skyrim_tpu_torch.core.ic_ensemble import ic_ensemble_forecast
    from skyrim_tpu_torch.models import MODELS
    from skyrim_tpu_torch.parallel.mesh import make_mesh

    import numpy as np

    from skyrim_tpu_torch.parallel.sharding import _step_mode

    mesh = make_mesh(*sizes)
    model = MODELS["pangu"](device=mesh.device)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    start = datetime.datetime(2024, 1, 1, 0)
    kw = dict(n_steps=steps, n_members=MD_ENSEMBLE_MEMBERS, ic_source="synthetic", params=params)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    field = ic_ensemble_forecast("pangu", start, mesh=mesh, **kw)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    counts, by_shape = read_counts()
    dp = sizes[0]
    members = MD_ENSEMBLE_MEMBERS // dp if MD_ENSEMBLE_MEMBERS % dp == 0 else MD_ENSEMBLE_MEMBERS
    res = dict(mode=_step_mode(model, mesh), counts=counts, by_shape={k: {str(s): v for s, v in by_shape[k].items()}
                                                       for k in ("K1", "K2")},
               forwards=members * steps, sharded_s=sharded_s, shape=tuple(field.data.shape),
               finite=bool(np.isfinite(field.data).all()), members_differ=bool(
                   np.abs(field.data[1] - field.data[0]).max() > 0))
    if mesh.rank == 0:
        alone = ic_ensemble_forecast("pangu", start, device=mesh.device, **kw)
        res.update(step_err=step_errors(torch, field.data, alone.data),
                   bitwise=bool(np.array_equal(field.data, alone.data)),
                   same_coords=field.dims == alone.dims and field.attrs == alone.attrs)
    del model, params, field
    gc.collect()
    torch.cuda.empty_cache()
    return res


def md_rank_main(workdir: str) -> int:
    """One rank of a multi_device launch (``chip_smoke.py --multi-device-rank
    DIR``, SKYRIM_COORDINATOR etc. set by the phase): every item of its
    world's MD_LAUNCHES, results to DIR/rank<r>.json."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        log("chip_smoke rank: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from skyrim_tpu_torch.parallel.mesh import maybe_initialize_distributed, process_count, rank_device

    maybe_initialize_distributed(device="cuda", timeout_s=MD_GROUP_TIMEOUT_S)
    rank, world = dist.get_rank(), process_count()
    plain = count_plain_calls()
    items = {}
    for label, kind, name, sizes, steps in MD_LAUNCHES[world]:
        t0 = time.perf_counter()
        if kind == "forecast":
            items[label] = md_forecast(torch, name, sizes, steps, faults=world == 4 and name == "pangu")
        else:
            items[label] = md_ensemble(torch, sizes, steps)
        items[label].update(mesh=list(sizes), seconds=time.perf_counter() - t0)
        log(f"md rank {rank}/{world} {label} over {sizes}: { {k: v for k, v in items[label].items() if k not in ('counts', 'by_shape')} }")
    dist.barrier()
    result = dict(rank=rank, backend=dist.get_backend(), device=str(rank_device("cuda")), items=items,
                  plain_calls=dict(plain), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def run_md_ranks(world: int) -> tuple[list[dict], float]:
    """Start ``world`` ranks of this script (a file:// rendezvous in a temporary
    directory) and wait for all of them, at most MD_LAUNCH_TIMEOUT_S; a rank
    that fails or hangs fails the phase (every rank is then killed).  Relays
    the ranks' output to stderr; returns their results and the seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, SKYRIM_COORDINATOR=f"file://{tmp}/rendezvous", SKYRIM_NUM_PROCESSES=str(world))
        procs = []
        for r in range(world):
            out = open(Path(tmp) / f"rank{r}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--multi-device-rank", tmp],
                                           cwd=ROOT, env=dict(env, SKYRIM_PROCESS_ID=str(r)), stdout=out,
                                           stderr=subprocess.STDOUT), out))
        deadline = time.monotonic() + MD_LAUNCH_TIMEOUT_S
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, out in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
        for r in range(world):
            for line in (Path(tmp) / f"rank{r}.log").read_text().splitlines():
                log(f"[rank {r}/{world}] {line}")
        codes = [p.returncode for p, _ in procs]
        check(all(c == 0 for c in codes), f"multi_device: {world} ranks exited {codes} (killed after "
                                          f"{MD_LAUNCH_TIMEOUT_S} s where they hung)")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(world)], time.perf_counter() - t0


def chunk_checks(torch, g) -> dict:
    """The kernels at the multi_device path's shapes, on one process.  K1 on
    Pangu's window covers and K3 and K4 on a rank's lon chunks (contiguous
    copies) against their plain versions, with phase 3's tolerance; then K1
    on each half and K3 and K4 on each half and quarter of a full-width
    input's longitude against the same columns of one launch on the whole,
    bit for bit, so that a sharded forward can equal the single process's
    (K2 is exact, the row GEMM and the attention per row and per window).
    Returns each check's max |diff|."""
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import resample as RS
    from skyrim_tpu_torch.ops.windows import shift_attention_mask

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    window, shift = (2, 6, 12), (1, 3, 6)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    def block(C, heads, H, valid_h):
        """K1's parameters at width C (Pangu's stage 1 or 2) and its shift mask."""
        hidden, n_types = 4 * C, 4 * H // 6
        mask = torch.from_numpy(shift_attention_mask((8, H, 12), window, shift, (8, valid_h, 12))).to(dev)
        args = ((1 + randn(C, scale=0.1), randn(C, scale=0.1)), (randn(C, 3 * C, scale=C**-0.5), randn(3 * C, scale=0.1)),
                randn(n_types, heads, 144, 144, scale=0.5), mask, (randn(C, C, scale=C**-0.5), randn(C, scale=0.1)),
                (1 + randn(C, scale=0.1), randn(C, scale=0.1)),
                (randn(C, hidden, scale=C**-0.5), randn(hidden, scale=0.1), randn(hidden, C, scale=hidden**-0.5),
                 randn(C, scale=0.1)))
        return (lambda x: FB.fused_swin_block(x, *args, window, heads),
                lambda x: FB.reference_swin_block(x, *args, window, heads))

    stage1, stage2 = block(192, 6, 186, 181), block(384, 12, 96, 91)
    C = 192
    k3 = ((1 + randn(4 * C, scale=0.1), randn(4 * C, scale=0.3)), (randn(4 * C, 2 * C, scale=(4 * C) ** -0.5),
                                                                  randn(2 * C, scale=0.1)))
    k4 = ((randn(2 * C, 4 * C, scale=(2 * C) ** -0.5), randn(4 * C, scale=0.1)),
          (1 + randn(C, scale=0.1), randn(C, scale=0.3)))
    down = (lambda x: RS.fused_downsample(x, *k3), lambda x: RS._plain_downsample(x, *k3))
    up = (lambda x: RS.fused_upsample(x, *k4), lambda x: RS._plain_upsample(x, *k4))
    out = {}
    # against the plain versions: K1 on the covers of 2 and 4 ranks, K3 and K4 on a rank's chunk
    for name, (fn, plain), shape in (("K1", stage1, (8, 186, 192, C)), ("K1", stage1, (8, 186, 108, C)),
                                     ("K1", stage2, (8, 96, 108, 2 * C)), ("K1", stage2, (8, 96, 60, 2 * C)),
                                     ("K3", down, (8, 181, 180, C)), ("K3", down, (8, 181, 90, C)),
                                     ("K4", up, (8, 91, 90, 2 * C)), ("K4", up, (8, 91, 45, 2 * C))):
        x = randn(*shape).to(bf16)
        out[f"{name} {shape} vs plain"] = compare(torch, fn(x), plain(x), f"multi_device {name} at {shape}")
    # on lon chunks against the whole (scale: output columns a 2 input columns)
    for name, fn, x, scale, parts in (("K1", stage1[0], randn(8, 186, 360, C).to(bf16), 2, (2,)),
                                      ("K3", down[0], randn(8, 186, 360, C).to(bf16)[:, :181], 1, (2, 4)),
                                      ("K4", up[0], randn(8, 96, 180, 2 * C).to(bf16)[:, :91], 4, (2, 4))):
        whole, worst = fn(x), 0.0
        for n in parts:  # K1: 90-token quarters cut a window
            w = x.shape[2] // n
            for d in range(n):
                part = fn(x[:, :, d * w:(d + 1) * w].contiguous())
                cols = whole[:, :, d * w * scale // 2:(d + 1) * w * scale // 2]
                worst = max(worst, float((part.float() - cols.float()).abs().max()))
        out[f"{name} on lon chunks vs the whole"] = worst
        check(worst == 0.0, f"multi_device: {name} on a lon chunk differs from its columns of the whole by {worst}")
    torch.cuda.synchronize()
    log(f"multi_device: the kernels at the path's shapes: {out}")
    return out


def multi_device_path(torch) -> dict:
    """The multi_device phase (run last): two launches of rank processes that
    share the card over gloo, 2 and 4 ranks (MD_LAUNCHES), each item held to
    the same model, parameters and IC on one process through the kernels
    within MD_TOL a step; each rank's launches those of its local forwards
    (``expected_launches``; Pangu: K1 16, K2 16, K3 1, K4 1 a forward), no
    plain-version call; the 4-rank Pangu refusing MD_FAULTS."""
    from skyrim_tpu_torch.models import MODELS

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    res = {"card": smi, "kernel_checks": chunk_checks(torch, torch.Generator(device="cuda").manual_seed(0)),
           "launches": {}}
    gc.collect()
    torch.cuda.empty_cache()
    for world, items in MD_LAUNCHES.items():
        ranks, seconds = run_md_ranks(world)
        summary = {"seconds": seconds, "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
                   "peak_gb": [r["peak_gb"] for r in ranks], "items": {}}
        for r in ranks:
            check(r["backend"] == "gloo", f"multi_device: rank {r['rank']} on backend {r['backend']}, expected gloo "
                                          f"(ranks share one card)")
            check(sum(r["plain_calls"].values()) == 0, f"multi_device: rank {r['rank']} called plain versions "
                                                       f"{r['plain_calls']}")
        for label, kind, name, sizes, steps in items:
            per_rank = [r["items"][label] for r in ranks]
            head = per_rank[0]
            what = f"multi_device {label} over {tuple(sizes)}"
            expect, _ = expected_launches(MODELS[name](device="cuda"), head["forwards"])
            for r, it in enumerate(per_rank):
                check(it["mode"] == MD_MODES[name], f"{what}: rank {r} stepped in mode {it['mode']}")
                check(it["finite"], f"{what}: rank {r} gathered non-finite values")
                for k, v in expect.items():
                    check(it["counts"][k] == v, f"{what}: rank {r} launched {k} {it['counts'][k]} times, expected "
                                                f"{v} ({head['forwards']} local forwards)")
            check(max(head["step_err"]) <= MD_TOL, f"{what}: step errors {head['step_err']} past {MD_TOL}")
            if kind == "ensemble":
                check(head["same_coords"] and head["members_differ"], f"{what}: coords or members wrong")
            faults = {k[len('fault '):]: v for k, v in head.items() if k.startswith("fault ")}
            for fault, ratio in faults.items():
                check(ratio > 1, f"{what}: planted fault {fault} not refused ({ratio:.3g}x the limit)")
            summary["items"][label] = dict(
                mesh=sizes, steps=steps, mode=head["mode"], step_err=head["step_err"], bitwise=head["bitwise"],
                launches_per_rank={k: per_rank[0]["counts"][k] for k in ("K1", "K2", "K3", "K4")},
                k1_k2_shapes=head["by_shape"], forwards_per_rank=head["forwards"], fault_over_limit=faults,
                seconds=[it["seconds"] for it in per_rank], sharded_s=[it["sharded_s"] for it in per_rank],
                replicate_s=head.get("replicate_s"))
            log(f"{what}: mode {head['mode']}, step errors {['%.3g' % e for e in head['step_err']]} "
                f"(limit {MD_TOL}), bit for bit {head['bitwise']}, launches a rank "
                f"{summary['items'][label]['launches_per_rank']} over {head['forwards']} forwards, "
                f"K1/K2 by shape {head['by_shape']}, plain calls 0"
                + (f", planted faults refused at {faults} x the limit" if faults else ""))
        log(f"multi_device: {world} ranks on backend {summary['backend']} ({summary['devices']}) in "
            f"{seconds:.1f} s; {smi}")
        res["launches"][world] = summary
    res["seconds"] = time.perf_counter() - t_phase
    log(f"multi_device: phase {res['seconds']:.1f} s; {smi}")
    return res


def dlwp_summary(run: dict) -> dict:
    """DLWP's main path for the results line: ms a call (12 h) and a 6-h
    frame, the device's busy time by kernel name and idle share of one call,
    its peak, and the launches of the port's kernels (all 0)."""
    return dict(step_ms_per_call=run["step_ms"], step_ms_per_frame=[t / run["frames_out"] for t in run["step_ms"]],
                busy_ms=run["profile"]["device_busy_ms"], busy_by_kernel=run["profile"]["top"],
                idle_share=run["profile"]["idle_share"], peak_gb=run["peak_gb"], setup_s=run["setup_s"],
                port_kernel_launches=sum(run["counts"].values()))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--multi-device-rank":
        return md_rank_main(sys.argv[2])
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "skyrim_tpu_torch" / "csrc").is_dir():
        log("chip_smoke: run from the root of a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain references run in full f32
    torch.backends.cudnn.allow_tf32 = False

    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(smi, flush=True)

        # 2. build
        from skyrim_tpu_torch.ops import _build

        build_s = _build.build()
        log(f"build: {len(_build.LIBS)} libraries in {build_s:.1f} s")

        # 4. the main paths, first: what they measure does not depend on what phase 3 allocated and freed
        mp = {label: main_path(torch, label, torch.Generator(device="cuda").manual_seed(0)) for label in MAIN_PATHS}
        facade = facade_path(torch)
        ensemble, ic_ensemble = ensemble_paths(torch)
        data_io = data_io_path(torch)
        train = train_path(torch)

        # 3. kernels against their plain versions at full width
        g = torch.Generator(device="cuda").manual_seed(0)
        rows, attn_err = kernel_checks(torch, g)
        log(f"K1 window attention alone, earth bias at {ATTN_BIAS_SCALE}: max_abs_err {attn_err}")
        rs_rows, rs_faults, resample = resample_checks(torch, g)
        rows += rs_rows
        gc_rows, faults, k9_parts = graphcast_kernel_checks(torch, g)
        faults.update(rs_faults)
        gemm_rows, ln_faults = row_gemm_checks(torch, g)
        faults.update(ln_faults)
        msg_rows, msg_faults, msg_parts = message_op_checks(torch, g)
        faults.update(msg_faults)
        sht = sht_checks(torch, g)
        rows += gc_rows + attention_op_checks(torch, g) + msg_rows
        for r in rows:
            log(f"kernel {r['name']}: ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                f"bound {r['bound_ms']:.4f} ({r['bound_by']}) max_abs_err {r['max_abs_err']:.4g}")

        for r in rows:
            key, shape = r["name"].split()[0], r.pop("shape")
            if "launches" not in r:  # a forecast's kernel: its launches on that forecast, named in the row
                forecast, r["launches"] = forecast_launches(mp, key, shape)
                r["name"] += f" [launches: the {forecast} forecast]"
            elif shape is not None:  # K5 at a Pangu stage: its launches on the module path
                r["launches"] = mp["pangu"]["modules"]["by_shape"].get(shape, 0)
            check(r["launches"] > 0, f"{r['name']} was not launched on its path")
        for r in gemm_rows:  # the row GEMM's launches per forward: those of the kernel it runs inside
            if "launch_of" in r:
                forecast, n = forecast_launches(mp, *r.pop("launch_of"))
                check(n > 0, f"{r['name']}: its kernel was not launched on the main path")
                r["forecast"], r["launches_per_forward"] = forecast, n / mp[forecast]["n_steps"]

        # 5. small configurations, card vs CPU
        small = {}
        for label in SMALL_CONFIGS:
            t0 = time.perf_counter()
            small[label] = small_config(torch, label)
            small[label]["seconds"] = time.perf_counter() - t0

        # 7. the multi-device layer: ranks that share the card
        multi_device = multi_device_path(torch)
    except Exception as e:  # every failure ends the run without a result
        log(f"chip_smoke: FAILED: {type(e).__name__}: {e}")
        import traceback

        traceback.print_exc()
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "main_path": {name: {k: run[k] for k in ("setup_s", "setup_launches", "forecast_s", "step_ms",
                                                 "peak_gb", "profile")} for name, run in mp.items()},
        "facade": facade,
        "dlwp": dlwp_summary(mp["dlwp"]),
        "ensemble": ensemble,
        "ic_ensemble": ic_ensemble,
        "data_io": data_io,
        "train": train,
        "added_phases_s": mp["dlwp"]["wall_s"] + ensemble["seconds"] + ic_ensemble["seconds"]
        + small["dlwp"]["seconds"],
        "small_config": small,
        "attention_alone_max_abs_err": attn_err,
        "fault_err_over_limit": faults,
        "k9_parts": k9_parts,
        "resample": resample,
        "row_gemm": gemm_rows,
        "message_parts": msg_parts,
        "module_path_max_abs_err": mp["pangu"]["modules"]["max_abs_err"],
        "fuxi_cascade": mp["fuxi"]["cascade"],
        "fuxi_int8": mp["fuxi"]["int8"],
        "sht": sht,
        "multi_device": multi_device,
        "build_s": build_s,
    }), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

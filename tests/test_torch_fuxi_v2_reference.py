"""The port's FuXi (the Swin-V2 cascade) against the benchmark's plain f32
reference, ``wxbench/reference/fuxi.py``, and K15 against its plain
composition on the card.

CPU, seeded random weights at a small size: two pairs of blocks at C 96, 4
heads, window (6, 12), on 85 × 96 (22 × 24 tokens, merged to 11 × 12 and
padded by one row to whole windows, so the padded row is masked as keys in
both blocks of a pair), three stages of one step each, so that steps 0, 1
and 2 take the short, medium and long stage.  The weights are bf16 at rest
as the port holds them, the reference reads them in f32.  The biases,
LayerNorm affines and logit scales are drawn (the logit scales over [1,
5.5], so that the clamp at log 100 acts on some heads).

Tolerances, in ``wxbench.harness.compare.step_error``'s measure for a step
(the worst channel's RMS gap over the RMS of the step's increment) and in
RMS gap over the reference's RMS for a block:

- the port in f32 against the reference: 1e-2 for a block and for a step
  (measured 2.5e-4 and 1.4e-3 for the blocks, 1.7e-3 to 2.7e-3 for the
  steps).  Not closer, because the port computes each head's
  ``exp(min(logit_scale, log 100))`` in the leaf's bf16, as the JAX package
  does, and the reference in f32: a relative gap of up to 2⁻⁹ in a scale of
  up to 100 moves a cosine score by up to 0.2;
- the port in bf16 against the reference: 8e-2 for a step, the bf16 rounding
  of every product and of the residual stream on top, which the large logit
  scales sharpen (measured 2.1e-2 to 4.2e-2);
- each planted fault (q and k left unnormalised, the clamp dropped, pre-norm
  in place of post-norm, the wrong stage at a switch) reads at least 3× the
  f32 tolerance (measured: 0.52, 0.077, 0.66 and 2.1 at their worst step).

GPU (marker ``gpu``): K15 at FuXi's trunk (96 × 180 × 1536, 24 heads,
window (6, 12), 91 valid rows) against ``reference_swin_v2_block`` run on
the card in bf16, shifted and unshifted, by the kernels table's rule on the
valid rows: |kernel − plain| ≤ 2e-2·std(plain) + 2 bf16 ulps of max|plain|.
The padded rows are left out: their queries may see no key, and the two
then round a softmax over −1e9 differently (they never reach a valid row,
which masks them as keys).  The logit scales are drawn at log 10 + N(0,
0.1²), the published initial value.  Both are also held to the same
composition in f32 on the card: the kernel's RMS gap to it is at most 1.1×
the bf16 composition's (measured 0.86×: the kernel rounds fewer
intermediates).  A fault (each head given its neighbour's scale) must fail
the rule.  Near the clamp (log 100 + N(0, 0.1²), clamped) a rounding of q̂
or k̂ moves a score by up to ≈ 0.2, so two bf16 versions part by more than
the rule (≈ 2×); there the yardstick is the f32 composition, and the
kernel's RMS gap to it may not exceed the bf16 composition's.  Other
shapes run K15 too: the attention's general body (hd 12 with rows that
load lane by lane, hd 24) and the register body's other geometry (wlen
144, hd 32), shifted and not with a padded row: the attention alone by the
rule, the block against f32 (``test_k15_other_shapes_on_card`` says why);
a width no kernel takes (C % 8) raises.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skyrim_tpu_torch.models import fuxi as FX
from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel
from skyrim_tpu_torch.ops import fused_block as FB
from skyrim_tpu_torch.ops import windows as W
from skyrim_tpu_torch.ops.gemm import _layernorm_f32
from wxbench.harness.compare import step_error
from wxbench.reference import fuxi as ref

CFG = dict(lat=85, lon=96, in_channels=5, embed_dim=96, depth=4, num_heads=4, window=(6, 12), patch=4,
           n_stages=3, stage_steps=1, attn_v2=True)
TOL_F32, TOL_BF16, FAULT = 1e-2, 8e-2, 3.0


def _draw(model: FuXiModel, seed: int = 0):
    """Params (bf16 stages, f32 norm stats) and the reference's weights."""
    g = torch.Generator().manual_seed(seed)
    stages, weights = [], {}
    for k in range(model.cfg.n_stages):
        net = model.new_net()
        state = {}
        for name, p in net.named_parameters():
            shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_in = math.prod(shape[1:-1] if name.startswith("pairs.") else shape[:-1])
                t = torch.randn(shape, generator=g) / math.sqrt(fan_in)
            elif leaf == "logit_scale":
                t = 1.0 + 4.5 * torch.rand(shape, generator=g)
            elif leaf == "scale":
                t = 0.5 + 1.5 * torch.rand(shape, generator=g)
            else:
                t = 0.3 * torch.randn(shape, generator=g)
            state[name] = t.to(torch.bfloat16)
        net.load_state_dict(state, strict=True, assign=True)
        stages.append(net.eval().requires_grad_(False))
        weights |= {f"stage{k}.{n}": t for n, t in state.items()}
    C = model.cfg.in_channels
    mean, std = torch.randn(C, 1, 1, generator=g), 0.5 + torch.rand(C, 1, 1, generator=g)
    weights |= {"norm.mean": mean, "norm.std": std}
    return {"stages": stages, "norm": {"mean": mean, "std": std}}, weights


@pytest.fixture(scope="module")
def case():
    model = FuXiModel(FuXiConfig(**CFG), device="cpu")
    params, weights = _draw(model)
    assert max(float(p.pairs["a"].logit_scale.max()) for p in params["stages"]) > math.log(100.0)  # the clamp acts
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, CFG["in_channels"], CFG["lat"], CFG["lon"], generator=g) * weights["norm.std"] + weights["norm.mean"]
    return model, params, weights, x


def _step_errors(model, params, weights, x, dtype, steps=(0, 1, 2)):
    """step_error of the port's ``advance`` against the reference at each of
    ``steps``, every step from the same two frames."""
    model.compute_dtype = dtype
    prepared = model.prepare_params(params)
    out = []
    for k in steps:
        state = model.init_state(prepared, x).replace(step=k)
        _, y = model.advance(prepared, state)
        r = ref.forecast_step(weights, CFG, k, x)
        out.append(step_error(y[0], r, weights["norm.std"], x[-1]))
    return out


def _rel(a, b) -> float:
    return float((a.double() - b.double()).pow(2).mean().sqrt() / b.double().pow(2).mean().sqrt())


def test_reference_tables_equal_the_ports():
    np.testing.assert_array_equal(ref.rel_index((6, 12)), W.swin_rel_index((6, 12)))
    np.testing.assert_array_equal(ref.log_coords((6, 12)), W.swin_v2_log_coords((6, 12)))


@pytest.mark.parametrize("shifted", [False, True])
def test_block_matches_reference(case, shifted):
    """``models.fuxi.swin_v2_block`` in f32 against the reference's block, on a
    (12, 24, 96) activation whose last row is padding (valid_h 11)."""
    _, params, weights, _ = case
    half = "b" if shifted else "a"
    prm = {k[len(f"pairs/{half}/"):]: v[1] for k, v in FX._leaves(params["stages"][2]).items()
           if k.startswith(f"pairs/{half}/")}
    bias, scale = FX.swin_v2_terms(prm, CFG["window"])
    x = torch.randn(12, 24, 96, generator=torch.Generator().manual_seed(2))
    out = FX.swin_v2_block(x, prm, bias, scale, 4, CFG["window"], shifted, 11)
    r = ref.swin_v2_block(x, weights, f"stage2.pairs.{half}.", 1, CFG["window"], 4, shifted, 11)
    assert _rel(out[:11], r[:11]) < TOL_F32


def test_cascade_matches_reference_f32(case):
    """Steps 0, 1, 2 (short, medium, long) of the port in f32."""
    model, params, weights, x = case
    errs = _step_errors(model, params, weights, x, torch.float32)
    assert max(errs) < TOL_F32, errs


def test_cascade_matches_reference_bf16(case):
    model, params, weights, x = case
    errs = _step_errors(model, params, weights, x, torch.bfloat16)
    assert max(errs) < TOL_BF16, errs


def _prenorm_block(x, qkv_wb, bias, scale, mask, proj_wb, norm1, mlp_wb, norm2, window, heads, shift,
                   dense=FB._dense_wb):
    """A faulty block: pre-norm (``x + f(LN(x))``) in place of post-norm."""
    H, Wd, C = x.shape
    dt, hd = x.dtype, C // heads
    xs = torch.roll(x, (-shift[0], -shift[1]), (0, 1))
    parts = W.window_partition(_layernorm_f32(xs, *norm1).to(dt)[None], (1, *window))
    n_win, wlen, _ = parts.shape
    q, k, v = dense(parts, qkv_wb).view(n_win, wlen, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    s = FB._unit_rows(q) @ FB._unit_rows(k).transpose(-1, -2) * scale.reshape(heads, 1, 1) + bias
    if mask is not None:
        s = (s.view(1, mask.shape[1], -1, heads, wlen, wlen) + mask[:, :, None, None]).view(s.shape)
    o = (torch.softmax(s.float(), -1).to(dt) @ v).transpose(1, 2).reshape(n_win, wlen, C)
    o = W.window_reverse(dense(o, proj_wb), (1, *window), (1, H, Wd))[0]
    x = x + torch.roll(o, shift, (0, 1))
    return x + dense(F.gelu(dense(_layernorm_f32(x, *norm2).to(dt), mlp_wb[:2]), approximate="tanh"), mlp_wb[2:])


def _late_switch(self, step, resident):
    """A faulty cascade: each stage switch one step late."""
    return min(max(step - 1, 0) // self.cfg.stage_steps, resident - 1)


FAULTS = {
    "q and k unnormalised": (FB, "_unit_rows", lambda t: t),
    "clamp dropped": (FX, "LOGIT_SCALE_MAX", math.inf),
    "pre-norm": (FB, "reference_swin_v2_block", _prenorm_block),
    "late stage switch": (FuXiModel, "stage_index", _late_switch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails(case, fault, monkeypatch):
    model, params, weights, x = case
    monkeypatch.setattr(*FAULTS[fault])
    errs = _step_errors(model, {k: v for k, v in params.items() if k != "cache"}, weights, x, torch.float32)
    assert max(errs) > FAULT * TOL_F32, errs


def test_prepare_params_caches_every_stage(case):
    """Every stage's terms are made once, before the first step, and a step
    reads them: equal to the terms made from the leaves."""
    model, params, _, x = case
    prepared = model.prepare_params(params)
    cache = prepared["cache"]["swin_v2"]
    assert len(cache) == len(params["stages"])
    for stage, terms in zip(params["stages"], cache):
        leaves = FX._leaves(stage)
        for half in ("a", "b"):
            bias, scale = FX.swin_v2_terms({k[8:]: v for k, v in leaves.items() if k.startswith(f"pairs/{half}/")},
                                           CFG["window"])
            assert torch.equal(terms[half]["bias"], bias) and torch.equal(terms[half]["scale"], scale)
            assert terms[half]["vectors"]["qkv/bias"].dtype == torch.float32
    model.compute_dtype = torch.float32
    state = model.init_state(prepared, x)
    a = model.advance(prepared, state)[1]
    b = model.advance({k: v for k, v in prepared.items() if k != "cache"}, state)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert "cache" not in model.quantize_params(prepared)


# --- the card ----------------------------------------------------------------------


def _block_inputs(H, Wd, C, heads, window, valid, shifted: bool, seed: int = 0, logit: float = math.log(10.0)):
    """A block's inputs on the card: (H, W, C) bf16, ``valid`` valid rows,
    logit scales exp(min(logit + N(0, 0.1²), log 100))."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    bf, wlen = torch.bfloat16, window[0] * window[1]
    x = n(H, Wd, C).to(bf)
    qkv = (n(C, 3 * C, std=C**-0.5).to(bf), n(3 * C, std=0.1))
    proj = (n(C, C, std=C**-0.5).to(bf), n(C, std=0.1))
    mlp = (n(C, 4 * C, std=C**-0.5).to(bf), n(4 * C, std=0.1), n(4 * C, C, std=(4 * C) ** -0.5).to(bf), n(C, std=0.1))
    norm1, norm2 = (1 + n(C, std=0.1), n(C, std=0.1)), (1 + n(C, std=0.1), n(C, std=0.1))
    bias = 16 * torch.sigmoid(n(heads, wlen, wlen))
    scale = torch.exp(torch.clamp(logit + n(heads, std=0.1), max=math.log(100.0)))
    shift = (window[0] // 2, window[1] // 2) if shifted else (0, 0)
    mask = W.mask_tensor((1, H, Wd), (1, *window), (0, *shift), (1, valid, Wd), torch.device("cuda"))
    return x, qkv, bias, scale, mask, proj, norm1, mlp, norm2, window, heads, shift


def _full_block_inputs(shifted: bool, seed: int = 0, logit: float = math.log(10.0)):
    """FuXi's trunk: (96, 180, 1536) bf16, 24 heads, window (6, 12), 91 valid rows."""
    return _block_inputs(96, 180, 1536, 24, (6, 12), 91, shifted, seed, logit), 91


def _in_f32(args):
    return tuple(tuple(t.float() for t in a) if isinstance(a, tuple) and torch.is_tensor(a[0])
                 else a.float() if torch.is_tensor(a) else a for a in args)


def _over_limit(out, plain) -> float:
    plain = plain.float()
    limit = 2e-2 * plain.std() + 2 * 2.0**-8 * plain.abs().max()
    return float(((out.float() - plain).abs() / limit).max())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
def test_k15_matches_plain_on_card(shifted):
    _needs_card()
    args, valid = _full_block_inputs(shifted)
    with torch.no_grad():
        calls = FB.fused_swin_v2_block.launches
        out = FB.fused_swin_v2_block(*args)
        plain = FB.reference_swin_v2_block(*args)
        assert FB.fused_swin_v2_block.launches == calls + 1  # the kernels ran
        assert _over_limit(out[:valid], plain[:valid]) <= 1.0
        f32 = FB.reference_swin_v2_block(*_in_f32(args))
        assert _rel(out[:valid], f32[:valid]) <= 1.1 * _rel(plain[:valid], f32[:valid])
        x, qkv, bias, scale, *rest = args
        faulty = FB.fused_swin_v2_block(x, qkv, bias, scale.roll(1), *rest)
        assert _over_limit(faulty[:valid], plain[:valid]) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
def test_k15_near_the_clamp_is_closer_to_f32_on_card(shifted):
    """Logit scales near 100: the kernel's RMS gap to the f32 composition at
    or below the bf16 composition's."""
    _needs_card()
    args, valid = _full_block_inputs(shifted, seed=1, logit=math.log(100.0))
    assert float(args[3].min()) > 60.0
    with torch.no_grad():
        out = FB.fused_swin_v2_block(*args)[:valid]
        plain = FB.reference_swin_v2_block(*args)[:valid]
        f32 = FB.reference_swin_v2_block(*_in_f32(args))[:valid]
        assert _rel(out, f32) <= _rel(plain, f32)


# (H, W, C, heads, window, valid rows): the body each takes
OTHER_SHAPES = {
    "shared body, hd 12, lane by lane": ((12, 24, 48, 4, (6, 12), 11), "shared"),
    "shared body, hd 24": ((12, 24, 96, 4, (6, 12), 11), "shared"),
    "registers body, wlen 144, hd 32": ((24, 24, 128, 4, (12, 12), 23), "registers"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape", sorted(OTHER_SHAPES))
def test_k15_other_shapes_on_card(shape, shifted):
    """K15 away from FuXi's geometry, on the cosine variant of the attention
    body the window takes: the attention alone by the rule against its plain
    version on the rows whose queries see a key (the shifted frame's padded
    rows left out), and each head given its neighbour's scale refused; the
    block's RMS gap to the f32 composition at most 1.1× the bf16
    composition's, as at FuXi's shape.  The whole block is not held to the
    rule against the bf16 composition here: at these widths the two bf16
    versions part by up to 1.2× it (each ≈ 0.06 from f32 at most, with max
    |out| ≈ 7 against FuXi's ≈ 10), while the kernel is the closer to f32
    (0.85–0.90× the composition's RMS gap)."""
    _needs_card()
    (H, Wd, C, heads, window, valid), body = OTHER_SHAPES[shape]
    args = _block_inputs(H, Wd, C, heads, window, valid, shifted)
    x, qkv_wb, bias, scale, mask, *_, shift = args
    win3 = (1, *window)
    with torch.no_grad():
        before = dict(FB.cosine_window_attention.launches_by_body)
        out = FB.fused_swin_v2_block(*args)[:valid]
        assert FB.cosine_window_attention.launches_by_body.get(body, 0) == before.get(body, 0) + 1
        plain = FB.reference_swin_v2_block(*args)[:valid]
        f32 = FB.reference_swin_v2_block(*_in_f32(args))[:valid]
        assert _rel(out, f32) <= 1.1 * _rel(plain, f32)

        qkv = torch.randn(1, H, Wd, 3 * C, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
        qkv = qkv.to(torch.bfloat16)
        keep = (torch.arange(H, device="cuda") + shift[0]) % H < valid  # rows of the frame that hold no padding

        def attention(s):
            return FB.cosine_window_attention(qkv, bias, s, mask, win3, heads)[0, keep]

        ref = FB.reference_cosine_attention(W.window_partition(qkv, win3), bias, scale, mask, heads)
        ref = W.window_reverse(ref, win3, (1, H, Wd))[0, keep]
        assert _over_limit(attention(scale), ref) <= 1.0
        assert _over_limit(attention(scale.roll(1)), ref) > 1.0


@pytest.mark.gpu
def test_k15_refuses_a_width_no_kernel_takes_on_card():
    """C 36 (rows not a whole number of 16-byte chunks): raises, no fallback."""
    _needs_card()
    with torch.no_grad(), pytest.raises(ValueError):
        FB.fused_swin_v2_block(*_block_inputs(12, 24, 36, 3, (6, 12), 11, False))

"""Gradients through the port's kernels against the JAX package's custom VJPs.

Each kernel that has a ``jax.custom_vjp`` in the JAX package (K1, K2, K3,
K4, K6, K7, K8, K9, K12, K13, K14) is differentiated in both packages on
the same seeded numpy inputs and the same seeded cotangent: ``jax.grad``
through the JAX wrapper with its Pallas forward in interpret mode, as
tests/ops/test_fused_block.py:157-196 runs it, and ``torch.autograd``
through the port's wrapper (``ops/vjp.py``'s Function; K2's own rule).
Every differentiable input is compared: in f32 at atol 3e-5, rtol 1e-4
(tests/ops/test_fused_block.py:49, and the aggregates' 1e-4 relative of
tests/test_torch_graph.py); in bf16 activations at the golden tolerance
the bf16 forwards of these kernels are held to (3e-2·std on the mean, the
spread and the RMS of the difference, 10× elementwise): the plain
compositions round at other points than JAX's references, by bf16 ulps,
more than tests/ops/test_fused_block.py:190's atol 5e-4, rtol 5e-3 (which
holds two JAX paths with the same rounding points).  Where JAX's own bf16
gradient misses its f32 gradient at that tolerance (XLA on the CPU sums a
bf16-cast bias's gradient over the rows in bf16, PyTorch in f32), the
port's is held to JAX's f32 gradient.  Index tables,
K9's row plan and K1's mask get no gradient in either package.

K5, K10 and K11 have no VJP in the JAX package: on a tensor off the CPU
that requires a gradient they raise (tested on meta tensors, which reach
the card's branch without a card); their CPU plain versions stay
differentiable.

K1's backward replays its plain composition with the attention on a
Function of its own on the card (``ops/fused_block.py``): its plain
version, ``reference_window_attention_backward``, is held to autograd
through ``reference_window_attention_4d`` and to JAX's ``jax.vjp`` of its
reference in f32 at atol 3e-5, rtol 1e-4.

On the card (marker ``gpu``): each Function's gradients against autograd
through its plain version on the same card tensors, within 1e-5·max|g|
(the backward replays that composition; scatter sums may add in another
order), K2's exactly, and K2's backward a K2 launch; K1's where its
attention's backward is the kernel at the golden tolerance against the
plain version's f32 gradient (the kernel rounds P and dS to bf16 as
operands of its products, which the bf16 replay did in f32), or, where
it misses, by at most 1.25 times what the bf16 plain version misses it
by, as for the earth-bias tables in a whole step (``chip_smoke.py``).  The
attention backward kernel against f32 autograd of the plain attention at
the golden tolerance at Pangu's two stage shapes, FengWu's 72/64 window
and one bias table for every window, and twice for equal bits.

K1's replay takes its two LayerNorms on a Function of their own on the
card too: its plain version, ``reference_layernorm_backward``, is held to
autograd through ``_layernorm_f32`` and to JAX's ``jax.vjp`` of its
LayerNorm at C 192, 384, 1152 and 1536 in f32 and bf16, with a constant row
whose variance the clip at 0 raises.  On the card every K1 case's replay
runs the LayerNorm kernels, whose dx and h round once from f32 values the
composition rounds in another order: K1's cases whose attention backward
is plain are held to the bf16 plain version's gradients within 2⁻⁶ of
each gradient's largest element (four bf16 ulps of it) in place of
1e-5·max|g|.  The kernel itself against f32 autograd at Pangu's two stage
shapes, FengWu's and FuXi V1's widths, twice for equal bits, and refusing
rows it does not take.

JAX is imported inside the CPU tests only: the card's machine has no JAX.
"""

import contextlib
import math
import types

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import flash_window_attention as FWA
from skyrim_tpu_torch.ops import vjp as VJP
from skyrim_tpu_torch.ops import fused_block as FB
from skyrim_tpu_torch.ops import fused_mlp as FM
from skyrim_tpu_torch.ops import graph_kernels as GK
from skyrim_tpu_torch.ops import resample as RS
from skyrim_tpu_torch.ops.roll import plain_roll3d, roll3d, shift_roll
from skyrim_tpu_torch.ops.windows import shift_attention_mask

WINDOW = (2, 6, 12)


class Const:
    """A float input that neither package differentiates (K1's shift mask)."""

    def __init__(self, a):
        self.a = a


def _n(rng, *shape, s=1.0):
    return (rng.normal(size=shape) * s).astype(np.float32)


# --- the cases: (args, the indices of the args in the compute dtype) -------------------


def _k1(shifted, C=32, heads=4):
    from test_torch_ops import _block_inputs

    Z, H, Wd = (4, 12, 24) if C <= 64 else (2, 6, 12)
    a = _block_inputs(shifted, Z=Z, H=H, Wd=Wd, C=C, heads=heads, valid=(Z - 1, H - 1, Wd))
    mask = None if a["mask"] is None else Const(a["mask"])
    return (a["x"], a["ln1"], a["qkv_wb"], a["bias"], mask, a["proj_wb"], a["ln2"], a["mlp_wb"], WINDOW, heads), (0,)


def _k3(H):
    rng = np.random.default_rng(5)
    C, N = 16, 32
    ln = (1 + _n(rng, 4 * C, s=0.1), _n(rng, 4 * C, s=0.3))
    return (_n(rng, 2, H, 8, C), ln, (_n(rng, 4 * C, N, s=(4 * C) ** -0.5), _n(rng, N, s=0.1))), (0,)


def _k4():
    rng = np.random.default_rng(6)
    C, Co = 32, 16
    return (_n(rng, 2, 5, 6, C), (_n(rng, C, 4 * Co, s=C**-0.5), _n(rng, 4 * Co, s=0.1)),
            (1 + _n(rng, Co, s=0.1), _n(rng, Co, s=0.1))), (0,)


def _k6(case):
    from test_torch_graph import MLP_CASES, _mlp_inputs

    a, xt = _mlp_inputs(MLP_CASES[case])
    return (a["x"], a["w1b1"], a["w2b2"], a["ln"], a["x2"], a["residual"], xt), (0, 4, 5)


def _k12():
    from test_torch_messages import FINISH_CASES, _finish_inputs

    assert "n300_l32_cout48" in FINISH_CASES
    return _finish_inputs("n300_l32_cout48"), (0,)


def _k7():
    from test_torch_graph import _round_inputs

    return _round_inputs(layout="unsorted"), (0, 1, 2)


def _k8():
    from test_torch_graph import _m2g_inputs

    return _m2g_inputs(), (0, 2, 3)


def _k9():
    from test_torch_graph import _g2m_inputs

    return _g2m_inputs()[0], (0, 1)


def _k13():
    from test_torch_messages import _fixed_inputs

    return _fixed_inputs("n300_deg3"), (0, 1, 2)


def _k14():
    from test_torch_messages import _block_inputs

    return _block_inputs("unsorted"), (0, 1)


def _jax_k(name):
    def get():
        import skyrim_tpu.ops.fused_block as jfb
        import skyrim_tpu.ops.fused_mlp as jfm
        import skyrim_tpu.ops.graph_kernels as jgk
        import skyrim_tpu.ops.resample as jrs
        import skyrim_tpu.ops.roll as jroll

        return {
            "K1": jfb.fused_swin_block_4d, "K2": jroll.roll3d, "K3": jrs.fused_downsample,
            "K4": jrs.fused_upsample, "K6": jfm.fused_mlp, "K12": jfm.fused_finish,
            "K7": jgk.fused_round_messages, "K8": jgk.fused_m2g_tiled, "K9": jgk.fused_g2m_tiled,
            "K13": jgk.fused_fixed_degree_messages, "K14": jgk.fused_block_messages,
        }[name]  # fmt: skip

    return get


def _k2():
    rng = np.random.default_rng(4)
    return (_n(rng, 4, 9, 24, 16), (1, 3, 6)), (0,)


CASES = {
    # id: (kernel, port wrapper, inputs)
    "K1_unshifted": ("K1", FB.fused_swin_block, lambda: _k1(False)),
    "K1_shifted": ("K1", FB.fused_swin_block, lambda: _k1(True)),
    "K1_chain_width": ("K1", FB.fused_swin_block, lambda: _k1(True, C=520, heads=4)),
    "K1_wide_width": ("K1", FB.fused_swin_block, lambda: _k1(True, C=576, heads=9)),
    "K2": ("K2", roll3d, _k2),
    "K3_even": ("K3", RS.fused_downsample, lambda: _k3(6)),
    "K4": ("K4", RS.fused_upsample, _k4),
    "K6_x2_residual": ("K6", FM.fused_mlp, lambda: _k6("x2_residual")),
    "K6_transposed": ("K6", FM.fused_mlp, lambda: _k6("transposed")),
    "K6_head": ("K6", FM.fused_mlp, lambda: _k6("head_cout83")),
    "K7": ("K7", GK.fused_round_messages, _k7),
    "K8": ("K8", GK.fused_m2g_tiled, _k8),
    "K9": ("K9", GK.fused_g2m_tiled, _k9),
    "K12": ("K12", FM.fused_finish, _k12),
    "K13": ("K13", GK.fused_fixed_degree_messages, _k13),
    "K14": ("K14", GK.fused_block_messages, _k14),
}


# --- the two packages' gradients ---------------------------------------------------


def _map(a, leaf):
    """``a`` with each array leaf replaced by ``leaf(array, is_const)``."""
    if isinstance(a, Const):
        return leaf(a.a, True)
    if isinstance(a, np.ndarray):
        return leaf(a, False)
    if isinstance(a, (tuple, list)):
        return type(a)(_map(v, leaf) for v in a)
    return a


def _torch_args(args, act, dtype, device="cpu"):
    """Torch inputs: float leaves of the activation args in ``dtype``, the
    rest f32, each requiring a gradient unless constant; int tables int32."""
    leaves = []

    def conv(i):
        def leaf(a, const):
            if a.dtype.kind in "iu":
                return torch.from_numpy(a.astype(np.int32)).to(device)
            t = torch.from_numpy(a).to(device, dtype if i in act else torch.float32)
            if not const:
                t.requires_grad_(True)
                leaves.append(t)
            return t

        return leaf

    return tuple(_map(a, conv(i)) for i, a in enumerate(args)), leaves


def _cotangents(out, seed=9):
    rng = np.random.default_rng(seed)
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(rng.normal(size=tuple(o.shape)).astype(np.float32) for o in outs)


def _port_grads(fn, args, act, dtype, cots=None):
    targs, leaves = _torch_args(args, act, dtype)
    out = fn(*targs)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.requires_grad and o.grad_fn is not None for o in outs), "the result is cut from the graph"
    cots = cots or _cotangents(out)
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    return [g.float().numpy() for g in torch.autograd.grad(loss, leaves)], cots


def _jax_grads(jfn, args, act, dtype, cots):
    import jax
    import jax.numpy as jnp

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    diff = []

    def collect(i):
        def leaf(a, const):
            if a.dtype.kind in "iu":
                return jnp.asarray(a)
            v = jnp.asarray(a, jdt if i in act else jnp.float32)
            if not const:
                diff.append(v)
                return ("diff", len(diff) - 1)
            return v

        return leaf

    skeleton = tuple(_map(a, collect(i)) for i, a in enumerate(args))

    def fill(s, vals):
        if isinstance(s, tuple) and len(s) == 2 and s[0] == "diff":
            return vals[s[1]]
        if isinstance(s, (tuple, list)):
            return type(s)(fill(v, vals) for v in s)
        return s

    def loss(vals):
        out = jfn(*fill(skeleton, vals), interpret=True)
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o.astype(jnp.float32) * c).sum() for o, c in zip(outs, cots))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss)(diff)]


def _golden_misses(out, ref):
    """What misses the golden tolerance tol = 3e-2·std(ref)
    (tests/test_golden.py:74) on the mean, the spread and the RMS of the
    difference, 10·tol elementwise: the tolerance the bf16 forwards of these
    kernels are held to JAX's at (tests/test_torch_graph.py)."""
    out, ref = out.astype(np.float64), ref.astype(np.float64)
    tol = 3e-2 * ref.std()
    d = out - ref
    stats = {"mean": abs(out.mean() - ref.mean()), "spread": abs(out.std() - ref.std()),
             "rms": np.sqrt((d**2).mean()), "max": np.abs(d).max() / 10}
    return {k: v for k, v in stats.items() if not v < tol}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gradients_match_jax(case, dtype):
    pytest.importorskip("jax")
    name, fn, make = CASES[case]
    args, act = make()
    grads, cots = _port_grads(fn, args, act, dtype)
    ref = _jax_grads(_jax_k(name)(), args, act, dtype, cots)
    assert len(grads) == len(ref)
    if dtype == torch.float32:
        for i, (g, r) in enumerate(zip(grads, ref)):
            assert g.shape == r.shape, (i, g.shape, r.shape)
            np.testing.assert_allclose(g, r, atol=3e-5, rtol=1e-4, err_msg=f"{case} input {i}")
        return
    # bf16: where JAX's bf16 gradient misses its own f32 one (XLA on the CPU
    # sums the gradient of a bf16-cast bias over the rows in bf16; PyTorch
    # accumulates in f32), the port's is held to JAX's f32 gradient
    ref32 = _jax_grads(_jax_k(name)(), args, act, torch.float32, cots)
    for i, (g, r, r32) in enumerate(zip(grads, ref, ref32)):
        if _golden_misses(g, r):
            assert _golden_misses(r, r32), (case, i, _golden_misses(g, r))
            assert not _golden_misses(g, r32), (case, i, _golden_misses(g, r32))


def test_backward_replays_the_plain_version_and_launches_nothing():
    """On the CPU the Function's gradient is autograd's through the plain
    composition, bit for bit, and no kernel counter moves."""
    args, act = _k1(True)

    def counts():
        bwd = FB.window_attention_backward
        return FB.fused_swin_block.launches, roll3d.launches, bwd.launches, dict(bwd.launches_by_body)

    before = counts()
    grads, cots = _port_grads(FB.fused_swin_block, args, act, torch.float32)
    plain, _ = _port_grads(lambda *a: FB.reference_swin_block(*a) * 1.0, args, act, torch.float32, cots)
    for g, p in zip(grads, plain):
        np.testing.assert_array_equal(g, p)
    assert counts() == before


def test_plain_forwards_replays_the_plain_version():
    """A wrapper's own ``replay`` is what its backward differentiates, except
    inside ``plain_forwards()``, where the plain version is."""
    seen = []

    def replay(t):
        seen.append("replay")
        return t * 2

    x = torch.ones(3, requires_grad=True)
    for block, want in ((contextlib.nullcontext(), ["replay"]), (VJP.plain_forwards(), [])):
        seen.clear()
        with block:
            y = VJP.with_plain_vjp(lambda t: t * 2, lambda t: t * 2, x, replay=replay)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert seen == want
        torch.testing.assert_close(g, torch.full((3,), 2.0), rtol=0, atol=0)


@pytest.mark.parametrize("grad", [False, True], ids=["serving", "training"])
def test_wrappers_keep_no_reference_to_their_inputs(grad):
    """After a call, nothing of the Function holds its inputs: with the
    garbage collector off, an input dies when its caller drops it, as
    before the Functions (an ensemble member's parameters are given back
    to the card by dropping them, ``core.model.GlobalModel.release_model``)."""
    import gc
    import weakref

    args, act = _k1(True)
    targs = _torch_args(args, act, torch.float32)[0]
    gc.disable()
    try:
        weight = weakref.ref(targs[2][0])
        with torch.set_grad_enabled(grad):
            rolled = roll3d(FB.fused_swin_block(*targs), (1, 3, 6))
            if grad:
                rolled.sum().backward()
        del rolled, targs
        assert weight() is None
    finally:
        gc.enable()


def test_k2_backward_is_the_opposite_roll():
    x = torch.randn(4, 9, 24, 16, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: roll3d(t, (1, 3, 6)), (x,))
    g = torch.randn(4, 9, 24, 16, dtype=torch.float64)
    (grad,) = torch.autograd.grad(roll3d(x, (3, 8, 23)), x, g)
    torch.testing.assert_close(grad, plain_roll3d(g, (-3, -8, -23)), rtol=0, atol=0)
    y = shift_roll(shift_roll(x, (1, 3, 6), True), (1, 3, 6), False)
    torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_prepared_operands_get_no_gradient():
    """K3 and K4 with the cached operands of ``prepare_*`` differentiate the
    raw (ln, wb), as without them."""
    args, act = _k3(6)
    x, ln, wb = (_torch_args(args, act, torch.float32)[0])
    with torch.no_grad():
        prepared = RS.prepare_downsample(ln, wb)
    gx1, gw1 = torch.autograd.grad(RS.fused_downsample(x, ln, wb, prepared).sum(), (x, wb[0]))
    gx2, gw2 = torch.autograd.grad(RS.fused_downsample(x, ln, wb).sum(), (x, wb[0]))
    torch.testing.assert_close(gx1, gx2, rtol=0, atol=0)
    torch.testing.assert_close(gw1, gw2, rtol=0, atol=0)


# --- K5, K10, K11: no VJP -----------------------------------------------------------------


def _attention_inputs(device, requires_grad):
    Z, H, Wd, C, heads = 2, 6, 12, 16, 2
    wlen, nw = 144, 1
    kw = dict(device=device, dtype=torch.bfloat16)
    qkv4 = torch.randn(Z, H, Wd, 3 * C, **kw).requires_grad_(requires_grad)
    rows = torch.randn(nw, wlen, 3 * C, **kw).requires_grad_(requires_grad)
    q, k, v = (torch.randn(nw, heads, wlen, C // heads, **kw).requires_grad_(requires_grad) for _ in range(3))
    bias = torch.randn(1, heads, wlen, wlen, device=device)
    return {
        "K5": lambda: FWA.fused_window_attention_4d(qkv4, bias, None, WINDOW, heads),
        "K10": lambda: FWA.fused_window_attention(rows, bias, None, nw, heads),
        "K11": lambda: FWA.flash_window_attention(q, k, v, bias, None, nw),
    }, (qkv4, rows, q)


@pytest.mark.parametrize("kernel", ["K5", "K10", "K11"])
def test_attention_without_vjp_refuses_a_gradient_off_the_cpu(kernel):
    calls, _ = _attention_inputs("meta", True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item 9"):
        calls[kernel]()


@pytest.mark.parametrize("kernel", ["K5", "K10", "K11"])
def test_attention_plain_versions_stay_differentiable(kernel):
    calls, (qkv4, rows, q) = _attention_inputs("cpu", True)
    out = calls[kernel]()
    (g,) = torch.autograd.grad(out.float().sum(), {"K5": qkv4, "K10": rows, "K11": q}[kernel])
    assert torch.isfinite(g.float()).all() and g.abs().sum() > 0


# --- K1's attention backward ------------------------------------------------------------

# id: (window, heads, hd, (Z, H, W), shift): Pangu's window (wlen 144, hd 32) with four bias types,
# FuXi's and FengWu's (wlen 72, padded to 80 on the card, hd 64) with two; both under a shift mask
ATTENTION_BACKWARD = {
    "pangu": ((2, 6, 12), 2, 32, (4, 12, 24), (1, 3, 6)),
    "padded": ((1, 6, 12), 2, 64, (1, 12, 24), (0, 3, 6)),
}


def _attention_backward_inputs(case, seed=3):
    window, heads, hd, dims, shift = ATTENTION_BACKWARD[case]
    rng = np.random.default_rng(seed)
    (Z, H, Wd), C, wlen = dims, heads * hd, math.prod(window)
    mask = shift_attention_mask(dims, window, shift, (Z - (window[0] > 1), H - 1, Wd))
    assert mask is not None
    n_types = Z // window[0] * (H // window[1])
    return (_n(rng, Z, H, Wd, 3 * C), _n(rng, n_types, heads, wlen, wlen, s=0.5), mask, _n(rng, Z, H, Wd, C),
            window, heads)


@pytest.mark.parametrize("case", sorted(ATTENTION_BACKWARD))
def test_attention_backward_matches_autograd_and_jax(case):
    """The closed form K1's attention backward implements, against autograd
    through the plain attention and against JAX's ``jax.vjp`` of its
    reference; on the CPU the wrapper is that plain version and counts
    nothing."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from skyrim_tpu.ops import windows as JW
    from skyrim_tpu.ops.flash_window_attention import reference_window_attention_qkv

    qkv, bias, mask, dout, window, heads = _attention_backward_inputs(case)
    tq, tb, tm, td = (torch.from_numpy(a) for a in (qkv, bias, mask, dout))
    got = FB.reference_window_attention_backward(tq, tb, tm, td, window, heads)
    leaves = (tq.clone().requires_grad_(True), tb.clone().requires_grad_(True))
    out = FWA.reference_window_attention_4d(*leaves, tm, window, heads)
    want = torch.autograd.grad(out, leaves, td)
    Z, H, Wd = qkv.shape[:3]

    def jfn(q, b):
        o = reference_window_attention_qkv(JW.window_partition(q, window), b, jnp.asarray(mask), Wd // window[2], heads)
        return JW.window_reverse(o, window, (Z, H, Wd))

    _, vjp = jax.vjp(jfn, jnp.asarray(qkv), jnp.asarray(bias))
    jgot = vjp(jnp.asarray(dout))
    for name, g, w, j in zip(("dqkv", "dbias"), got, want, jgot):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=3e-5, rtol=1e-4, err_msg=f"{case} {name}, autograd")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=3e-5, rtol=1e-4, err_msg=f"{case} {name}, JAX")
    bwd = FB.window_attention_backward
    before = bwd.launches, dict(bwd.launches_by_body)
    for g, r in zip(bwd(tq, tb, tm, td, window, heads), got):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (bwd.launches, bwd.launches_by_body) == before


@pytest.mark.parametrize("wlen, hd, body", [
    (144, 32, "registers"), (144, 8, "registers"), (129, 24, "registers"), (72, 64, "registers"),
    (80, 40, "registers"), (144, 64, "plain"), (144, 12, "plain"), (128, 32, "plain"), (72, 32, "plain"),
    (72, 72, "plain"), (16, 8, "plain"),
])  # fmt: skip
def test_attention_backward_body_by_shape(wlen, hd, body):
    """The register body's two geometries, hd a multiple of 8, take the
    kernel; any other window keeps the plain replay."""
    assert FB.attention_backward_body(wlen, hd) == body


# --- K1's LayerNorm backward -------------------------------------------------------------

# a constant f32 row whose fast variance E[x²] − E[x]² both PyTorch's and JAX's f32 sums round below 0, so
# the clip at 0 engages (by C); rounded to bf16, a constant row sums exactly and its variance is 0
CLIPPED_ROW = {192: 0.1613, 384: 0.0871, 1152: 0.0871, 1536: 0.0871}


def _layernorm_backward_inputs(C, seed=11):
    rng = np.random.default_rng(seed)
    x = _n(rng, 2, 3, C, s=2.0) + 0.5
    x[1, 2] = CLIPPED_ROW[C]
    return x, 1 + _n(rng, C, s=0.1), _n(rng, C, s=0.1), _n(rng, 2, 3, C)


@pytest.mark.parametrize("C", sorted(CLIPPED_ROW))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_layernorm_backward_matches_autograd_and_jax(C, dtype):
    """The closed form K1's replayed LayerNorms take on the card, against
    autograd through ``_layernorm_f32`` and JAX's ``jax.vjp`` of its
    ``_layernorm_f32``, each cast to the input's dtype, at Pangu's, FengWu's
    and FuXi V1's widths: the affine's gradients in f32 at atol 3e-5, rtol
    1e-4, dx there in f32 and within one bf16 ulp in bf16 (each rounds an
    f32 dx once); on the CPU the wrapper is that plain version and counts
    nothing."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from skyrim_tpu.ops.fused_block import _layernorm_f32 as jax_layernorm
    from skyrim_tpu_torch.ops.gemm import _layernorm_f32

    x, scale, bias, dy = _layernorm_backward_inputs(C)
    tx, td = (torch.from_numpy(a).to(dtype) for a in (x, dy))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    if dtype == torch.float32:  # the clip engages in the constant row
        row = tx[1, 2]
        assert float((row * row).mean() - row.mean() * row.mean()) < 0
    got = FB.reference_layernorm_backward(tx, ts, tb, td)
    leaves = tuple(t.clone().requires_grad_(True) for t in (tx, ts, tb))
    want = torch.autograd.grad(_layernorm_f32(*leaves).to(dtype), leaves, td)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    _, vjp = jax.vjp(lambda a, s, b: jax_layernorm(a, s[None], b[None]).astype(jdt), jnp.asarray(x, jdt),
                     jnp.asarray(scale), jnp.asarray(bias))
    jgot = vjp(jnp.asarray(dy, jdt))
    dx_tol = dict(atol=3e-5, rtol=1e-4) if dtype == torch.float32 else dict(atol=1e-6, rtol=2**-7)
    for name, g, w, j, dt in zip(("dx", "dscale", "dbias"), got, want, jgot, (dtype, torch.float32, torch.float32)):
        assert g.shape == w.shape and g.dtype == dt, name
        tol = dx_tol if name == "dx" else dict(atol=3e-5, rtol=1e-4)
        g = g.float().numpy()
        np.testing.assert_allclose(g, w.float().numpy(), **tol, err_msg=f"{C} {dtype} {name}, autograd")
        np.testing.assert_allclose(g, np.asarray(j.astype(jnp.float32)), **tol, err_msg=f"{C} {dtype} {name}, JAX")
    bwd = FB.layernorm_backward
    before = bwd.launches, dict(bwd.launches_by_body)
    for g, r in zip(bwd(tx, ts, tb, td), got):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (bwd.launches, bwd.launches_by_body) == before


@pytest.mark.parametrize("C, dtype, device, body", [
    (192, torch.bfloat16, "cuda", "kernel"), (384, torch.bfloat16, "cuda", "kernel"),
    (1152, torch.bfloat16, "cuda", "kernel"), (1536, torch.bfloat16, "cuda", "kernel"),
    (8, torch.bfloat16, "cuda", "kernel"), (1544, torch.bfloat16, "cuda", "plain"), (100, torch.bfloat16, "cuda", "plain"),
    (192, torch.float32, "cuda", "plain"), (192, torch.bfloat16, "cpu", "plain"), (192, torch.bfloat16, "meta", "plain"),
])  # fmt: skip
def test_layernorm_backward_body_by_shape(C, dtype, device, body):
    """bf16 rows on the card of C % 8 == 0 up to 1536 take the kernel; f32
    rows, other widths and other devices keep autograd through
    ``_layernorm_f32``.  (Decided from what the tensor shows; a stand-in
    carries a CUDA device without a card.)"""
    x = types.SimpleNamespace(shape=(4, 3, C), dtype=dtype, device=torch.device(device))
    assert FB.layernorm_backward_body(x) == body


def test_replay_on_the_cpu_keeps_the_plain_layernorm():
    """On the CPU K1's backward replay takes ``_layernorm_f32`` for both of
    its LayerNorms, counted as ``"plain"``, and launches nothing."""
    args, act = _k1(True)
    bwd = FB.layernorm_backward
    before = bwd.launches, dict(bwd.launches_by_body)
    grads, _ = _port_grads(FB.fused_swin_block, args, act, torch.bfloat16)
    assert all(np.isfinite(g).all() for g in grads)
    assert bwd.launches == before[0]
    assert bwd.launches_by_body.get("plain", 0) == before[1].get("plain", 0) + 2
    assert bwd.launches_by_body.get("kernel", 0) == before[1].get("kernel", 0)


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


PLAIN = {
    "K1": FB.reference_swin_block, "K2": plain_roll3d, "K3": RS._plain_downsample, "K4": RS._plain_upsample,
    "K6": FM.reference_mlp, "K12": FM._plain_finish, "K7": GK.reference_round_messages,
    "K8": GK.reference_m2g_tiled, "K9": GK._plain_g2m_tiled, "K13": GK.reference_fixed_degree_messages,
    "K14": GK.reference_block_messages,
}  # fmt: skip
CARD_CASES = sorted(c for c in CASES if c not in ("K1_chain_width", "K1_wide_width")) + ["K1_chain", "K1_wide"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_gradients_match_plain(cuda, case):
    if case == "K1_chain":
        name, fn, (args, act) = "K1", FB.fused_swin_block, _k1(True, C=528, heads=4)
        assert FB.block_path(528) == "chain"
    elif case == "K1_wide":
        name, fn, (args, act) = "K1", FB.fused_swin_block, _k1(True, C=576, heads=9)
        assert FB.block_path(576) == "wide"
    else:
        name, fn, make = CASES[case]
        args, act = make()
    # K1's replay differentiates its attention by the backward kernel where that takes the window: the
    # kernel rounds P and dS to bf16 as operands, so its gradients are held to the f32 plain version's
    body = FB.attention_backward_body(math.prod(args[8]), args[0].shape[-1] // args[9]) if name == "K1" else None
    before = dict(FB.window_attention_backward.launches_by_body)
    ln_before = FB.layernorm_backward.launches
    runs = [(fn, torch.bfloat16), (PLAIN[name], torch.bfloat16)]
    if body == "registers":
        runs.append((PLAIN[name], torch.float32))
    grads = []
    for f, dtype in runs:
        targs, leaves = _torch_args(args, act, dtype, cuda)
        out = f(*targs)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.grad_fn is not None for o in outs)
        cots = [torch.from_numpy(c).to(cuda) for c in _cotangents(tuple(o.cpu() for o in outs))]
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        grads.append([g.float() for g in torch.autograd.grad(loss, leaves)])
    if body is not None:
        counts = FB.window_attention_backward.launches_by_body
        assert counts.get(body, 0) == before.get(body, 0) + 1, (case, body, counts)
        assert FB.layernorm_backward.launches == ln_before + 2, case
    for g, p, *exact in zip(*grads):
        if body == "registers":
            # where the kernel path misses the f32 gradient, the bf16 plain path misses it as well, by at
            # least 1/1.25 as much (the earth bias's gradient sums the score gradients of a type's windows,
            # which the bf16 forward's q and k already move)
            misses = _golden_misses(g.cpu().numpy(), exact[0].cpu().numpy())
            floor = _golden_misses(p.cpu().numpy(), exact[0].cpu().numpy())
            assert all(k in floor and v <= 1.25 * floor[k] for k, v in misses.items()), (case, misses, floor)
            continue
        tol = 0.0 if name == "K2" else 1e-5 * float(p.abs().max())
        if name == "K1":
            # the replay's LayerNorms on their kernels: their dx and h round once from f32 values that the
            # composition rounds from in another order, and the bf16 products behind them carry a one-ulp
            # change on to every gradient at the scale of its largest element (up to 1.5 bf16 ulps of it on
            # an H100), so K1's gradients are held to within four such ulps
            tol = 2**-6 * float(p.abs().max())
        assert float((g - p).abs().max()) <= tol, case


# id: ((Z, H, W), window, heads, hd, shift or None for no mask, valid H, one bias table for every window)
CARD_ATTENTION_BACKWARD = {
    "pangu_stage1": ((8, 186, 360), (2, 6, 12), 6, 32, (1, 3, 6), 181, False),
    "pangu_stage2": ((8, 96, 180), (2, 6, 12), 12, 32, (1, 3, 6), 91, False),
    "fengwu_72_64": ((1, 186, 360), (1, 6, 12), 18, 64, (0, 3, 6), 181, False),
    "one_table": ((8, 96, 180), (2, 6, 12), 12, 32, None, 96, True),
}


def _card_attention_backward_inputs(case, device):
    dims, window, heads, hd, shift, valid_h, one_table = CARD_ATTENTION_BACKWARD[case]
    g = torch.Generator(device=device).manual_seed(0)
    (Z, H, Wd), C, wlen = dims, heads * hd, math.prod(window)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=device) * s

    bias = randn(1 if one_table else Z // window[0] * (H // window[1]), heads, wlen, wlen, s=0.5)
    bias = bias[0] if one_table else bias  # one table: 3-D
    mask = None if shift is None else shift_attention_mask(dims, window, shift, (Z, valid_h, Wd))
    mask = None if mask is None else torch.from_numpy(mask).to(device)
    return (randn(Z, H, Wd, 3 * C).to(torch.bfloat16), bias, mask, randn(Z, H, Wd, C).to(torch.bfloat16),
            window, heads)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_ATTENTION_BACKWARD))
def test_card_attention_backward_matches_f32_autograd(cuda, case):
    """K1's attention backward kernel (Pangu's two stage shapes, FengWu's
    wlen 72 padded to 80 with hd 64, and one bias table for every window,
    whose rows are cut into runs) against f32 autograd through the plain
    attention on the same bf16 values, at the golden tolerance."""
    qkv, bias, mask, dout, window, heads = _card_attention_backward_inputs(case, cuda)
    before = FB.window_attention_backward.launches
    got = FB.window_attention_backward(qkv, bias, mask, dout, window, heads)
    assert FB.window_attention_backward.launches == before + 1
    leaves = (qkv.float().requires_grad_(True), bias.clone().requires_grad_(True))
    want = torch.autograd.grad(FWA.reference_window_attention_4d(*leaves, mask, window, heads), leaves, dout.float())
    for name, g, w, dt in zip(("dqkv", "dbias"), got, want, (torch.bfloat16, torch.float32)):
        assert g.shape == w.shape and g.dtype == dt, (case, name)
        misses = _golden_misses(g.float().cpu().numpy(), w.cpu().numpy())
        assert not misses, (case, name, misses)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pangu_stage2", "one_table"])
def test_card_attention_backward_is_repeatable(cuda, case):
    """Two calls on the same inputs give the same bits: dbias is summed in a
    fixed order, with no float atomics."""
    args = _card_attention_backward_inputs(case, cuda)
    first, second = FB.window_attention_backward(*args), FB.window_attention_backward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b), case


# id: (rows, C): Pangu's two stages, FengWu's fuser, FuXi V1's trunk
CARD_LAYERNORM_BACKWARD = {
    "pangu_stage1": (535_680, 192), "pangu_stage2": (138_240, 384), "fengwu": (66_960, 1152), "fuxi_v1": (17_280, 1536),
}  # fmt: skip


def _card_layernorm_backward_inputs(case, device):
    rows, C = CARD_LAYERNORM_BACKWARD[case]
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    return ((randn(rows, C) * 2 + 0.5).to(torch.bfloat16), 1 + 0.1 * randn(C), 0.1 * randn(C),
            randn(rows, C).to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_LAYERNORM_BACKWARD))
def test_card_layernorm_backward_matches_f32_autograd(cuda, case):
    """The LayerNorm backward kernel against f32 autograd through
    ``_layernorm_f32`` on the same bf16 values: dx within half a bf16 ulp
    (its one rounding) plus 1e-5 of the largest element, the affine's
    gradients (f32 sums over every row) within 1e-4 of their largest."""
    from skyrim_tpu_torch.ops.gemm import _layernorm_f32

    x, scale, bias, dy = _card_layernorm_backward_inputs(case, cuda)
    before = FB.layernorm_backward.launches
    got = FB.layernorm_backward(x, scale, bias, dy)
    assert FB.layernorm_backward.launches == before + 1
    leaves = (x.float().requires_grad_(True), scale.clone().requires_grad_(True), bias.clone().requires_grad_(True))
    want = torch.autograd.grad(_layernorm_f32(*leaves), leaves, dy.float())
    for name, g, w, dt in zip(("dx", "dscale", "dbias"), got, want, (torch.bfloat16, torch.float32, torch.float32)):
        assert g.shape == w.shape and g.dtype == dt, (case, name)
        err, ref = (g.float() - w).abs(), w.abs()
        limit = 2**-8 * ref + 1e-5 * ref.max() if name == "dx" else 1e-4 * ref.max()
        assert bool((err <= limit).all()), (case, name, float((err / limit).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["pangu_stage1", "fuxi_v1"])
def test_card_layernorm_backward_is_repeatable(cuda, case):
    """Two calls on the same inputs give the same bits: the affine's
    gradients are summed in a fixed order, with no float atomics."""
    args = _card_layernorm_backward_inputs(case, cuda)
    first, second = FB.layernorm_backward(*args), FB.layernorm_backward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b), case


@pytest.mark.gpu
def test_card_layernorm_backward_refuses_rows_it_does_not_take(cuda):
    """An odd width, rows wider than 1536 and f32 rows raise on the card."""
    for C, dtype in ((100, torch.bfloat16), (1544, torch.bfloat16), (192, torch.float32)):
        x = torch.randn(64, C, device=cuda).to(dtype)
        ln = (torch.ones(C, device=cuda), torch.zeros(C, device=cuda))
        with pytest.raises(ValueError, match="layernorm_backward"):
            FB.layernorm_backward(x, *ln, torch.randn_like(x))


@pytest.mark.gpu
def test_card_k2_backward_launches_k2(cuda):
    x = torch.randn(4, 12, 24, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    before = roll3d.launches
    y = roll3d(x, (1, 3, 6))
    assert roll3d.launches == before + 1
    g = torch.randn_like(y)
    (grad,) = torch.autograd.grad(y, x, g)
    assert roll3d.launches == before + 2
    torch.testing.assert_close(grad, plain_roll3d(g, (-1, -3, -6)), rtol=0, atol=0)


@pytest.mark.gpu
def test_card_attention_refuses_a_gradient(cuda):
    calls, _ = _attention_inputs(cuda, True)
    for kernel, call in calls.items():
        with pytest.raises(NotImplementedError, match="item 9"):
            call()

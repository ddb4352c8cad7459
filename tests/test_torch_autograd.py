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

On the card (marker ``gpu``): each Function's gradients against autograd
through its plain version on the same card tensors, within 1e-5·max|g|
(the backward replays that composition; scatter sums may add in another
order), K2's exactly, and K2's backward a K2 launch.

JAX is imported inside the CPU tests only: the card's machine has no JAX.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.ops import flash_window_attention as FWA
from skyrim_tpu_torch.ops import fused_block as FB
from skyrim_tpu_torch.ops import fused_mlp as FM
from skyrim_tpu_torch.ops import graph_kernels as GK
from skyrim_tpu_torch.ops import resample as RS
from skyrim_tpu_torch.ops.roll import plain_roll3d, roll3d, shift_roll

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
    counts = (FB.fused_swin_block.launches, roll3d.launches)
    grads, cots = _port_grads(FB.fused_swin_block, args, act, torch.float32)
    plain, _ = _port_grads(lambda *a: FB.reference_swin_block(*a) * 1.0, args, act, torch.float32, cots)
    for g, p in zip(grads, plain):
        np.testing.assert_array_equal(g, p)
    assert (FB.fused_swin_block.launches, roll3d.launches) == counts


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
CARD_CASES = sorted(c for c in CASES if c != "K1_chain_width") + ["K1_chain"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_gradients_match_plain(cuda, case):
    if case == "K1_chain":
        name, fn, (args, act) = "K1", FB.fused_swin_block, _k1(True, C=528, heads=4)
        assert FB.block_path(528) == "chain"
    else:
        name, fn, make = CASES[case]
        args, act = make()
    grads = []
    for f in (fn, PLAIN[name]):
        targs, leaves = _torch_args(args, act, torch.bfloat16, cuda)
        out = f(*targs)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.grad_fn is not None for o in outs)
        cots = [torch.from_numpy(c).to(cuda) for c in _cotangents(tuple(o.cpu() for o in outs))]
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        grads.append([g.float() for g in torch.autograd.grad(loss, leaves)])
    for g, p in zip(*grads):
        tol = 0.0 if name == "K2" else 1e-5 * float(p.abs().max())
        assert float((g - p).abs().max()) <= tol, case


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

"""The port's int8 module (skyrim_tpu_torch/quantize.py) against the JAX
package's skyrim_tpu/quantize.py, and FuXi's two int8 tiers.

The quantised leaves and scales must come out EQUAL to JAX's (the same f32
``amax / 127``, ``round`` half to even, clip to ±127), the at-rest tier's
scales shared by the stacked pairs and its stacked 2-D biases quantised
where they reach ``min_size``; ``int8_dot`` agrees to rtol 1e-6 (the same
int32 sums, rescaled in the same order).  FuXi's forwards under both tiers
match JAX's quantised forwards within the golden tolerance (3e-2·std,
tests/test_golden.py:74); each tier stays within the JAX tests' 0.15
mean |diff| / mean |bf16| of the bf16 forward (tests/test_quantize.py:102).
JAX is imported inside the tests: the card's machine runs only the
``gpu`` test.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch import quantize as Q
from skyrim_tpu_torch.models.fuxi import FuXiConfig, FuXiModel, stage_tree
from skyrim_tpu_torch.params import as_tensor, flatten, from_jax
from test_torch_fuxi import GOLDEN_CFG, _drawn
from test_torch_pangu import assert_golden_close


def _jq():
    pytest.importorskip("jax")
    from skyrim_tpu import quantize as JQ

    return JQ


def _assert_quantized_equal(out, ref):
    """Port tree (QuantizedTensor, tensors) == JAX tree (QuantizedArray,
    arrays): the same paths, the same quantized leaves, q and scale equal,
    the other leaves equal."""
    JQ = _jq()
    fo, fr = flatten(out), flatten(ref)
    assert sorted(fo) == sorted(fr), sorted(set(fo) ^ set(fr))[:8]
    for k, r in fr.items():
        o = fo[k]
        if isinstance(r, JQ.QuantizedArray):
            assert isinstance(o, Q.QuantizedTensor), k
            assert o.q.dtype == torch.int8 and o.scale.dtype == torch.float32, k
            assert torch.equal(o.q, as_tensor(np.asarray(r.q))), k
            assert torch.equal(o.scale, as_tensor(np.asarray(r.scale))), k
            assert str(o.dtype).replace("torch.", "") == str(np.dtype(r.dtype)), k
        else:
            assert not isinstance(o, Q.QuantizedTensor), k
            a, b = as_tensor(o), as_tensor(np.asarray(r))
            assert a.dtype == b.dtype and torch.equal(a, b), k


def _arrays(rng):
    """f32 and bf16 weights with a per-channel range, one channel all zero
    (its scale 1), a stacked (P, K, N) kernel and values on .5 boundaries."""
    w = (rng.normal(size=(96, 40)) * np.linspace(0.1, 10.0, 40)).astype(np.float32)
    w[:, 7] = 0.0
    half = (np.arange(-126, 126, dtype=np.float32) + 0.5)[:, None] * np.ones((1, 8), np.float32)
    half[0] = 127.0  # amax 127 → scale 1, so the other values sit on .5
    return {"w": w, "stacked": rng.normal(size=(3, 24, 16)).astype(np.float32), "half": half}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_array_equals_jax(dtype):
    JQ = _jq()
    import jax.numpy as jnp

    for name, a in _arrays(np.random.default_rng(0)).items():
        ja = jnp.asarray(a, getattr(jnp, dtype))
        ta = as_tensor(np.asarray(ja))
        for axis in (-1, 0):
            out, ref = Q.quantize_array(ta, axis), JQ.quantize_array(ja, axis)
            assert torch.equal(out.q, as_tensor(np.asarray(ref.q))), (name, axis)
            assert torch.equal(out.scale, as_tensor(np.asarray(ref.scale))), (name, axis)
            assert out.dtype == ta.dtype
            back, jback = Q.dequantize_array(out), np.asarray(JQ.dequantize_array(ref))
            assert torch.equal(back, as_tensor(jback)), (name, axis)
    half = torch.from_numpy(_arrays(np.random.default_rng(0))["half"])
    q = Q.quantize_array(half)
    assert float(q.scale[0, 0]) == 1.0 and float(half[126, 0]) == 0.5 and float(half[127, 0]) == 1.5
    assert int(q.q[126, 0]) == 0 and int(q.q[127, 0]) == 2  # half to even


def test_quantize_tree_equals_jax_and_counts_bytes():
    JQ = _jq()
    rng = np.random.default_rng(1)
    tree = {
        "big": rng.normal(size=(64, 48)).astype(np.float32),
        "bias": rng.normal(size=(48,)).astype(np.float32),
        "norm": {"mean": np.zeros((7, 1, 1), np.float32)},
        "stack": [rng.normal(size=(2, 40, 32)).astype(np.float32)],
    }
    ttree = {"big": torch.from_numpy(tree["big"]), "bias": torch.from_numpy(tree["bias"]),
             "norm": {"mean": torch.from_numpy(tree["norm"]["mean"])}, "stack": [torch.from_numpy(tree["stack"][0])]}
    out, ref = Q.quantize_tree(ttree, min_size=1024), JQ.quantize_tree(tree, min_size=1024)
    _assert_quantized_equal(out, ref)
    assert Q.is_quantized(out) and not Q.is_quantized(ttree)
    assert Q.tree_nbytes(out) == JQ.tree_nbytes(ref) and Q.tree_nbytes(ttree) == JQ.tree_nbytes(tree)
    back = Q.dequantize_tree(out)
    assert back["big"].dtype == torch.float32 and back["bias"] is ttree["bias"]
    assert Q.maybe_dequantize(ttree) is ttree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256), (2, 24, 256)])
def test_int8_dot_equals_jax(dtype, shape):
    """The same int8 operands, the same int32 sums (K 256), rescaled in the
    same order: rtol 1e-6.  Against JAX's function run op by op: under
    ``jax.jit`` XLA rewrites the division by the constant 127 into a
    multiply by its f32 reciprocal, which moves 4 % of the row scales by
    an ulp (and so a few bf16 outputs by one rounding)."""
    JQ = _jq()
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    xn = rng.normal(size=shape).astype(np.float32) * np.linspace(0.1, 4, shape[-2])[:, None]
    xn[..., 3, :] = 0.0  # a zero row: its scale 1
    x = jnp.asarray(xn, getattr(jnp, dtype))
    w = rng.normal(size=(256, 128)).astype(np.float32)
    ref = np.asarray(JQ.int8_dot(x, JQ.quantize_array(w)))
    out = Q.int8_dot(as_tensor(np.asarray(x)), Q.quantize_array(torch.from_numpy(w)))
    assert out.dtype == as_tensor(np.asarray(x)).dtype and tuple(out.shape) == (*shape[:-1], 128)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=1e-6, atol=0)


def test_int8_dot_exceeds_f32_integers():
    """At K 6144 the int32 sums pass 2**24: converted to f32 before the
    scales, as JAX does, so the results agree to rtol 1e-6."""
    JQ = _jq()
    rng = np.random.default_rng(3)
    x = np.sign(rng.normal(size=(20, 6144))).astype(np.float32)
    w = np.abs(rng.normal(size=(6144, 16))).astype(np.float32)
    w[0] = 10.0  # amax → most q near 127·|w|/10
    out = Q.int8_dot(torch.from_numpy(x), Q.quantize_array(torch.from_numpy(w)))
    ref = np.asarray(JQ.int8_dot(x, JQ.quantize_array(w)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


# --- FuXi's two tiers --------------------------------------------------------------


@pytest.fixture(scope="module")
def fuxi():
    """Golden FuXi, V2, depth 4 (2 stacked pairs), so the stacked biases
    (2, 48) reach min_size 64."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.fuxi import FuXiConfig as JConfig
    from skyrim_tpu.models.fuxi import FuXiModel as JModel

    cfg = dict(GOLDEN_CFG, depth=4, stage_steps=2)
    jmodel = JModel(JConfig(**cfg))
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), 0)
    model = FuXiModel(FuXiConfig(**cfg), device="cpu")
    return jmodel, tree, model, from_jax(tree, model)


def test_at_rest_tier_equals_jax(fuxi):
    """quantize_params at rest: every quantized leaf and scale equal to JAX's;
    one scale per output channel shared by the stacked pairs; the stacked
    qkv and Dense_0 biases quantized."""
    JQ = _jq()
    jmodel, tree, model, params = fuxi
    out = model.quantize_params(params, min_size=64)
    ref = jmodel.quantize_params(tree, min_size=64)
    _assert_quantized_equal(out["stages"], ref["stages"])
    a = out["stages"][0]["pairs"]["a"]
    assert tuple(a["qkv"]["kernel"].scale.shape) == (1, 1, 48)  # shared across the 2 pairs
    assert isinstance(a["qkv"]["bias"], Q.QuantizedTensor) and tuple(a["qkv"]["bias"].scale.shape) == (1, 48)
    assert isinstance(a["Dense_0"]["bias"], Q.QuantizedTensor) and not isinstance(a["proj"]["bias"], Q.QuantizedTensor)
    assert Q.tree_nbytes(out["stages"]) == JQ.tree_nbytes(ref["stages"])
    assert Q.tree_nbytes(out["stages"][0]) < Q.tree_nbytes(stage_tree(params["stages"][0]))


def test_serving_tier_equals_jax(fuxi):
    """serve_int8: the int8 collection (per-layer scales (P, 1, N), exact
    biases) and the rest at rest, equal to JAX's; the served kernels left
    the params tree."""
    JQ = _jq()
    jmodel, tree, model, params = fuxi
    out = model.quantize_params(params, min_size=64, serve_int8=True)
    ref = jmodel.quantize_params(tree, min_size=64, serve_int8=True)
    _assert_quantized_equal(out["stages"], ref["stages"])
    stage = out["stages"][0]
    i8 = stage["int8"]["pairs"]["a"]
    assert "qkv" not in stage["params"]["pairs"]["a"] and i8["qkv_q"].dtype == torch.int8
    assert tuple(i8["qkv_scale"].shape) == (2, 1, 48) and i8["qkv_bias"].dtype == torch.bfloat16
    assert Q.tree_nbytes(out["stages"]) == JQ.tree_nbytes(ref["stages"])
    rest, int8 = Q.split_dense_int8(stage_tree(params["stages"][1]), min_size=64)
    jrest, jint8 = JQ.split_dense_int8(tree["stages"][1], min_size=64)
    _assert_quantized_equal(rest, jrest)
    _assert_quantized_equal(int8, jint8)


@pytest.mark.parametrize("serve_int8", [False, True], ids=["at rest", "serving"])
def test_quantized_forward_matches_jax(fuxi, serve_int8):
    """Each tier's bf16 forward against JAX's on the same quantized stages,
    golden tolerance; each within 0.15 of the bf16 forward (mean |diff| /
    mean |bf16|); the cascade steps across the stage boundary."""
    import jax

    jmodel, tree, model, params = fuxi
    qp = model.quantize_params(params, min_size=64, serve_int8=serve_int8)
    jqp = jmodel.quantize_params(tree, min_size=64, serve_int8=serve_int8)
    x = np.random.default_rng(5).normal(size=model.state_shape).astype(np.float32)
    out = model.apply(qp, torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jmodel.apply)(jqp, x))
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)
    y0 = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.abs(out - y0).mean() / (np.abs(y0).mean() + 1e-6) < 0.15
    state = model.init_state(qp, x)
    for _ in range(3):  # stage_steps 2: the third step takes stage 1
        state, y = model.advance(qp, state)
        assert np.isfinite(y.numpy()).all()


def test_serve_int8_refuses_v1():
    model = FuXiModel(FuXiConfig(**GOLDEN_CFG, attn_v2=False), device="cpu")
    params = model.init_params()
    with pytest.raises(ValueError, match="serve_int8 requires attn_v2=True"):
        model.quantize_params(params, serve_int8=True)
    assert Q.is_quantized(model.quantize_params(params, min_size=64)["stages"][0])


@pytest.mark.gpu
def test_int8_dot_card_matches_cpu():
    """torch._int_mm on the card: the same int32 sums as on the CPU, so the
    same outputs; shapes it refuses raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 40, 256, generator=g).to(torch.bfloat16)
    w = Q.quantize_array(torch.randn(256, 128, generator=g))
    ref = Q.int8_dot(x, w)
    wc = Q.QuantizedTensor(w.q.cuda(), w.scale.cuda(), w.dtype)
    torch.testing.assert_close(Q.int8_dot(x.cuda(), wc).cpu(), ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="more than 16 rows"):
        Q.int8_dot(x[0, :8].cuda(), wc)

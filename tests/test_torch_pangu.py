"""The port's Pangu model against the JAX package's.

Both packages get the same parameters (initialised in JAX, carried over
by ``skyrim_tpu_torch.params.from_jax``) and the same numpy inputs.  The
configuration is the golden one (tests/test_golden.py:34-36) at depth 2,
so shifted blocks are on the path.  JAX runs its XLA path on the CPU.

Tolerances:
- f32 (``compute_dtype`` f32 in both): atol 3e-5, as
  tests/ops/test_fused_block.py:49;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise
  (as the golden test holds its samples).

JAX is imported inside the fixtures and tests: the card's machine has
no JAX and runs only the ``gpu`` test of this file.
"""

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
from skyrim_tpu_torch.params import flatten, from_jax
from skyrim_tpu_torch.rollout import scan_rollout

CFG = dict(lat=49, lon=96, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2))
GOLDEN = 3e-2


@pytest.fixture(scope="module")
def jax_pangu():
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel

    model = JModel("pangu", cfg=JConfig(**CFG))
    params = model.init_params(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_pangu(jax_pangu):
    model = PanguModel("pangu", cfg=PanguConfig(**CFG), device="cpu")
    return model, from_jax(jax_pangu[2], model)


def _x(seed=0, shape=(69, 49, 96)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_golden_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    tol = GOLDEN * (ref.std() + 1e-6)
    d = out - ref
    assert abs(out.mean() - ref.mean()) < tol
    assert abs(out.std() - ref.std()) < tol
    assert np.sqrt((d**2).mean()) < tol, np.sqrt((d**2).mean())
    assert np.abs(d).max() < 10 * tol, np.abs(d).max()


def test_grand_weights_equal_jax_cache(jax_pangu, port_pangu):
    _, _, tree = jax_pangu
    _, params = port_pangu
    for net in ("gw6", "gw24"):
        for k, ref in tree["cache"][net].items():
            out = params["cache"][net][k]
            assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
            # bitwise: compare the bf16 bit patterns
            np.testing.assert_array_equal(
                out.view(torch.int16).numpy(), ref.view(np.int16), err_msg=f"{net}/{k}"
            )


def test_bridge_consumes_every_leaf_once(jax_pangu, port_pangu):
    _, _, tree = jax_pangu
    model, params = port_pangu
    leaves = {k for k in flatten(tree) if not k.startswith("cache/")}
    port = {f"{n}/" + name.replace(".", "/") for n in ("net6", "net24")
            for name, _ in params[n].named_parameters()}
    port |= {"norm/mean", "norm/std", "consts"}
    assert port == leaves  # one port parameter per leaf, and no other
    extra = dict(tree, unused={"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(extra, model)
    missing = dict(tree, norm={"mean": tree["norm"]["mean"]})
    with pytest.raises(KeyError):
        from_jax(missing, model)


def test_init_params_tree_and_initialisers(jax_pangu):
    _, _, tree = jax_pangu
    model = PanguModel("pangu", cfg=PanguConfig(**CFG), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    for net in ("net6", "net24"):
        shapes = {f"{net}/" + n.replace(".", "/"): tuple(p.shape) for n, p in params[net].named_parameters()}
        ref = {k: v.shape for k, v in flatten(tree).items() if k.startswith(net + "/")}
        assert shapes == ref
    net = params["net6"]
    qkv = net.PanguBlock_0.EarthAttention3D_0.qkv.kernel
    # lecun_normal: truncated normal, std 1/sqrt(fan_in), |w| <= 2 * stddev
    assert abs(qkv.std().item() * 16**0.5 - 1) < 0.15
    bias = net.PanguBlock_0.EarthAttention3D_0.earth_bias
    assert bias.abs().max().item() <= 0.04 + 1e-7 and abs(bias.std().item() - 0.0176) < 0.002
    assert torch.all(net.PanguBlock_0.LayerNorm_0.scale == 1) and torch.all(qkv.new_tensor(0) == net.PanguBlock_0.Dense_0.bias)
    again = model.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again["net24"].PanguBlock_3.Dense_1.kernel, params["net24"].PanguBlock_3.Dense_1.kernel)


def test_forward_matches_jax_f32(jax_pangu, port_pangu, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, _ = jax_pangu
    model, params = port_pangu
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x()[None]
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 69, 49, 96)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_forward_matches_jax_bf16(jax_pangu, port_pangu):
    import jax

    jmodel, jparams, _ = jax_pangu
    model, params = port_pangu
    x = _x(1)[None]
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_rollout_through_24h_branch_matches_jax(jax_pangu, port_pangu, monkeypatch):
    """4 steps of the hierarchical "pangu" variant: steps 1-3 the 6h net,
    step 4 the 24h net from the anchor — f32, atol 3e-5."""
    import jax.numpy as jnp

    from skyrim_tpu.rollout import scan_rollout as j_scan_rollout

    jmodel, jparams, _ = jax_pangu
    model, params = port_pangu
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(2)
    _, ref = j_scan_rollout(jmodel, jparams, jmodel.init_state(jparams, x), 4)
    state, out = scan_rollout(model, params, model.init_state(params, x), 4)
    assert state.step == 4 and isinstance(state.step, int)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=0)
    direct24 = model._forward(params["net24"], params, torch.from_numpy(x), params["cache"]["gw24"])
    np.testing.assert_array_equal(out[3].numpy(), direct24.numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_small_config_card_matches_cpu(cuda):
    """The same seeded parameters and input: kernels on the card against
    the plain versions on the CPU, 4 bf16 steps, golden tolerance per step."""
    outs = {}
    for device in ("cuda", "cpu"):
        model = PanguModel("pangu", cfg=PanguConfig(**CFG), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        _, ys = scan_rollout(model, params, model.init_state(params, _x()), 4)
        outs[device] = ys.float().cpu().numpy()
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

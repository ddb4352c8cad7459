"""The port's GraphCast against the JAX package's, end to end.

Both packages get the same parameters (initialised in JAX, carried over
by ``skyrim_tpu_torch.params.from_jax``) and the same numpy inputs, at
the tiny configuration of tests/test_golden.py:50-53.  The port runs the
tiled path with the plain versions of K6-K9 on the CPU.  It is compared
with two JAX runs:

- JAX with ``use_pallas`` patched true (the same tiled algorithm, its
  Pallas kernels in interpret mode, as tests/ops/test_fused_mlp.py:255-258
  does): in f32 at atol 1e-4 (parts summed in another order over 2
  rounds), in bf16 at the golden tolerance tol = 3e-2·std
  (tests/test_golden.py:74) on the mean, the spread and the RMS of the
  difference, 10·tol elementwise;
- JAX's default XLA path (plan-mode encoder, chunk-scan decoder, unfused
  rounds): at rtol 0.02, atol 0.05, as tests/ops/test_fused_mlp.py:281
  holds the two JAX paths.

JAX is imported inside the fixtures and tests: the card's machine has no
JAX and runs only the ``gpu`` test of this file.
"""

import datetime

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel
from skyrim_tpu_torch.params import flatten, from_jax
from skyrim_tpu_torch.rollout import scan_rollout

CFG = dict(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
GOLDEN = 3e-2
START = datetime.datetime(2024, 5, 1, 9, 0)  # not midnight: the forcings matter


@pytest.fixture(scope="module")
def jax_gc():
    """(JAX model, XLA-mode params, tiled-mode params, numpy tree)."""
    jax = pytest.importorskip("jax")
    import skyrim_tpu.ops.flash_window_attention as fwa
    from skyrim_tpu.models.graphcast import GraphCastConfig as JConfig
    from skyrim_tpu.models.graphcast import GraphCastModel as JModel

    model = JModel(JConfig(**CFG, edge_chunks=2))
    params = model.init_params(jax.random.key(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fwa, "use_pallas", lambda: True)
        tiled = model.prepare_params({k: v for k, v in params.items() if k != "cache"})
    return model, params, tiled, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_gc(jax_gc):
    model = GraphCastModel(GraphCastConfig(**CFG), device="cpu")
    return model, from_jax(jax_gc[3], model)


@pytest.fixture
def tiled_jax(monkeypatch):
    import skyrim_tpu.ops.flash_window_attention as fwa

    monkeypatch.setattr(fwa, "use_pallas", lambda: True)


def _x(seed=0):
    return np.random.default_rng(seed).normal(size=(2, 4, 19, 36)).astype(np.float32)


def assert_golden_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    tol = GOLDEN * (ref.std() + 1e-6)
    d = out - ref
    assert abs(out.mean() - ref.mean()) < tol
    assert abs(out.std() - ref.std()) < tol
    assert np.sqrt((d**2).mean()) < tol, np.sqrt((d**2).mean())
    assert np.abs(d).max() < 10 * tol, np.abs(d).max()


def test_bridge_consumes_every_leaf_once(jax_gc, port_gc):
    tree = jax_gc[3]
    model, params = port_gc
    leaves = {k for k in flatten(tree) if not k.startswith("cache/")}
    port = {"net/" + n.replace(".", "/") for n, _ in params["net"].named_parameters()}
    assert port | {"norm/mean", "norm/std"} == leaves
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(dict(tree, unused={"w": np.zeros(2, np.float32)}), model)
    with pytest.raises(KeyError):
        from_jax(dict(tree, norm={"mean": tree["norm"]["mean"]}), model)
    bad = jax_gc[3]["net"]["head"]["Dense_1"]["kernel"]
    with pytest.raises(ValueError, match="shape"):
        net = dict(tree["net"], head={**tree["net"]["head"], "Dense_1": {"kernel": bad[:, :3], "bias": bad[0, :3]}})
        from_jax(dict(tree, net=net), model)


def test_init_params_tree_and_initialisers(jax_gc):
    tree = jax_gc[3]
    model = GraphCastModel(GraphCastConfig(**CFG), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    shapes = {"net/" + n.replace(".", "/"): tuple(p.shape) for n, p in params["net"].named_parameters()}
    assert shapes == {k: v.shape for k, v in flatten(tree).items() if k.startswith("net/")}
    net = params["net"]
    split = net.round_0.MLP_0.Dense_0.kernel  # SplitDense: fan-in is its 3L rows
    assert split.shape == (48, 16) and abs(split.std().item() * 48**0.5 - 1) < 0.15
    assert split.abs().max().item() <= 2 / 48**0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(net.head.Dense_0.bias == 0) and torch.all(net.g2m.MLP_0.LayerNorm_0.scale == 1)
    assert net.head.LayerNorm_0 is None
    assert model.param_count(params) == sum(int(np.prod(v.shape)) for k, v in flatten(tree).items()
                                            if not k.startswith("cache/"))


def test_cache_matches_jax_tiled(jax_gc, port_gc):
    tiled = jax_gc[2]["cache"]
    cache = port_gc[1]["cache"]
    H, W = 19, 36
    refs = {
        "mesh_embed": np.asarray(tiled["mesh_embed"], np.float32),
        "mm_edge": np.asarray(tiled["mm_edge"], np.float32),
        "g2m_bias": np.asarray(tiled["g2m_bias"], np.float32),
        # JAX keeps the m2g cache in its chunk layout (nc, ch/3, 3L), padded
        "m2g_bias": np.asarray(tiled["m2g_bias"], np.float32).reshape(-1, 48)[: H * W].reshape(H, W, 48),
    }
    for k, ref in refs.items():
        assert tuple(cache[k].shape) == ref.shape, k
        assert_golden_close(cache[k].float().numpy(), ref)


def test_forward_matches_jax_tiled_bf16(jax_gc, port_gc, tiled_jax):
    jmodel, _, tiled, _ = jax_gc
    model, params = port_gc
    x = _x()
    ref = np.asarray(jmodel.apply(tiled, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 4, 19, 36) and np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_forward_matches_jax_tiled_f32(jax_gc, port_gc, tiled_jax, monkeypatch):
    import jax.numpy as jnp
    from skyrim_tpu.models.graphcast import GraphCastConfig as JConfig
    from skyrim_tpu.models.graphcast import GraphCastModel as JModel

    tree = jax_gc[3]
    # the JAX net takes its dtype when the model is built
    monkeypatch.setattr(JModel, "compute_dtype", jnp.float32)
    jmodel = JModel(JConfig(**CFG, edge_chunks=2))
    jparams = jmodel.prepare_params({k: v for k, v in tree.items() if k != "cache"})
    model = GraphCastModel(GraphCastConfig(**CFG), device="cpu")
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    params = from_jax(tree, model)
    x = _x(1)
    ref = np.asarray(jmodel.apply(jparams, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_forward_matches_jax_xla(jax_gc, port_gc):
    jmodel, params, _, _ = jax_gc
    model, tparams = port_gc
    x = _x(2)
    ref = np.asarray(jmodel.apply(params, x))
    out = model.apply(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.02, atol=0.05)


def test_rollout_matches_jax(jax_gc, port_gc, tiled_jax):
    """3 steps from 09:00: the forcings (TISR, clock) change every step and
    the 2-frame history shifts; each step at the golden tolerance."""
    from skyrim_tpu.rollout import scan_rollout as j_scan_rollout

    jmodel, _, tiled, _ = jax_gc
    model, params = port_gc
    x = _x(3)
    _, ref = j_scan_rollout(jmodel, tiled, jmodel.init_state(tiled, x, start_time=START), 3)
    state, out = scan_rollout(model, params, model.init_state(params, x, start_time=START), 3)
    assert state.step == 3 and out.shape == (3, 4, 19, 36)
    assert state.time_days == pytest.approx((START - datetime.datetime(1970, 1, 1)).days + 9 / 24 + 0.75)
    for step in range(3):
        assert_golden_close(out[step].numpy(), np.asarray(ref[step]))
    # the forcings matter: the same rollout from midnight differs
    _, midnight = scan_rollout(model, params, model.init_state(params, x, start_time=START.replace(hour=0)), 1)
    assert np.abs(midnight[0].numpy() - out[0].numpy()).max() > 1e-3


def test_global_model_graphcast_on_cpu(tmp_path):
    """GlobalModel("graphcast"): forecast, predict_one_step and a saved
    rollout reloaded from disk, on the CPU with the plain versions."""
    from skyrim_tpu_torch.core import GlobalModel
    from skyrim_tpu_torch.io import SaveConfig, load_forecast

    gm = GlobalModel("graphcast", ic_source="synthetic", model_kwargs={"cfg": GraphCastConfig(**CFG)},
                     seed=1, device="cpu")
    fc = gm.forecast(START, n_steps=2)
    assert fc.data.shape == (3, 4, 19, 36) and np.isfinite(fc.data).all()
    assert np.abs(fc.data[1] - fc.data[0]).max() > 0
    one = gm.predict_one_step(START)
    np.testing.assert_allclose(one.data[1], fc.data[1], rtol=0, atol=1e-6)
    last, paths = gm.rollout(START, n_steps=2, save=True,
                             save_config=SaveConfig(forecast_id="gc", output_dir=str(tmp_path)))
    assert len(paths) == 2
    np.testing.assert_array_equal(load_forecast(paths[-1]).data, last.data)
    np.testing.assert_allclose(load_forecast(paths[0]).data[0], fc.data[1], rtol=0, atol=1e-6)


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
        model = GraphCastModel(GraphCastConfig(**CFG), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        _, ys = scan_rollout(model, params, model.init_state(params, _x(), start_time=START), 4)
        outs[device] = ys.float().cpu().numpy()
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

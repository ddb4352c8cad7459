"""The port's FourCastNet v2 (SFNO) against the JAX package's.

Both packages get the same parameters (initialised in JAX, the zero
position embedding, the norm affines, biases and normalisation stats
then drawn from a numpy seed so that each of them acts; carried over by
``skyrim_tpu_torch.params.from_jax``) and the same numpy inputs.  The
configuration is the golden one (tests/test_golden.py:39-40: two blocks,
so neither has skips) and a 4-block variant whose middle blocks carry
the inner and outer skips.

Tolerances:
- f32 (``compute_dtype`` f32 in both): max abs ≤ 1e-4·max|ref|, since the
  transforms sum up to nlat·nlon terms in f32;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise.

JAX is imported inside the fixtures and tests: the card's machine has
no JAX and runs only the ``gpu`` test of this file.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models import MODELS
from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig, SFNONet
from skyrim_tpu_torch.params import flatten, from_jax
from skyrim_tpu_torch.rollout import scan_rollout
from skyrim_tpu_torch.weights import checkpoint_dir, convert, load_params
from test_torch_pangu import assert_golden_close

GOLDEN_CFG = dict(lat=49, lon=96, in_channels=5, embed_dim=16, num_layers=2, scale_factor=4)
SKIPS_CFG = dict(GOLDEN_CFG, num_layers=4)
CONFIGS = {"golden": GOLDEN_CFG, "skips": SKIPS_CFG}
START = datetime.datetime(2024, 5, 1, 0)


def assert_f32_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max(), np.abs(out - ref).max()


def _jax_tree(cfg: dict, seed: int = 0):
    """The JAX init, with the leaves it sets to constants drawn instead."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.sfno import FourCastNetV2Model as JModel
    from skyrim_tpu.models.sfno import SFNOConfig as JConfig

    jmodel = JModel(JConfig(**cfg))
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    leaves = flatten(tree)
    for k, v in leaves.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "pos_embed" or leaf.endswith("bias") or leaf == "mean":
            leaves[k] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        elif leaf.endswith("_scale") or leaf == "std":
            leaves[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    from skyrim_tpu_torch.params import unflatten

    return jmodel, unflatten(leaves)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jax = pytest.importorskip("jax")
    cfg = CONFIGS[request.param]
    jmodel, tree = _jax_tree(cfg)
    model = FourCastNetV2Model(SFNOConfig(**cfg), device="cpu")
    return jmodel, jax.tree.map(jax.numpy.asarray, tree), tree, model, from_jax(tree, model)


def _x(model, seed=1):
    return np.random.default_rng(seed).normal(size=model.state_shape).astype(np.float32)


def test_bridge_consumes_every_leaf_once(pair):
    _, _, tree, model, params = pair
    leaves = set(flatten(tree))
    port = {"net/" + n.replace(".", "/") for n, _ in params["net"].named_parameters()} | {"norm/mean", "norm/std"}
    assert port == leaves  # one port parameter per leaf, and no other
    assert "net/pos_embed" in port and params["cache"]["pos_embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(dict(tree, unused={"w": np.zeros(2, np.float32)}), model)
    with pytest.raises(KeyError):
        from_jax(dict(tree, norm={"mean": tree["norm"]["mean"]}), model)


def test_init_params_tree_and_initialisers(pair):
    _, _, tree, model, _ = pair
    params = model.init_params(torch.Generator().manual_seed(0))
    shapes = {"net/" + n.replace(".", "/"): tuple(p.shape) for n, p in params["net"].named_parameters()}
    assert shapes == {k: v.shape for k, v in flatten(tree).items() if k.startswith("net/")}
    net, C = params["net"], model.cfg.embed_dim
    w0 = net.block_0.filter.w0
    assert abs(w0.std().item() * C * C - 1) < 0.1  # normal(1/C²)
    assert torch.all(net.block_1.norm0_scale == 1) and torch.all(net.block_1.norm1_bias == 0)
    assert torch.all(net.pos_embed == 0) and net.encoder_fc2.bias is None
    k = net.block_1.mlp_fc1.kernel  # lecun_normal: std 1/sqrt(fan_in), truncated at 2 std before its rescale
    assert abs(k.std().item() * C**0.5 - 1) < 0.15 and k.abs().max().item() <= 2 / 0.8796 / C**0.5
    assert (hasattr(net.block_1, "inner_skip")) == model.cfg.has_skips(1)


def test_fcnv2_sm_widths():
    """fcnv2_sm: 288,676,754 parameters with the 2·73 normalisation stats
    (tests/models/test_spectral.py:75), 265.8 M of them the position
    embedding; modes (120, 121) on 120x240."""
    cfg = SFNOConfig()
    with torch.device("meta"):
        net = SFNONet(cfg)
    assert sum(p.numel() for p in net.parameters()) + 2 * 73 == 288_676_754
    assert net.pos_embed.numel() == 721 * 1440 * 256
    assert cfg.internal_grid == (120, 240) and cfg.modes == (120, 121)
    assert [cfg.has_skips(i) for i in (0, 1, 10, 11)] == [False, True, True, False]


def test_forward_matches_jax_f32(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, jparams, _, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(model)
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 5, 49, 96)
    assert_f32_close(out, ref)


def test_forward_matches_jax_bf16(pair):
    import jax

    jmodel, jparams, _, model, params = pair
    x = _x(model, 2)
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def _write_ic(path, channels, n_frames=1, seed=3):
    """An IC of ``n_frames`` 6-hourly frames ending at START on the 49x96
    grid, written by the JAX package."""
    from skyrim_tpu.field import Field
    from skyrim_tpu.grid import LatLonGrid
    from skyrim_tpu.io.netcdf import write_netcdf

    grid = LatLonGrid(49, 96)
    data = np.random.default_rng(seed).normal(size=(n_frames, len(channels), 49, 96)).astype(np.float32)
    times = [START - datetime.timedelta(hours=6 * (n_frames - 1 - i)) for i in range(n_frames)]
    write_netcdf(Field.from_canonical(data, times, list(channels), grid.lat, grid.lon), path)
    return data


def test_global_model_rollout_matches_jax(pair, tmp_path):
    """4 steps of GlobalModel.forecast from a file: IC in both packages, f32."""
    import jax.numpy as jnp

    from skyrim_tpu.core.model import GlobalModel as JGlobalModel

    jmodel, jparams, _, model, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic, model.channels)
    jgm = JGlobalModel("fourcastnet_v2", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=jparams)
    gm = GlobalModel("fourcastnet_v2", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params,
                     device="cpu")
    jgm.model.compute_dtype, gm.model.compute_dtype = jnp.float32, torch.float32
    ref, out = jgm.forecast(START, n_steps=4), gm.forecast(START, n_steps=4)
    assert out.data.shape == ref.data.shape == (5, 5, 49, 96)
    np.testing.assert_array_equal(out.coords["time"], ref.coords["time"])
    for step in range(1, 5):
        assert_f32_close(out.data[step], ref.data[step])


def test_skyrim_predict_matches_jax(pair, tmp_path, monkeypatch):
    """Skyrim("fourcastnet_v2", ic_source="file:…").predict in both
    packages, bf16: the same files, fields within the golden tolerance."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    jmodel, jparams, _, model, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic, model.channels)
    kw = dict(ic_source=f"file:{ic}")
    jsky = JSkyrim("fourcastnet_v2", **kw, model_kwargs={"cfg": jmodel.cfg}, params=jparams)
    sky = Skyrim("fourcastnet_v2", **kw, model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    _, jpaths = jsky.predict("20240501", "0000", lead_time=13, save=True,
                             save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] and len(paths) == 2
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs and out.data.shape == (1, 5, 49, 96)
        assert_golden_close(out.data, ref.data)


# --- the converter -----------------------------------------------------------


def _sfno_state_dict(cfg, skips_on_every_block=False, prefix="module."):
    """A state dict in the official fcnv2_sm naming, as
    tests/test_weights_convert.py:275-360 builds it."""
    rng = np.random.default_rng(0)
    D, nc = cfg.embed_dim, cfg.in_channels
    hidden = cfg.hidden_factor * D

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"pos_embed": r(1, D, cfg.lat, cfg.lon), "encoder.0.weight": r(D, nc, 1, 1), "encoder.0.bias": r(D),
          "encoder.2.weight": r(D, D, 1, 1), "decoder.0.weight": r(D, D + nc, 1, 1), "decoder.0.bias": r(D),
          "decoder.2.weight": r(nc, D, 1, 1)}
    dims = [D] + [hidden] * cfg.spectral_layers
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"
        for nm in ("norm0", "norm1"):
            sd[f"{p}.{nm}.weight"], sd[f"{p}.{nm}.bias"] = r(D), r(D)
        for l in range(cfg.spectral_layers):
            sd[f"{p}.filter.filter.w.{l}"] = r(dims[l], dims[l + 1], 2)
        sd[f"{p}.filter.filter.wout"] = r(hidden, D, 2)
        if skips_on_every_block or cfg.has_skips(i):
            sd[f"{p}.inner_skip.weight"], sd[f"{p}.inner_skip.bias"] = r(D, D, 1, 1), r(D)
        sd[f"{p}.mlp.fwd.0.weight"], sd[f"{p}.mlp.fwd.0.bias"] = r(2 * D, D, 1, 1), r(2 * D)
        sd[f"{p}.mlp.fwd.2.weight"], sd[f"{p}.mlp.fwd.2.bias"] = r(D, 2 * D, 1, 1), r(D)
    sd["means"], sd["stds"] = r(nc), rng.uniform(1, 2, size=nc).astype(np.float32)
    return {prefix + k: v for k, v in sd.items()}


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb), sorted(set(fa) ^ set(fb))[:8]
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("prefix", ["module.", ""])
def test_converter_matches_jax(prefix):
    """The port's convert_sfno gives the JAX converter's tree leaf for leaf
    (the DDP prefix stripped or absent), and the tree runs."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.sfno import FourCastNetV2Model as JModel
    from skyrim_tpu.models.sfno import SFNOConfig as JConfig
    from skyrim_tpu.weights import convert as jconvert

    kw = dict(lat=48, lon=96, in_channels=5, embed_dim=16, num_layers=3, scale_factor=4)
    model = FourCastNetV2Model(SFNOConfig(**kw), device="cpu")
    sd = _sfno_state_dict(model.cfg, prefix=prefix)
    tracked = convert._TrackedSD(sd)
    out = convert.convert_sfno(model, tracked)
    assert set(sd) == tracked.consumed  # every tensor read, none twice through a renamed copy
    _assert_trees_equal(out, jax.tree.map(np.asarray, jconvert.convert_sfno(JModel(JConfig(**kw)), sd)))
    params = from_jax(out, model)
    assert "inner_skip" in dict(params["net"].block_1.named_children())
    x = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)
    assert np.isfinite(model.apply(params, torch.from_numpy(x)).numpy()).all()


def test_converter_rejects_skip_mismatch():
    """inner_skip on every block, block 0 included: a loud refusal, as the
    JAX converter's (tests/test_weights_convert.py:322-359)."""
    model = FourCastNetV2Model(SFNOConfig(lat=48, lon=96, in_channels=5, embed_dim=16, num_layers=3,
                                          scale_factor=4), device="cpu")
    with pytest.raises(ValueError, match="inner_skip"):
        convert.convert_sfno(model, _sfno_state_dict(model.cfg, skips_on_every_block=True, prefix=""))


def test_staged_state_dict_reaches_global_model(tmp_path, monkeypatch):
    """A staged fourcastnet_v2.pt is converted, saved as the port's
    checkpoint and taken by GlobalModel without params."""
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    assert "fourcastnet_v2" in MODELS
    cfg = SFNOConfig(**SKIPS_CFG)
    model = FourCastNetV2Model(cfg, device="cpu")
    sd = _sfno_state_dict(cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, checkpoint_dir("fourcastnet_v2").with_suffix(".pt"))
    gm = GlobalModel("fourcastnet_v2", ic_source="synthetic", model_kwargs={"cfg": cfg}, device="cpu")
    assert (checkpoint_dir("fourcastnet_v2") / "torch_0.pt").exists()
    expect = from_jax(convert.convert_sfno(model, sd), model)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=model.state_shape).astype(np.float32))
    np.testing.assert_array_equal(model.apply(gm.params, x).numpy(), model.apply(expect, x).numpy())
    np.testing.assert_array_equal(load_params(model)["net"].pos_embed.numpy(), expect["net"].pos_embed.numpy())


# --- the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_small_config_card_matches_cpu():
    """The same seeded parameters and input on the card and the CPU, 4 bf16
    steps, golden tolerance per step; no kernel of the port launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = {}
    for device in ("cuda", "cpu"):
        model = FourCastNetV2Model(SFNOConfig(**SKIPS_CFG), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        x = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)
        _, ys = scan_rollout(model, params, model.init_state(params, x), 4)
        outs[device] = ys.float().cpu().numpy()
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

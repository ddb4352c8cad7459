"""The port's FourCastNet v1 (AFNO) against the JAX package's.

Both packages get the same parameters (initialised in JAX, the biases,
LayerNorm affines and normalisation stats then drawn from a numpy seed so
that each of them acts; carried over by ``skyrim_tpu_torch.params.from_jax``)
and the same numpy inputs.  The configuration is the golden one
(tests/test_golden.py:40-42: 48×96, 5 channels, patch 8, width 16, two
blocks of two spectral groups), and a variant with ``hard_keep_fraction``
0.5 so that the zeroing of high latitude modes acts.  On the CPU the JAX
package's mixer takes ``jnp.fft`` (its matmul DFT is for the TPU); the
port's takes ``torch.fft``.

Tolerances:
- f32 (``compute_dtype`` f32 in both): atol 3e-5, as
  tests/ops/test_fused_block.py:49;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise.

JAX is imported inside the fixtures and tests: the card's machine has
no JAX and runs only the ``gpu`` test of this file.
"""

import datetime
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.afno import AFNOConfig, AFNONet, FourCastNetModel
from skyrim_tpu_torch.params import flatten, from_jax, unflatten
from skyrim_tpu_torch.rollout import scan_rollout
from skyrim_tpu_torch.weights import checkpoint_dir, convert
from test_torch_pangu import assert_golden_close
from test_torch_sfno import _assert_trees_equal

GOLDEN_CFG = dict(lat=48, lon=96, in_channels=5, patch=8, embed_dim=16, depth=2, num_blocks=2)
START = datetime.datetime(2024, 5, 1, 0)


def _drawn(tree, seed):
    rng = np.random.default_rng(seed)
    leaves = flatten(tree)
    for k, v in leaves.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean"):
            leaves[k] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        elif leaf in ("scale", "std"):
            leaves[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return unflatten(leaves)


def _pair(cfg: dict):
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.afno import AFNOConfig as JConfig
    from skyrim_tpu.models.afno import FourCastNetModel as JModel

    jmodel = JModel(JConfig(**cfg))
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), 0)
    model = FourCastNetModel(AFNOConfig(**cfg), device="cpu")
    return jmodel, tree, model, from_jax(tree, model)


@pytest.fixture(scope="module", params=[1.0, 0.5], ids=["keep all", "keep half"])
def pair(request):
    return _pair(dict(GOLDEN_CFG, hard_keep_fraction=request.param))


def _x(model, seed=1):
    return np.random.default_rng(seed).normal(size=model.state_shape).astype(np.float32)


def test_bridge_consumes_every_leaf_once(pair):
    _, tree, model, params = pair
    port = {"net/" + n.replace(".", "/") for n, _ in params["net"].named_parameters()} | {"norm/mean", "norm/std"}
    assert port == set(flatten(tree))
    assert {"net/block_1/AFNOMixer_0/w2_i", "net/pos_embed", "net/LayerNorm_0/scale"} <= port
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(dict(tree, unused={"w": np.zeros(2, np.float32)}), model)


def test_init_params_tree_and_initialisers(pair):
    _, tree, model, _ = pair
    params = model.init_params(torch.Generator().manual_seed(0))
    shapes = {"net/" + n.replace(".", "/"): tuple(p.shape) for n, p in params["net"].named_parameters()}
    assert shapes == {k: v.shape for k, v in flatten(tree).items() if k.startswith("net/")}
    net = params["net"]
    assert 0.015 < net.pos_embed.std().item() < 0.025 and 0.01 < net.block_0.AFNOMixer_0.b1_r.std().item() < 0.03
    assert torch.all(net.block_1.LayerNorm_1.scale == 1) and torch.all(net.block_1.Dense_0.bias == 0)


def test_forward_matches_jax_f32(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, tree, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(model)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 5, 48, 96)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_forward_matches_jax_bf16(pair):
    import jax

    jmodel, tree, model, params = pair
    x = _x(model, 2)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_golden_values():
    """tests/golden_values.json's ``afno`` entry from the JAX package's key-7
    parameters and the golden input, through the port."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.afno import AFNOConfig as JConfig
    from skyrim_tpu.models.afno import FourCastNetModel as JModel

    golden = json.loads((Path(__file__).parent / "golden_values.json").read_text())["afno"]
    jmodel = JModel(JConfig(**GOLDEN_CFG))
    model = FourCastNetModel(AFNOConfig(**GOLDEN_CFG), device="cpu")
    params = from_jax(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(7))), model)
    x = np.random.default_rng(13).normal(size=model.state_shape).astype(np.float32)
    y = model.apply(params, torch.from_numpy(x)).numpy().astype(np.float64)
    assert list(y.shape) == golden["shape"]
    flat = y.reshape(-1)
    tol = 3e-2 * (abs(golden["std"]) + 1e-6)
    assert abs(flat.mean() - golden["mean"]) < tol and abs(flat.std() - golden["std"]) < tol
    np.testing.assert_allclose(flat[np.asarray(golden["samples_idx"])], golden["samples"], atol=10 * tol)


def _write_ic(path, channels, seed=3):
    """A one-frame IC at START on the 48×96 grid without the south pole,
    written by the JAX package."""
    from skyrim_tpu.field import Field
    from skyrim_tpu.grid import LatLonGrid
    from skyrim_tpu.io.netcdf import write_netcdf

    grid = LatLonGrid(48, 96, include_south_pole=False)
    data = np.random.default_rng(seed).normal(size=(1, len(channels), 48, 96)).astype(np.float32)
    write_netcdf(Field.from_canonical(data, [START], list(channels), grid.lat, grid.lon), path)
    return data


def test_global_model_rollout_matches_jax(pair, tmp_path):
    """4 steps of GlobalModel.forecast from a file: IC in both packages, f32,
    atol 3e-5 per step."""
    import jax.numpy as jnp

    from skyrim_tpu.core.model import GlobalModel as JGlobalModel

    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    data = _write_ic(ic, model.channels)
    jgm = JGlobalModel("fourcastnet", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    gm = GlobalModel("fourcastnet", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params,
                     device="cpu")
    jgm.model.compute_dtype, gm.model.compute_dtype = jnp.float32, torch.float32
    ref, out = jgm.forecast(START, n_steps=4), gm.forecast(START, n_steps=4)
    assert out.data.shape == ref.data.shape == (5, 5, 48, 96)
    np.testing.assert_array_equal(out.data[0], data[-1])
    np.testing.assert_array_equal(out.coords["lat"], ref.coords["lat"])
    np.testing.assert_allclose(out.data[1:], ref.data[1:], atol=3e-5, rtol=0)


def test_skyrim_predict_matches_jax(pair, tmp_path, monkeypatch):
    """Skyrim("fourcastnet", ic_source="file:…").predict in both packages,
    bf16: the same files, fields within the golden tolerance."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic, model.channels)
    jsky = JSkyrim("fourcastnet", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    sky = Skyrim("fourcastnet", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    _, jpaths = jsky.predict("20240501", "0000", lead_time=13, save=True,
                             save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] and len(paths) == 2
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs and out.data.shape == (1, 5, 48, 96)
        assert_golden_close(out.data, ref.data)


def test_converter_matches_jax(tmp_path, monkeypatch):
    """On tests/test_weights_convert.py's synthetic modulus-layout state dict
    the port's convert_afno gives the JAX tree leaf for leaf, every tensor
    consumed; staged as fourcastnet.pt it reaches GlobalModel."""
    jax = pytest.importorskip("jax")
    import test_weights_convert as twc

    cfg = AFNOConfig(**{k: getattr(twc.CFG, k) for k in ("lat", "lon", "in_channels", "patch", "embed_dim", "depth",
                                                         "num_blocks")})
    sd = twc._synthetic_afno_state_dict(twc.CFG)
    model = FourCastNetModel(cfg, device="cpu")
    tracked = convert._TrackedSD(sd)
    out = convert.convert_afno(model, tracked)
    assert tracked.consumed == set(sd)
    ref = jax.tree.map(np.asarray, twc.convert.convert_afno(twc.FourCastNetModel(twc.CFG), sd))
    _assert_trees_equal(out, ref)
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               checkpoint_dir("fourcastnet").with_suffix(".pt"))
    gm = GlobalModel("fourcastnet", ic_source="synthetic", model_kwargs={"cfg": cfg}, device="cpu")
    assert (checkpoint_dir("fourcastnet") / "torch_0.pt").exists()
    x = torch.from_numpy(_x(model, 4))
    expect = from_jax(out, model)
    np.testing.assert_array_equal(model.apply(gm.params, x).numpy(), model.apply(expect, x).numpy())


def test_published_widths():
    """The JAX defaults: 26 channels on 720×1440 without the south pole,
    patch 8, width 768 on (90, 180) tokens, 12 blocks of 8 spectral groups;
    the parameter count equals JAX's from jax.eval_shape."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.afno import FourCastNetModel as JModel

    cfg = AFNOConfig()
    assert cfg.tokens == (90, 180)
    with torch.device("meta"):
        net = AFNONet(cfg)
    jmodel = JModel()
    shapes = jax.eval_shape(jmodel.module.init, jax.random.key(0), jax.ShapeDtypeStruct((26, 720, 1440), np.float32))
    ref = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    assert {n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()} == ref
    assert len(FourCastNetModel(device="cpu").channels) == 26


@pytest.mark.gpu
def test_small_config_card_matches_cpu():
    """The same seeded parameters and input on the card and the CPU, 4 bf16
    steps, golden tolerance per step; no kernel of the port is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import roll as RL

    outs = {}
    for device in ("cuda", "cpu"):
        model = FourCastNetModel(AFNOConfig(**GOLDEN_CFG), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        FB.fused_swin_block.launches = RL.roll3d.launches = 0
        _, ys = scan_rollout(model, params, model.init_state(params, _x(model, 0)), 4)
        outs[device] = ys.float().cpu().numpy()
        assert FB.fused_swin_block.launches == RL.roll3d.launches == 0
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

"""The port's FengWu and its fuser block against the JAX package's.

Both packages get the same parameters (initialised in JAX, the biases,
LayerNorm affines, bias tables and normalisation stats then drawn from a
numpy seed so that each of them acts; carried over by
``skyrim_tpu_torch.params.from_jax``) and the same numpy inputs.  The
configuration is the golden one (tests/test_golden.py:46-49: depth 2, so
one unshifted and one shifted block; 49 rows → 13 token rows padded to 18
for the window, so the valid-row mask acts).  On the CPU the JAX package
takes its XLA path (per-modal ``nn.Conv``/``nn.ConvTranspose`` and the
jnp window attention, ``use_pallas()`` is false there); the port takes
its grand GEMMs and the plain versions of K1 and K2.

Tolerances:
- f32 (``compute_dtype`` f32 in both): atol 3e-5, as
  tests/ops/test_fused_block.py:49;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise.

JAX is imported inside the fixtures and tests: the card's machine has
no JAX and runs only the ``gpu`` test of this file.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.fengwu import FengWuConfig, FengWuModel, FengWuNet
from skyrim_tpu_torch.models.fuxi import SwinBlock2D
from skyrim_tpu_torch.params import flatten, from_jax, unflatten
from skyrim_tpu_torch.rollout import scan_rollout
from skyrim_tpu_torch.weights import checkpoint_dir, convert, load_params
from test_torch_pangu import assert_golden_close
from test_torch_sfno import START, _assert_trees_equal, _write_ic

CFG = dict(lat=49, lon=96, levels=3, surface_channels=2, level_vars=2, modal_dim=8, fuser_dim=24, depth=2,
           num_heads=2)


def _drawn(tree, seed):
    """The tree with its constant-initialised leaves (and the bias tables,
    at 0.5) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    leaves = flatten(tree)
    for k, v in leaves.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean", "rel_bias"):
            leaves[k] = ((0.5 if leaf == "rel_bias" else 0.3) * rng.normal(size=v.shape)).astype(np.float32)
        elif leaf in ("scale", "std"):
            leaves[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return unflatten(leaves)


@pytest.fixture(scope="module")
def pair():
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.fengwu import FengWuConfig as JConfig
    from skyrim_tpu.models.fengwu import FengWuModel as JModel

    jmodel = JModel(JConfig(**CFG))
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), 0)
    model = FengWuModel(FengWuConfig(**CFG), device="cpu")
    return jmodel, tree, model, from_jax(tree, model)


def _x(model, seed=1):
    return np.random.default_rng(seed).normal(size=model.state_shape).astype(np.float32)


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_matches_jax(shifted):
    """One fuser block alone, f32, on a (18, 24, 24) activation whose last
    5 rows are padding (valid_h 13), against the JAX SwinBlock2D (V1)."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.fuxi import SwinBlock2D as JBlock

    dim, heads, window, valid_h = 24, 2, (6, 12), 13
    x = np.random.default_rng(5).normal(size=(18, 24, dim)).astype(np.float32)
    jblock = JBlock(dim, heads, window, shifted=shifted, valid_h=valid_h)
    tree = _drawn(jax.tree.map(np.asarray, jblock.init(jax.random.key(1), x)["params"]), 2)
    ref = np.asarray(jblock.apply({"params": tree}, x))
    block = SwinBlock2D(dim, heads, window, shifted)
    block.load_state_dict({k.replace("/", "."): torch.tensor(v) for k, v in flatten(tree).items()}, strict=True)
    out = block(torch.from_numpy(x), valid_h).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_bridge_consumes_every_leaf_once(pair):
    _, tree, model, params = pair
    port = {"net/" + n.replace(".", "/") for n, _ in params["net"].named_parameters()} | {"norm/mean", "norm/std"}
    assert port == set(flatten(tree))  # one port parameter per leaf, and no other
    assert {f"net/fuser_1/{k}" for k in ("rel_bias", "LayerNorm_0/scale", "qkv/kernel", "Dense_1/bias")} <= port
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(dict(tree, unused={"w": np.zeros(2, np.float32)}), model)
    with pytest.raises(KeyError):
        from_jax(dict(tree, norm={"mean": tree["norm"]["mean"]}), model)


def test_init_params_tree_and_initialisers(pair):
    _, tree, model, _ = pair
    params = model.init_params(torch.Generator().manual_seed(0))
    shapes = {"net/" + n.replace(".", "/"): tuple(p.shape) for n, p in params["net"].named_parameters()}
    assert shapes == {k: v.shape for k, v in flatten(tree).items() if k.startswith("net/")}
    blk = params["net"].fuser_1
    assert blk.rel_bias.abs().max().item() <= 0.04 + 1e-7 and 0.01 < blk.rel_bias.std().item() < 0.025
    assert torch.all(blk.LayerNorm_1.scale == 1) and torch.all(blk.Dense_0.bias == 0)
    assert blk.shifted and not params["net"].fuser_0.shifted
    assert set(params["cache"]["gw"]) == {"Wg", "bias_g", "Wr", "bias_r"}


def test_grand_weights_layout(pair):
    """The block-diagonal patch weight holds each modal kernel at its lanes
    and columns; the recovery weight each flipped transposed kernel."""
    _, _, model, params = pair
    net, gw = params["net"], params["cache"]["gw"]
    p, md, D = model.cfg.patch, model.cfg.modal_dim, model.cfg.fuser_dim
    lanes = sum(net.n_in)
    Wg = gw["Wg"].view(p, p, lanes, -1)
    torch.testing.assert_close(Wg[1, 2, 4:10, md : 2 * md], net.enc_1.kernel[1, 2], rtol=0, atol=0)
    assert not Wg[:, :, :4, md:].any() and not Wg[:, :, 4:, :md].any()
    Wr = gw["Wr"].view(D, p, p, -1)
    torch.testing.assert_close(Wr[:, 0, 3, 2:5], net.dec_1.kernel[p - 1, 0], rtol=0, atol=0)


def test_forward_matches_jax_f32(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, tree, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(model)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (1, 8, 49, 96)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_forward_matches_jax_bf16(pair):
    import jax

    jmodel, tree, model, params = pair
    x = _x(model, 2)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_global_model_rollout_matches_jax(pair, tmp_path):
    """4 steps of GlobalModel.forecast from a 2-frame file: IC in both
    packages, f32, atol 3e-5 per step."""
    import jax.numpy as jnp

    from skyrim_tpu.core.model import GlobalModel as JGlobalModel

    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    data = _write_ic(ic, model.channels, n_frames=2)
    jgm = JGlobalModel("fengwu", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    gm = GlobalModel("fengwu", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    jgm.model.compute_dtype, gm.model.compute_dtype = jnp.float32, torch.float32
    ref, out = jgm.forecast(START, n_steps=4), gm.forecast(START, n_steps=4)
    assert out.data.shape == ref.data.shape == (5, 8, 49, 96)
    np.testing.assert_array_equal(out.data[0], data[-1])
    np.testing.assert_array_equal(out.coords["time"], ref.coords["time"])
    np.testing.assert_allclose(out.data[1:], ref.data[1:], atol=3e-5, rtol=0)


def test_skyrim_predict_matches_jax(pair, tmp_path, monkeypatch):
    """Skyrim("fengwu", ic_source="file:…").predict in both packages, bf16:
    the same files, fields within the golden tolerance."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    jmodel, tree, model, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic, model.channels, n_frames=2)
    jsky = JSkyrim("fengwu", ic_source=f"file:{ic}", model_kwargs={"cfg": jmodel.cfg}, params=tree)
    sky = Skyrim("fengwu", ic_source=f"file:{ic}", model_kwargs={"cfg": model.cfg}, params=params, device="cpu")
    _, jpaths = jsky.predict("20240501", "0000", lead_time=13, save=True,
                             save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] and len(paths) == 2
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs and out.data.shape == (1, 8, 49, 96)
        assert_golden_close(out.data, ref.data)
    assert Skyrim.list_available_models() == ["pangu", "graphcast", "fourcastnet_v2", "fengwu", "fuxi", "fourcastnet",
                                              "dlwp"]


# --- the converter -----------------------------------------------------------


def test_converter_matches_jax():
    """On tests/test_weights_convert.py's synthetic FengWu state dict the
    port's convert_fengwu and expand_swin_rel_bias give the JAX trees leaf
    for leaf, every tensor consumed, and the tree runs."""
    jax = pytest.importorskip("jax")
    import test_weights_convert as twc

    jmodel, sd, _ = twc._make_fengwu_case()
    model = FengWuModel(FengWuConfig(**CFG), device="cpu")
    tracked = convert._TrackedSD(sd)
    out = convert.convert_fengwu(model, tracked)
    assert tracked.consumed == set(sd)
    _assert_trees_equal(out, jax.tree.map(np.asarray, twc.convert.convert_fengwu(jmodel, sd)))
    table = np.random.default_rng(0).normal(size=(11 * 23, 3)).astype(np.float32)
    np.testing.assert_array_equal(convert.expand_swin_rel_bias(table, (6, 12)),
                                  twc.convert.expand_swin_rel_bias(table, (6, 12)))
    params = from_jax(out, model)
    assert np.isfinite(model.apply(params, torch.from_numpy(_x(model))).numpy()).all()


def test_config_from_state_dict_and_artifact(tmp_path):
    """fengwu_config_from_sd reads the JAX function's configuration off the
    tensor shapes of tests/test_onnx_rename.py's FengWu case (window (2,
    4)); load_fengwu_from_artifact takes that state dict staged as a torch
    file, and the same tensors as an ONNX artifact, to JAX's tree."""
    jax = pytest.importorskip("jax")
    import test_weights_convert as twc
    from test_onnx_rename import _fengwu_case

    jmodel, jcfg, sd = _fengwu_case()
    cfg = convert.fengwu_config_from_sd(sd, lat=49, lon=96)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(twc.convert.fengwu_config_from_sd(sd, lat=49, lon=96))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.window == (2, 4)
    path = tmp_path / "fengwu.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    model, tree = convert.load_fengwu_from_artifact(path, lat=49, lon=96, device="cpu")
    assert model.cfg == cfg and model.device.type == "cpu"
    _assert_trees_equal(tree, jax.tree.map(np.asarray, twc.convert.convert_fengwu(jmodel, sd)))
    from skyrim_tpu_torch.weights.onnx_io import build_onnx

    (tmp_path / "fengwu.onnx").write_bytes(build_onnx({k: np.asarray(v) for k, v in sd.items()}))
    model, tree = convert.load_fengwu_from_artifact(tmp_path / "fengwu.onnx", lat=49, lon=96, device="cpu")
    assert model.cfg == cfg
    _assert_trees_equal(tree, jax.tree.map(np.asarray, twc.convert.convert_fengwu(jmodel, sd)))


def test_staged_state_dict_reaches_global_model(tmp_path, monkeypatch):
    """A staged fengwu.pt is converted, saved as the port's checkpoint and
    taken by GlobalModel without params."""
    pytest.importorskip("jax")
    import test_weights_convert as twc

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    _, sd, _ = twc._make_fengwu_case()
    cfg = FengWuConfig(**CFG)
    model = FengWuModel(cfg, device="cpu")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, checkpoint_dir("fengwu").with_suffix(".pt"))
    gm = GlobalModel("fengwu", ic_source="synthetic", model_kwargs={"cfg": cfg}, device="cpu")
    assert (checkpoint_dir("fengwu") / "torch_0.pt").exists()
    expect = from_jax(convert.convert_fengwu(model, sd), model)
    x = torch.from_numpy(_x(model, 4))
    np.testing.assert_array_equal(model.apply(gm.params, x).numpy(), model.apply(expect, x).numpy())
    np.testing.assert_array_equal(load_params(model)["net"].fuse_in.kernel.numpy(), expect["net"].fuse_in.kernel.numpy())


def test_published_widths():
    """The JAX defaults: 69 channels, 2 frames, fuser 1152 with 18 heads of
    64 at window (6, 12), 16 blocks, tokens (181, 360)."""
    cfg = FengWuConfig()
    assert cfg.in_channels == 69 and cfg.tokens == (181, 360) and cfg.fuser_dim // cfg.num_heads == 64
    with torch.device("meta"):
        net = FengWuNet(cfg)
    assert net.n_in == [8] + [26] * 5 and len([m for m in net.modules() if isinstance(m, SwinBlock2D)]) == 16
    assert tuple(net.fuser_0.rel_bias.shape) == (36 * 23, 18)


# --- the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_small_config_card_matches_cpu():
    """The same seeded parameters and input on the card (K1 and K2) and the
    CPU (their plain versions), 4 bf16 steps, golden tolerance per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import roll as RL

    outs = {}
    for device in ("cuda", "cpu"):
        model = FengWuModel(FengWuConfig(**CFG), device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        FB.fused_swin_block.launches = RL.roll3d.launches = 0
        _, ys = scan_rollout(model, params, model.init_state(params, _x(model, 0)), 4)
        outs[device] = ys.float().cpu().numpy()
        if device == "cuda":  # 2 blocks a step, the shifted one between two rolls
            assert FB.fused_swin_block.launches == 8 and RL.roll3d.launches == 8
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

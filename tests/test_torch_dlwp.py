"""The port's DLWP (cubed-sphere U-Net) against the JAX package's.

Both packages get the same parameters (initialised in JAX, the biases and
normalisation stats then drawn from a numpy seed so that each of them
acts; carried over by ``skyrim_tpu_torch.params.from_jax``) and the same
numpy inputs.  The configuration is the JAX tests' small one
(tests/models/test_dlwp.py:9-18: face 16, features (8, 16), 73×144).

Tolerances:
- the cubed-sphere tables: equal bit for bit, dtypes included;
- f32 (``compute_dtype`` f32 in both): atol 3e-5, as
  tests/ops/test_fused_block.py:49;
- bf16: the golden tolerance tol = 3e-2·std (tests/test_golden.py:74) on
  the mean, the spread and the RMS of the difference, 10·tol elementwise.

JAX is imported inside the fixtures and tests: the card's machine has no
JAX and runs only the ``gpu`` test of this file.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch import grid as tg
from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.dlwp import CSConvBlock, CubeUNet, DLWPModel, cs_pad, nearest_up2, torch_conv_weights
from skyrim_tpu_torch.params import flatten, from_jax, unflatten
from skyrim_tpu_torch.rollout import scan_rollout, stream_rollout
from skyrim_tpu_torch.weights import convert
from test_torch_pangu import assert_golden_close
from test_torch_sfno import _assert_trees_equal

FACE, FEATURES, LAT, LON = 16, (8, 16), 73, 144
START = datetime.datetime(2024, 5, 1, 0)
SMALL = dict(face_size=FACE, features=FEATURES, grid=LatLonGrid(LAT, LON))


def _jax_class():
    """The JAX DLWPModel on the 73×144 grid, its tables built for it (the
    JAX model takes no grid argument)."""
    from skyrim_tpu.grid import LatLonGrid as JGrid
    from skyrim_tpu.models.dlwp import DLWPModel as JModel

    class SmallDLWP(JModel):
        grid = JGrid(LAT, LON)

        def __init__(self, face_size=FACE, features=FEATURES):
            super().__init__(face_size, features)

    return SmallDLWP


def _drawn(tree, seed):
    rng = np.random.default_rng(seed)
    leaves = flatten(tree)
    for k, v in leaves.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean"):
            leaves[k] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        elif leaf == "std":
            leaves[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return unflatten(leaves)


@pytest.fixture(scope="module")
def pair():
    jax = pytest.importorskip("jax")
    jmodel = _jax_class()()
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), 0)
    model = DLWPModel(**SMALL, device="cpu")
    return jmodel, tree, model, from_jax(tree, model)


def _x(seed=1, n=2):
    return np.random.default_rng(seed).normal(size=(n, 7, LAT, LON)).astype(np.float32)


# --- the cubed sphere ----------------------------------------------------------


@pytest.mark.parametrize("table", ["latlon_to_cubed_sphere_indices", "latlon_to_cubed_sphere_patch",
                                   "cubed_sphere_to_latlon_patch", "cubed_sphere_to_latlon_indices"])
@pytest.mark.parametrize("size", [(16, 73, 144), (64, 721, 1440)], ids=["face16", "face64"])
def test_cubed_sphere_tables_equal_jax(table, size):
    from skyrim_tpu import grid as jg

    ref, out = getattr(jg, table)(*size), getattr(tg, table)(*size)
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("face", [16, 64])
def test_halo_and_cell_tables_equal_jax(face):
    from skyrim_tpu import grid as jg

    ref, out = jg.cubed_sphere_halo_indices(face, 1), tg.cubed_sphere_halo_indices(face, 1)
    assert out.dtype == ref.dtype == np.int32 and out.shape == (6, face + 2, face + 2)
    np.testing.assert_array_equal(out, ref)
    for a, b in zip(tg.CubedSphereGrid(face).latlon, jg.CubedSphereGrid(face).latlon):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    q = np.random.default_rng(0).normal(size=(100, 3))
    for a, b in zip(tg._inverse_gnomonic(q), jg._inverse_gnomonic(q)):
        np.testing.assert_array_equal(a, b)


# --- the modules -----------------------------------------------------------------


def test_cs_pad_matches_jax():
    from skyrim_tpu.models.dlwp import cs_pad as j_cs_pad

    halo = tg.cubed_sphere_halo_indices(FACE, 1)
    x = np.random.default_rng(0).normal(size=(2, 6, FACE, FACE, 5)).astype(np.float32)
    out = cs_pad(torch.from_numpy(x), torch.from_numpy(halo.astype(np.int64))).numpy()
    np.testing.assert_array_equal(out, np.asarray(j_cs_pad(x, halo)))


def _load(net, tree):
    state = {n: torch.from_numpy(np.array(flatten(tree)[n.replace(".", "/")])) for n, _ in net.named_parameters()}
    net.load_state_dict(state, strict=True)
    return net.requires_grad_(False)


@pytest.mark.parametrize("asymmetric", [False, True], ids=["init", "asymmetric kernel"])
def test_cs_conv_block_matches_flax(asymmetric):
    """A CSConvBlock against the flax module in f32; with an asymmetric
    kernel (one tap, off centre) the layout's transpose, not a flip, shows."""
    import jax

    from skyrim_tpu.models.dlwp import CSConvBlock as JBlock

    halo = tg.cubed_sphere_halo_indices(FACE, 1)
    x = np.random.default_rng(1).normal(size=(1, 6, FACE, FACE, 6)).astype(np.float32)
    jblock = JBlock(8, halo)
    tree = jax.tree.map(np.asarray, jblock.init(jax.random.key(1), x))["params"]
    if asymmetric:
        for c in ("Conv_0", "Conv_1"):
            k = np.zeros_like(tree[c]["kernel"])
            k[0, 2] = np.random.default_rng(2).normal(size=k.shape[2:])
            tree[c]["kernel"] = k
    tree = _drawn(tree, 3)
    ref = np.asarray(jblock.apply({"params": tree}, x))
    block = _load(CSConvBlock(6, 8), tree)
    convs = torch_conv_weights(block, torch.float32)
    out = block(torch.from_numpy(x), convs["Conv_0"], convs["Conv_1"], torch.from_numpy(halo.astype(np.int64)))
    assert out.shape == ref.shape == (1, 6, FACE, FACE, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-5, rtol=0)


def test_cube_unet_matches_flax():
    import jax

    from skyrim_tpu.models.dlwp import CubeUNet as JNet

    x = np.random.default_rng(4).normal(size=(1, 6, FACE, FACE, 14)).astype(np.float32)
    jnet = JNet(out_channels=14, face_size=FACE, features=(8, 16, 32))
    tree = _drawn(jax.tree.map(np.asarray, jnet.init(jax.random.key(2), x))["params"], 5)
    ref = np.asarray(jnet.apply({"params": tree}, x))
    net = _load(CubeUNet(14, 14, FACE, (8, 16, 32)), tree)
    halo = {f: torch.from_numpy(tg.cubed_sphere_halo_indices(f, 1).astype(np.int64)) for f in (4, 8, 16)}
    out = net(torch.from_numpy(x), torch_conv_weights(net, torch.float32), halo.__getitem__).numpy()
    assert out.shape == ref.shape == (1, 6, FACE, FACE, 14)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_nearest_up2_matches_jax_resize():
    import jax

    x = np.random.default_rng(5).normal(size=(1, 6, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(x[0], (6, 16, 16, 3), "nearest"))
    out = nearest_up2(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 6, 16, 16, 3)
    np.testing.assert_array_equal(out[0], ref)


# --- the model -------------------------------------------------------------------


def test_bridge_and_init_tree(pair, tmp_path, monkeypatch):
    """from_jax consumes the JAX tree; init_params draws the same tree shape
    with flax's initialisers; weights.load_params without a checkpoint
    falls back to init_params from its seed."""
    from skyrim_tpu_torch.weights import load_params

    _, tree, model, params = pair
    port = {"net/" + n.replace(".", "/") for n, _ in params["net"].named_parameters()} | {"norm/mean", "norm/std"}
    assert port == set(flatten(tree))
    init = model.init_params(torch.Generator().manual_seed(0))
    shapes = {"net/" + n.replace(".", "/"): tuple(p.shape) for n, p in init["net"].named_parameters()}
    assert shapes == {k: v.shape for k, v in flatten(tree).items() if k.startswith("net/")}
    assert torch.all(init["net"].Conv_0.bias == 0) and 0.05 < init["net"].CSConvBlock_0.Conv_0.kernel.std() < 0.15
    w, _ = init["cache"]["convs"][torch.bfloat16]["CSConvBlock_2.Conv_1"]  # the up block at 8 features
    assert w.dtype == torch.bfloat16 and w.shape == (8, 8, 3, 3)
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path))
    loaded = load_params(model, seed=0)
    for (name, a), (_, b) in zip(loaded["net"].named_parameters(), init["net"].named_parameters()):
        assert torch.equal(a, b), name


def test_apply_matches_jax_f32(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    jmodel, tree, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x()
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == (2, 7, LAT, LON)
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=0)


def test_apply_matches_jax_bf16(pair):
    import jax

    jmodel, tree, model, params = pair
    x = _x(2)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, x))
    out = model.apply(params, torch.from_numpy(x)).numpy()
    assert np.isfinite(out).all()
    assert_golden_close(out, ref)


def test_converter_matches_jax():
    """On tests/test_weights_convert.py's synthetic modulus-style state dict
    (blocks.{i}.conv1/2, head) the port's convert_dlwp gives the JAX tree
    leaf for leaf, every tensor consumed."""
    import jax

    from skyrim_tpu.weights import convert as jconvert

    jmodel = _jax_class()()
    native = jmodel.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    sd = {}
    for i, blk in enumerate(k for k in native["net"] if k.startswith("CSConvBlock")):
        for j, conv in enumerate(("conv1", "conv2")):
            kh, kw, ci, co = native["net"][blk][f"Conv_{j}"]["kernel"].shape
            sd[f"blocks.{i}.{conv}.weight"] = rng.normal(size=(co, ci, kh, kw)).astype(np.float32)
            sd[f"blocks.{i}.{conv}.bias"] = rng.normal(size=(co,)).astype(np.float32)
    kh, kw, ci, co = native["net"]["Conv_0"]["kernel"].shape
    sd["head.weight"] = rng.normal(size=(co, ci, kh, kw)).astype(np.float32)
    sd["head.bias"] = rng.normal(size=(co,)).astype(np.float32)
    sd["means"], sd["stds"] = rng.normal(size=7).astype(np.float32), rng.uniform(1, 2, size=7).astype(np.float32)
    model = DLWPModel(**SMALL, device="cpu")
    tracked = convert._TrackedSD(sd)
    out = convert.convert_dlwp(model, tracked)
    assert tracked.consumed == set(sd)
    _assert_trees_equal(out, jax.tree.map(np.asarray, jconvert.convert_dlwp(jmodel, sd)))
    assert np.isfinite(model.apply(from_jax(out, model), torch.from_numpy(_x(3))).numpy()).all()


def test_odd_rollout_matches_jax(pair, monkeypatch):
    """scan_rollout and stream_rollout with n_steps 3 in both packages, f32:
    two calls, the overshooting fourth frame dropped by the stream; the
    state advances 2 frames (12 h) a call."""
    import jax.numpy as jnp

    from skyrim_tpu.rollout import scan_rollout as j_scan

    jmodel, tree, model, params = pair
    monkeypatch.setattr(jmodel, "compute_dtype", jnp.float32)
    monkeypatch.setattr(model, "compute_dtype", torch.float32)
    x = _x(6)
    jfinal, jys = j_scan(jmodel, tree, jmodel.init_state(tree, x), n_steps=3)
    state = model.init_state(params, x, start_time=START)
    final, ys = scan_rollout(model, params, state, 3)
    assert ys.shape == (4, 7, LAT, LON) and np.asarray(jys).shape[0] == 4
    assert final.step == int(jfinal.step) == 4
    assert final.time_days == pytest.approx(state.time_days + 1.0)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=3e-5, rtol=0)
    frames = list(stream_rollout(model, params, model.init_state(params, x), 3))
    assert len(frames) == 3
    for a, b in zip(frames, ys.numpy()):
        np.testing.assert_array_equal(a, b)


def _write_ic(path, seed=3):
    """DLWP's two history frames (START − 6 h, START) on the 73×144 grid,
    written by the JAX package."""
    from skyrim_tpu.channels import DLWP
    from skyrim_tpu.field import Field
    from skyrim_tpu.grid import LatLonGrid as JGrid
    from skyrim_tpu.io.netcdf import write_netcdf

    grid = JGrid(LAT, LON)
    data = np.random.default_rng(seed).normal(size=(2, 7, LAT, LON)).astype(np.float32)
    times = [START - datetime.timedelta(hours=6), START]
    write_netcdf(Field.from_canonical(data, times, DLWP, grid.lat, grid.lon), path)
    return data


def test_predict_one_step_two_frames(pair, tmp_path, monkeypatch):
    """predict_one_step returns the IC and both frames of one call, at the
    times the JAX package gives them, f32 within 3e-5."""
    import jax.numpy as jnp

    from skyrim_tpu.core.model import GlobalModel as JGlobalModel
    from skyrim_tpu.models import MODELS as JMODELS

    jmodel, tree, model, params = pair
    monkeypatch.setitem(JMODELS, "dlwp", _jax_class())
    ic = tmp_path / "ic.nc"
    data = _write_ic(ic)
    jgm = JGlobalModel("dlwp", ic_source=f"file:{ic}", params=tree)
    gm = GlobalModel("dlwp", ic_source=f"file:{ic}", model_kwargs=SMALL, params=params, device="cpu")
    jgm.model.compute_dtype, gm.model.compute_dtype = jnp.float32, torch.float32
    ref, out = jgm.predict_one_step(START), gm.predict_one_step(START)
    assert out.data.shape == ref.data.shape == (3, 7, LAT, LON)
    np.testing.assert_array_equal(out.coords["time"], ref.coords["time"])
    np.testing.assert_array_equal(out.data[0], data[-1])
    np.testing.assert_allclose(out.data[1:], ref.data[1:], atol=3e-5, rtol=0)


def test_skyrim_predict_matches_jax(pair, tmp_path, monkeypatch):
    """Skyrim("dlwp", ic_source="file:…").predict(lead_time=18) in both
    packages, bf16: two calls, three frames, the same file names (one per
    6-h frame), fields within the golden tolerance."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast
    from skyrim_tpu.models import MODELS as JMODELS

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    monkeypatch.setitem(JMODELS, "dlwp", _jax_class())
    _, tree, _, params = pair
    ic = tmp_path / "ic.nc"
    _write_ic(ic)
    jsky = JSkyrim("dlwp", ic_source=f"file:{ic}", params=tree)
    sky = Skyrim("dlwp", ic_source=f"file:{ic}", model_kwargs=SMALL, params=params, device="cpu")
    calls = []
    advance = sky.model.model.advance
    monkeypatch.setattr(sky.model.model, "advance", lambda *a: calls.append(1) or advance(*a))
    _, jpaths = jsky.predict("20240501", "0000", lead_time=18, save=True,
                             save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=18, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert len(calls) == 2 and len(paths) == 3
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    assert pred.prediction.coords["time"][0] == np.datetime64("2024-05-01T18:00", "ns")
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs and out.data.shape == (1, 7, LAT, LON)
        assert_golden_close(out.data, ref.data)


def test_registered_and_published_widths():
    """'dlwp' is the seventh name of the registry; the default model is the
    JAX one: face 64, features 64-128-256 on 721×1440, 7 channels, 2
    frames in and out, 12 h a call; the parameter shapes equal JAX's."""
    jax = pytest.importorskip("jax")
    from skyrim_tpu.models.dlwp import DLWPModel as JModel

    from skyrim_tpu_torch.models import MODELS

    assert list(MODELS)[-1] == "dlwp" and MODELS["dlwp"] is DLWPModel
    jmodel = JModel()
    shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    with torch.device("meta"):
        net = CubeUNet(14, 14)
    ref = {k: tuple(v.shape) for k, v in flatten(shapes["net"]).items()}
    assert {n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()} == ref
    assert (DLWPModel.n_history, DLWPModel.frames_out, len(DLWPModel.channels)) == (2, 2, 7)
    assert DLWPModel.grid.shape == (721, 1440)


@pytest.mark.gpu
def test_small_config_card_matches_cpu():
    """The same seeded parameters and input on the card and the CPU, 4 bf16
    frames, golden tolerance per frame; no kernel of the port is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skyrim_tpu_torch.ops import fused_block as FB
    from skyrim_tpu_torch.ops import roll as RL

    outs = {}
    for device in ("cuda", "cpu"):
        model = DLWPModel(**SMALL, device=device)
        params = model.init_params(torch.Generator().manual_seed(0))
        FB.fused_swin_block.launches = RL.roll3d.launches = 0
        _, ys = scan_rollout(model, params, model.init_state(params, _x(0)), 4)
        outs[device] = ys.float().cpu().numpy()
        assert FB.fused_swin_block.launches == RL.roll3d.launches == 0
    for step in range(4):
        assert_golden_close(outs["cuda"][step], outs["cpu"][step])

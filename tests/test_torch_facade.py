"""The port's facade, weight storage and rollout remainder against the JAX
package.

``Skyrim("pangu", ic_source="file:…").predict`` runs in both packages on
the same parameters at the small Pangu configuration (as
tests/test_torch_core.py runs ``GlobalModel.rollout``): the same file
names, coordinates and attributes, fields within the golden bf16
tolerance (tol = 3e-2·std, tests/test_golden.py:74, on mean, spread and
RMS of the difference; 10·tol elementwise).  The converters run on the
synthetic state dicts of tests/test_weights_convert.py and must give
leaf-for-leaf equal trees in both packages; the port's checkpoints round
trip bit-exactly; the rollout helpers equal the JAX functions.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel, GlobalPrediction, Skyrim, adjust_lead_time
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
from skyrim_tpu_torch.params import flatten, from_jax, to_tree
from skyrim_tpu_torch.rollout import estimate_pressure_hpa, perturb_initial_condition, stream_rollout
from skyrim_tpu_torch.weights import checkpoint_dir, convert, load_checkpoint, load_params, save_checkpoint

jax = pytest.importorskip("jax")  # the card's machine has no JAX

CFG = dict(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
START = datetime.datetime(2024, 5, 1, 0)


def _close_golden(out, ref):
    d, r = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    tol = 3e-2 * r.std()
    assert abs(d.mean() - r.mean()) < tol and abs(d.std() - r.std()) < tol
    assert np.sqrt(((d - r) ** 2).mean()) < tol and np.abs(d - r).max() < 10 * tol


def _write_ic(path):
    """A 69-channel IC on the 49x96 grid, written by the JAX package."""
    from skyrim_tpu.channels import PANGU
    from skyrim_tpu.field import Field
    from skyrim_tpu.grid import LatLonGrid
    from skyrim_tpu.io.netcdf import write_netcdf

    grid = LatLonGrid(49, 96)
    data = np.random.default_rng(3).normal(size=(1, 69, 49, 96)).astype(np.float32)
    write_netcdf(Field.from_canonical(data, [START], PANGU, grid.lat, grid.lon), path)
    return data


def _jax_model():
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel

    return JModel("pangu", cfg=JConfig(**CFG))


def _port_model():
    return PanguModel("pangu", cfg=PanguConfig(**CFG), device="cpu")


@pytest.fixture
def weights_root(tmp_path, monkeypatch):
    root = tmp_path / "weights"
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(root))
    return root


def _forward(model, params, x):
    return model.apply(params, torch.from_numpy(x)).numpy()


# --- the facade ---------------------------------------------------------------


def test_skyrim_predict_matches_jax(tmp_path, weights_root):
    """13 h floored to 12 h: two steps, two files, in both packages; the
    returned prediction is the last file read back."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast
    from skyrim_tpu.models.pangu import PanguConfig as JConfig

    ic = tmp_path / "ic.nc"
    _write_ic(ic)
    jparams = _jax_model().init_params(jax.random.key(0))
    jsky = JSkyrim("pangu", ic_source=f"file:{ic}", model_kwargs={"cfg": JConfig(**CFG)}, params=jparams)
    sky = Skyrim("pangu", ic_source=f"file:{ic}", model_kwargs={"cfg": PanguConfig(**CFG)},
                 params=from_jax(jax.tree.map(np.asarray, jparams), _port_model()), device="cpu")
    jpred, jpaths = jsky.predict("20240501", "0000", lead_time=13, save=True,
                                 save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert isinstance(pred, GlobalPrediction) and pred.filepath is None
    assert len(paths) == len(jpaths) == 2
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    assert Path(paths[-1]).name == "pangu__file__20240501_06:00__20240501_12:00.nc"
    np.testing.assert_array_equal(GlobalPrediction(paths[-1]).prediction.data, pred.prediction.data)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs
        for dim in ref.dims:
            np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
        assert out.data.shape == ref.data.shape == (1, 69, 49, 96)
        _close_golden(out.data, ref.data)
    assert pred.channels == list(jpred.channels) and pred.size == jpred.size
    tol = 3e-2 * float(np.asarray(jpred.slice(channel="u10m").data).std())  # single values: 10 tol
    for lat, lon in ((41.0, 29.0), (-33.9, 151.2)):
        u, v = pred.point_wind_uv(lat, lon)
        np.testing.assert_allclose(pred.wind_speed(lat, lon), np.sqrt(u**2 + v**2))
        assert np.abs(pred.wind_speed(lat, lon) - np.asarray(jpred.wind_speed(lat, lon))).max() < 10 * tol


def test_skyrim_lead_time_floor_and_forecast(weights_root):
    """The lead time is floored to the 6 h step and at least one step runs,
    as in the JAX facade; ``forecast`` returns the IC and every step."""
    from skyrim_tpu.core.model import adjust_lead_time as j_adjust

    for lead in (0, 5, 6, 13, 25, 240):
        assert adjust_lead_time(lead) == j_adjust(lead)
        assert adjust_lead_time(lead, 24) == j_adjust(lead, 24)
    sky = Skyrim("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)}, device="cpu")
    pred, paths = sky.predict("20240501", "0600", lead_time=5)
    assert paths == [] and pred.prediction.sizes["time"] == 1
    assert pred.prediction.coords["time"][0] == np.datetime64("2024-05-01T12:00", "ns")
    fc = sky.forecast(START, n_steps=2, channels=["t2m"])
    assert fc.data.shape == (3, 1, 49, 96)


def test_skyrim_invalid_and_several_models():
    """A name the port lacks raises the JAX facade's ValueError; several
    names build a GlobalEnsemble of those members (built when it runs)."""
    from skyrim_tpu_torch.core import GlobalEnsemble

    with pytest.raises(ValueError, match="invalid model"):
        Skyrim("not_a_model")
    with pytest.raises(ValueError, match=r"invalid model.*'gencast'"):
        Skyrim("gencast")
    with pytest.raises(ValueError, match="at least one"):
        Skyrim()
    sky = Skyrim("pangu", "graphcast", ic_source="synthetic")
    assert isinstance(sky.model, GlobalEnsemble) and sky.model.model_names == sky.model_names == ["pangu", "graphcast"]
    assert sky.model.model_name == "ensemble[graphcast,pangu]" and sky.model.time_step == datetime.timedelta(hours=6)
    assert Skyrim.list_available_models() == ["pangu", "graphcast", "fourcastnet_v2", "fengwu", "fuxi", "fourcastnet",
                                              "dlwp"]


def test_skyrim_default_device_raises_without_cuda(monkeypatch, weights_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Skyrim("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)})


def test_global_model_surface_matches_jax(tmp_path, weights_root):
    """time_step and the channel names as the JAX GlobalModel gives them; a
    str initial condition read through GlobalPrediction; release_model
    drops the parameters."""
    gm = GlobalModel("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)}, device="cpu")
    jm = _jax_model()
    assert gm.time_step == jm.time_step == datetime.timedelta(hours=6)
    assert gm.in_channel_names == jm.in_channel_names and gm.out_channel_names == jm.out_channel_names
    ic = tmp_path / "ic.nc"
    data = _write_ic(ic)
    one = gm.predict_one_step(START, initial_condition=str(ic))
    np.testing.assert_array_equal(one.data[0], data[0])
    gm.release_model()
    assert gm.params is None


# --- weights ------------------------------------------------------------------


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb), (sorted(set(fa) ^ set(fb)))[:8]
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_pangu_converter_matches_jax():
    import test_weights_convert as twc

    jmodel, sd, _ = twc._make_pangu_case()
    ref = jax.tree.map(np.asarray, twc.convert.convert_pangu(jmodel, sd))
    model = PanguModel("pangu6", cfg=PanguConfig(**{k: getattr(jmodel.cfg, k) for k in CFG}), device="cpu")
    out = convert.convert_pangu(model, sd)
    _assert_trees_equal(out, ref)
    assert set(out) == {"net6", "norm", "consts"}
    x = np.random.default_rng(0).normal(size=model.state_shape).astype(np.float32)
    assert np.isfinite(_forward(model, from_jax(out, model), x)).all()


def test_graphcast_converter_matches_jax():
    import test_weights_convert as twc
    from skyrim_tpu.models.graphcast import GraphCastConfig as JConfig
    from skyrim_tpu.models.graphcast import GraphCastModel as JModel

    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

    kw = dict(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
    jmodel, model = JModel(JConfig(**kw, edge_chunks=2)), GraphCastModel(GraphCastConfig(**kw), device="cpu")
    rng = np.random.default_rng(0)
    L, din = 16, jmodel.n_history * 4 + jmodel.N_FORCINGS + 3
    sd = {}
    twc._mlp_sd(sd, rng, "grid_embed", din, L, L)
    twc._mlp_sd(sd, rng, "mesh_embed", 3, L, L)
    twc._mlp_sd(sd, rng, "mm_embed", 4, L, L)
    for bp in ("g2m", "m2g"):
        twc._mlp_sd(sd, rng, f"{bp}.edge_embed", 4, L, L)
        twc._mlp_sd(sd, rng, f"{bp}.message", 3 * L, L, L)
        twc._mlp_sd(sd, rng, f"{bp}.update", 2 * L, L, L)
    for i in range(2):
        twc._mlp_sd(sd, rng, f"processor.{i}.edge", 3 * L, L, L)
        twc._mlp_sd(sd, rng, f"processor.{i}.node", 2 * L, L, L)
    twc._mlp_sd(sd, rng, "grid_update", L, L, L)
    twc._mlp_sd(sd, rng, "head", L, L, 4, ln=False)
    sd["means"], sd["stds"] = rng.normal(size=4).astype(np.float32), rng.uniform(1, 2, size=4).astype(np.float32)
    out = convert.convert_graphcast(model, sd)
    _assert_trees_equal(out, jax.tree.map(np.asarray, twc.convert.convert_graphcast(jmodel, sd)))
    params = from_jax(out, model)
    assert params["net"].embed_grid.Dense_0.kernel.shape == (din, L)
    # keys naming a gnn take the Haiku converter, as in JAX: this one
    # module path does not classify
    for fn in (convert.convert_graphcast, twc.convert.convert_graphcast):
        with pytest.raises(ValueError, match="did not classify"):
            fn(model, {"gnn/layer": sd["head.fc1.weight"]})


def test_convert_torch_file_dispatch(tmp_path):
    """A staged state dict converts through torch.load(weights_only=True),
    the same tensors as an ONNX artifact through the protobuf reader; a
    model without a converter raises."""
    import test_weights_convert as twc

    jmodel, sd, _ = twc._make_pangu_case()
    model = PanguModel("pangu6", cfg=PanguConfig(**CFG), device="cpu")
    staged = tmp_path / "pangu.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, staged)
    _assert_trees_equal(convert.convert_torch_file(model, staged), convert.convert_pangu(model, sd))
    from skyrim_tpu_torch.weights.onnx_io import build_onnx

    (tmp_path / "pangu.onnx").write_bytes(build_onnx(sd))
    _assert_trees_equal(convert.convert_torch_file(model, tmp_path / "pangu.onnx"), convert.convert_pangu(model, sd))

    class Other:
        name = "gencast"

    with pytest.raises(NotImplementedError, match="no converter for 'gencast'"):
        convert.convert_torch_file(Other(), staged)


def test_checkpoint_round_trip_is_bit_exact(weights_root):
    """save_checkpoint then load_checkpoint gives the same tree bit for bit,
    without the cache, in a file that no orbax step directory (digit name)
    collides with; the loaded parameters give the same forward."""
    model = _port_model()
    params = model.init_params(torch.Generator().manual_seed(3))
    (checkpoint_dir("pangu") / "0").mkdir(parents=True)  # an orbax step directory beside it
    path = save_checkpoint("pangu", params)
    assert Path(path).name == "torch_0.pt" and not Path(path).name.isdigit()
    tree = load_checkpoint("pangu")
    assert "cache" not in tree and set(tree) == {"net6", "net24", "norm", "consts"}
    _assert_trees_equal(tree, to_tree(params))
    save_checkpoint("pangu", tree, step=7)
    _assert_trees_equal(load_checkpoint("pangu"), tree)  # the newest step
    x = np.random.default_rng(1).normal(size=model.state_shape).astype(np.float32)
    np.testing.assert_array_equal(_forward(model, from_jax(tree, model), x), _forward(model, params, x))


def test_load_params_order(weights_root):
    """A saved checkpoint first, then a staged torch file (converted and
    saved), then the seeded random init; every path gives the forward of
    ``params.from_jax`` on the same tree."""
    import test_weights_convert as twc

    _, sd, _ = twc._make_pangu_case()
    model = _port_model()
    x = np.random.default_rng(2).normal(size=model.state_shape).astype(np.float32)
    # nothing stored: the seeded random init
    init = load_params(model, seed=5)
    np.testing.assert_array_equal(_forward(model, init, x),
                                  _forward(model, model.init_params(torch.Generator().manual_seed(5)), x))
    with pytest.raises(FileNotFoundError, match="stage a torch file"):
        load_params(model, allow_init=False)
    # a staged torch file: converted, saved as a checkpoint
    weights_root.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, checkpoint_dir("pangu").with_suffix(".pt"))
    expect = _forward(model, from_jax(convert.convert_pangu(model, sd), model), x)
    np.testing.assert_array_equal(_forward(model, load_params(model), x), expect)
    assert (checkpoint_dir("pangu") / "torch_0.pt").exists()
    # a checkpoint beside the staged file is taken first
    save_checkpoint("pangu", init, step=1)
    np.testing.assert_array_equal(_forward(model, load_params(model), x), _forward(model, init, x))
    # GlobalModel without params takes the same order
    gm = GlobalModel("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)}, device="cpu")
    np.testing.assert_array_equal(_forward(model, gm.params, x), _forward(model, init, x))


# --- the rollout's remainder ------------------------------------------------------


@pytest.mark.parametrize("mode", ["set", "add", "scale"])
def test_perturb_initial_condition_matches_jax(mode):
    from skyrim_tpu.rollout import perturb_initial_condition as j_perturb

    rng = np.random.default_rng(4)
    for shape in ((69, 49, 96), (1, 69, 49, 96)):
        ic = rng.normal(size=shape).astype(np.float32)
        for channel, lat, lon, value in (("t2m", 41.0, 29.0, 3.5), ("z500", -89.0, 359.9, -2.0)):
            out = perturb_initial_condition(ic, _port_model(), channel, lat, lon, value, mode)
            ref = j_perturb(ic, _jax_model(), channel, lat, lon, value, mode)
            np.testing.assert_array_equal(out, ref)
            assert (out != ic).sum() == 1 or mode == "scale" and value == 1
    with pytest.raises(ValueError, match="unknown mode"):
        perturb_initial_condition(ic, _port_model(), "t2m", 0.0, 0.0, 1.0, "double")


def test_estimate_pressure_hpa_matches_jax():
    from skyrim_tpu.rollout import estimate_pressure_hpa as j_pressure

    for z in (-400.0, 0.0, 500.0, 1609.3, 8848.0):
        assert estimate_pressure_hpa(z) == j_pressure(z)
    assert estimate_pressure_hpa(0.0) == 1013.25


def test_stream_rollout_transfer_options_match_jax():
    """transfer_dtype and channel_idx: the frames as the JAX stream_rollout
    gives them (float16, the selected channels), within the golden
    tolerance, and exactly the port's full frames cast and selected."""
    import jax.numpy as jnp

    from skyrim_tpu.rollout import stream_rollout as j_stream

    jmodel, model = _jax_model(), _port_model()
    jparams = jmodel.init_params(jax.random.key(0))
    params = from_jax(jax.tree.map(np.asarray, jparams), model)
    x0 = np.random.default_rng(5).normal(size=model.state_shape).astype(np.float32)
    idx = (0, 5, 68)
    refs = list(j_stream(jmodel, jparams, jmodel.init_state(jparams, x0, start_time=START), 2,
                         transfer_dtype=jnp.float16, channel_idx=idx))
    outs = list(stream_rollout(model, params, model.init_state(params, x0, start_time=START), 2,
                               transfer_dtype=torch.float16, channel_idx=idx))
    full = list(stream_rollout(model, params, model.init_state(params, x0, start_time=START), 2))
    assert len(outs) == len(refs) == 2
    for out, ref, f in zip(outs, refs, full):
        assert out.dtype == ref.dtype == np.float16 and out.shape == ref.shape == (3, 49, 96)
        np.testing.assert_array_equal(out, f[list(idx)].astype(np.float16))
        _close_golden(out, ref)

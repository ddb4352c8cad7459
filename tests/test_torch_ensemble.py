"""The port's ensembles against the JAX package's: the multi-model
``GlobalEnsemble`` (and ``Skyrim`` with several names) and the
initial-condition ensemble of ``core/ic_ensemble.py``.

The multi-model ensemble runs on a fake model pair registered in both
packages' ``MODELS`` (the BoringModel pair of tests/core/test_core.py:19-45:
y = x + 1 and y = x + 3, sharing t2m and u10m), from a ``file:`` IC the
JAX package writes (the synthetic sources of the two packages seed
differently).  The IC ensemble runs a tiny SFNO registered the same way
(tests/core/test_ic_ensemble.py:29), f32 in both packages, the JAX
package's seed-0 parameters carried over by ``params.from_jax``.

Tolerances: ``perturb_members`` bit for bit; the fields f32, atol 3e-5.
JAX is imported inside the tests: the card's machine has no JAX.
"""

import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalEnsemble, GlobalPrediction, Skyrim
from skyrim_tpu_torch.core.ic_ensemble import (
    dp_ensemble_rollout,
    ensemble_mean,
    ensemble_spread,
    ic_ensemble_forecast,
    perturb_members,
)
from skyrim_tpu_torch.grid import LatLonGrid
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models import MODELS
from skyrim_tpu_torch.models.base import PrognosticModel, make_norm_params
from skyrim_tpu_torch.models.sfno import FourCastNetV2Model, SFNOConfig
from skyrim_tpu_torch.params import from_jax
from skyrim_tpu_torch.utils.device import resolve_device

jax = pytest.importorskip("jax")  # the card's machine has no JAX

T0 = datetime.datetime(2024, 5, 1, 0)
PAIR_CHANNELS = ("t2m", "u10m", "v10m", "z500", "msl")  # the union of the pair's
SFNO_CFG = dict(lat=17, lon=32, in_channels=3, embed_dim=8, num_layers=1, scale_factor=4)


class BoringModel(PrognosticModel):
    """Persistence + bias: y = x + 1."""

    name = "boring"
    channels = ("t2m", "u10m", "v10m", "z500")
    grid = LatLonGrid(19, 36)
    n_history = 1

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def init_params(self, generator=None):
        return {"norm": make_norm_params(len(self.channels), device=self.device),
                "bias": torch.tensor(1.0, device=self.device)}

    def apply(self, params, x):
        return (x[-1] + params["bias"])[None]


class BoringModelB(BoringModel):
    name = "boring_b"
    channels = ("t2m", "u10m", "msl")  # overlaps boring on t2m/u10m

    def apply(self, params, x):
        return (x[-1] + 3 * params["bias"])[None]


class BoringModel12h(BoringModel):
    name = "boring_12h"
    time_step = datetime.timedelta(hours=12)


class TinySFNO(FourCastNetV2Model):
    name = "tiny_sfno"
    compute_dtype = torch.float32

    def __init__(self, device="cuda"):
        super().__init__(SFNOConfig(**SFNO_CFG), device=device)
        self.channels = ("t2m", "u10m", "v10m")


def _jax_classes():
    import jax.numpy as jnp

    from skyrim_tpu.grid import LatLonGrid as JGrid
    from skyrim_tpu.models.base import PrognosticModel as JModel
    from skyrim_tpu.models.base import make_norm_params as j_norm
    from skyrim_tpu.models.sfno import FourCastNetV2Model as JSFNO
    from skyrim_tpu.models.sfno import SFNOConfig as JConfig

    class JBoring(JModel):
        name = "boring"
        channels = BoringModel.channels
        grid = JGrid(19, 36)
        n_history = 1

        def init_params(self, rng):
            return {"norm": j_norm(len(self.channels)), "bias": jnp.float32(1.0)}

        def apply(self, params, x):
            return (x[-1] + params["bias"])[None]

    class JBoringB(JBoring):
        name = "boring_b"
        channels = BoringModelB.channels

        def apply(self, params, x):
            return (x[-1] + 3 * params["bias"])[None]

    class JTinySFNO(JSFNO):
        name = "tiny_sfno"
        compute_dtype = jnp.float32

        def __init__(self):
            super().__init__(JConfig(**SFNO_CFG))
            self.channels = TinySFNO(device="cpu").channels

    return {"boring": JBoring, "boring_b": JBoringB, "tiny_sfno": JTinySFNO}


@pytest.fixture(autouse=True)
def registered(monkeypatch, tmp_path):
    """The fakes in both packages' registries (and the JAX facade's list);
    SKYRIM_WEIGHTS_DIR an empty directory, so both take their seeded init."""
    import skyrim_tpu.core.skyrim as jsky
    from skyrim_tpu.models import MODELS as JMODELS

    for name, cls in _jax_classes().items():
        monkeypatch.setitem(JMODELS, name, cls)
    for cls in (BoringModel, BoringModelB, BoringModel12h, TinySFNO):
        monkeypatch.setitem(MODELS, cls.name, cls)
    monkeypatch.setattr(jsky, "AVAILABLE_MODELS", jsky.AVAILABLE_MODELS + ["boring", "boring_b"])
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))


def _write_ic(path, channels, shape, seed=3):
    """A one-frame IC at T0, written by the JAX package."""
    from skyrim_tpu.field import Field
    from skyrim_tpu.grid import LatLonGrid as JGrid
    from skyrim_tpu.io.netcdf import write_netcdf

    grid = JGrid(*shape)
    data = np.random.default_rng(seed).normal(size=(1, len(channels), *shape)).astype(np.float32)
    write_netcdf(Field.from_canonical(data, [T0], list(channels), grid.lat, grid.lon), path)
    return data


@pytest.fixture
def pair_ic(tmp_path):
    ic = tmp_path / "ic.nc"
    return ic, _write_ic(ic, PAIR_CHANNELS, (19, 36))


def _assert_fields_close(out, ref):
    assert out.dims == ref.dims and out.data.shape == ref.data.shape
    for k in ref.coords:
        np.testing.assert_array_equal(out.coords[k], ref.coords[k], err_msg=k)
    np.testing.assert_allclose(out.data, ref.data, atol=3e-5, rtol=0)


# --- GlobalEnsemble --------------------------------------------------------------


def test_ensemble_forecast_matches_jax(pair_ic):
    """The mean over the shared channels (t2m, u10m) of both members'
    forecasts: x + 2 a step, as in JAX."""
    from skyrim_tpu.core.ensemble import GlobalEnsemble as JEnsemble

    ic, data = pair_ic
    src = f"file:{ic}"
    ref = JEnsemble(["boring", "boring_b"], ic_source=src).forecast(T0, n_steps=2)
    ens = GlobalEnsemble(["boring", "boring_b"], ic_source=src, device="cpu")
    out = ens.forecast(T0, n_steps=2)
    assert list(out.coords["channel"]) == list(ref.coords["channel"]) == ["t2m", "u10m"]
    _assert_fields_close(out, ref)
    np.testing.assert_allclose(out.data[2], data[0, :2] + 4, atol=3e-5, rtol=0)
    assert ens.model_name == "ensemble[boring,boring_b]" and ens.time_step == datetime.timedelta(hours=6)
    assert list(ens.forecast(T0, n_steps=1, channels=["u10m"]).coords["channel"]) == ["u10m"]


def test_ensemble_rollout_matches_jax(pair_ic, tmp_path):
    """rollout(save=True): each member's steps under <forecast_id>/<member>,
    the mean under <forecast_id>/mean, 2 members × 2 steps + 1 = 5 files
    of the JAX package's names; the mean file holds the returned field."""
    from skyrim_tpu.core.ensemble import GlobalEnsemble as JEnsemble
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast

    ic, _ = pair_ic
    src = f"file:{ic}"
    jfinal, jpaths = JEnsemble(["boring", "boring_b"], ic_source=src).rollout(
        T0, n_steps=2, save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    final, paths = GlobalEnsemble(["boring", "boring_b"], ic_source=src, device="cpu").rollout(
        T0, n_steps=2, save_config={"forecast_id": "fc", "output_dir": str(tmp_path / "torch")})
    assert len(paths) == len(jpaths) == 5
    rel = [str(Path(p).relative_to(tmp_path / "torch")) for p in paths]
    assert rel == [str(Path(p).relative_to(tmp_path / "jax")) for p in jpaths]
    assert rel[0].startswith("fc/boring/") and rel[2].startswith("fc/boring_b/") and rel[4].startswith("fc/mean/")
    _assert_fields_close(final, jfinal)
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.attrs == ref.attrs
        _assert_fields_close(out, ref)
    np.testing.assert_array_equal(load_forecast(paths[-1]).data, final.data)
    _, none = GlobalEnsemble(["boring", "boring_b"], ic_source=src, device="cpu").rollout(T0, 1, save=False)
    assert none == []


def test_ensemble_members_release_and_take_their_params(pair_ic, monkeypatch):
    """Each member's parameters are dropped after it ran; ``params`` keyed
    by member name reaches that member only; params for a non-member raise."""
    from skyrim_tpu_torch.core.model import GlobalModel

    ic, data = pair_ic
    released = []
    release = GlobalModel.release_model
    monkeypatch.setattr(GlobalModel, "release_model", lambda self: (released.append(self.model_name), release(self)))
    params = {"boring_b": {"norm": make_norm_params(3), "bias": torch.tensor(2.0)}}
    out = GlobalEnsemble(["boring", "boring_b"], ic_source=f"file:{ic}", params=params, device="cpu").forecast(T0, 1)
    assert released == ["boring", "boring_b"]
    np.testing.assert_allclose(out.data[1], data[0, :2] + (1 + 6) / 2, atol=3e-5, rtol=0)
    with pytest.raises(ValueError, match="not members"):
        GlobalEnsemble(["boring"], params={"boring_b": params["boring_b"]}, device="cpu")


def test_mixed_cadence_is_refused(pair_ic):
    ens = GlobalEnsemble(["boring", "boring_12h"], ic_source=f"file:{pair_ic[0]}", device="cpu")
    with pytest.raises(ValueError, match="disagree on time_step"):
        ens.time_step
    with pytest.raises(ValueError, match="boring_12h steps 12:00:00"):
        ens.forecast(T0, n_steps=1)


def test_skyrim_several_names_matches_jax(pair_ic, tmp_path):
    """Skyrim with two names builds a GlobalEnsemble; predict(lead_time=13)
    floors to 2 steps and gives JAX's files and mean."""
    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig

    ic, _ = pair_ic
    src = f"file:{ic}"
    sky = Skyrim("boring", "boring_b", ic_source=src, device="cpu")
    assert isinstance(sky.model, GlobalEnsemble) and sky.model_names == ["boring", "boring_b"]
    jpred, jpaths = JSkyrim("boring", "boring_b", ic_source=src).predict(
        "20240501", "0000", lead_time=13, save=True,
        save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    pred, paths = sky.predict("20240501", "0000", lead_time=13, save=True,
                              save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] and len(paths) == 5
    assert isinstance(pred, GlobalPrediction)
    _assert_fields_close(pred.prediction, jpred.prediction)
    fc = sky.forecast(T0, n_steps=2, channels=["t2m"])
    assert fc.data.shape == (3, 1, 19, 36)


# --- the IC ensemble ---------------------------------------------------------------


@pytest.mark.parametrize("n_members, scale, seed", [(4, 0.05, 0), (3, 0.01, 7)])
def test_perturb_members_bit_for_bit(n_members, scale, seed):
    from skyrim_tpu.core.ic_ensemble import perturb_members as j_perturb

    x0 = np.random.default_rng(0).normal(size=(2, 3, 9, 18)).astype(np.float32)
    out, ref = perturb_members(x0, n_members, scale, seed), j_perturb(x0, n_members, scale, seed)
    assert out.dtype == ref.dtype and out.shape == (n_members, 2, 3, 9, 18)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0], x0)


@pytest.fixture
def sfno_run(tmp_path):
    """ic_ensemble_forecast on the tiny SFNO in both packages from one file
    IC, the port on the JAX package's seed-0 parameters."""
    from skyrim_tpu.core.ic_ensemble import ic_ensemble_forecast as j_forecast

    ic = tmp_path / "sfno_ic.nc"
    _write_ic(ic, ("t2m", "u10m", "v10m"), (17, 32), seed=4)
    ref = j_forecast("tiny_sfno", T0, n_steps=2, n_members=4, perturb_scale=0.01, ic_source=f"file:{ic}")
    jtree = jax.tree.map(np.asarray, _jax_classes()["tiny_sfno"]().init_params(jax.random.key(0)))
    params = from_jax(jtree, TinySFNO(device="cpu"))
    out = ic_ensemble_forecast("tiny_sfno", T0, n_steps=2, n_members=4, perturb_scale=0.01, ic_source=f"file:{ic}",
                               params=params, device="cpu")
    return out, ref, ic, params


def test_ic_ensemble_forecast_matches_jax(sfno_run):
    out, ref, ic, params = sfno_run
    assert out.dims == ("number", "time", "channel", "lat", "lon") and out.data.shape == (4, 2, 3, 17, 32)
    assert out.attrs == ref.attrs == {"model": "tiny_sfno", "perturb_scale": 0.01}
    _assert_fields_close(out, ref)
    from skyrim_tpu_torch.core import GlobalModel

    control = GlobalModel("tiny_sfno", ic_source=f"file:{ic}", params=params, device="cpu").forecast(T0, n_steps=2)
    np.testing.assert_array_equal(out.data[0], control.data[1:])
    assert all(np.abs(out.data[m] - out.data[0]).max() > 0 for m in (1, 2, 3))


def test_ensemble_mean_and_spread_match_jax(sfno_run):
    from skyrim_tpu.core.ic_ensemble import ensemble_mean as j_mean
    from skyrim_tpu.core.ic_ensemble import ensemble_spread as j_spread

    out, ref, _, _ = sfno_run
    for port_fn, jax_fn in ((ensemble_mean, j_mean), (ensemble_spread, j_spread)):
        a, b = port_fn(out), jax_fn(ref)
        assert a.dims == b.dims == ("time", "channel", "lat", "lon") and a.attrs == b.attrs
        _assert_fields_close(a, b)
    spread = ensemble_spread(out).data
    assert spread.min() >= 0 and spread.max() > 0


def test_a_port_mesh_runs_and_anything_else_is_refused(sfno_run):
    """A port ``Mesh`` (here one rank's: the multi-rank runs are in
    tests/test_torch_sharded.py) gives the in-turn run's Field bit for bit;
    any other mesh raises TypeError."""
    from skyrim_tpu_torch.parallel.mesh import single_device_mesh

    out, _, ic, params = sfno_run
    mesh = single_device_mesh("cpu")
    meshed = ic_ensemble_forecast("tiny_sfno", T0, n_steps=2, n_members=4, perturb_scale=0.01,
                                  ic_source=f"file:{ic}", params=params, mesh=mesh)
    assert meshed.dims == out.dims and meshed.attrs == out.attrs
    np.testing.assert_array_equal(meshed.data, out.data)
    with pytest.raises(TypeError, match="Mesh or None"):
        ic_ensemble_forecast("tiny_sfno", T0, mesh=object(), ic_source="synthetic", device="cpu")
    with pytest.raises(TypeError, match="Mesh or None"):
        dp_ensemble_rollout(TinySFNO(device="cpu"), object(), 2)

"""The port's skill scores (``skyrim_tpu_torch.evaluate``) against the JAX
package's ``skyrim_tpu.evaluate``.

RMSE, bias and MAE (cos-latitude weights), ACC with and without a
climatology, and ``score_table`` on the same seeded Fields: equal to
JAX's within 1e-6 relative.  ``benchmark_model`` runs a model's forecast,
fetches the CDS truth for the same valid times through a fake CDS
transport shared by both packages, and scores; the same forecast in both
packages gives the same table.  Then the port's facade end to end: a
small DLWP ``Skyrim`` scored against a constant truth.

JAX is imported by ``pytest.importorskip`` at collection: the card's
machine has no JAX and skips this file.
"""

import datetime

import numpy as np
import pytest

from skyrim_tpu_torch import evaluate
from skyrim_tpu_torch.data import cds, grib
from skyrim_tpu_torch.field import Field

pytest.importorskip("jax")
from skyrim_tpu import evaluate as jevaluate  # noqa: E402
from skyrim_tpu.data import cds as jcds  # noqa: E402
from skyrim_tpu.field import Field as JField  # noqa: E402

T0 = datetime.datetime(2024, 5, 1, 0)
CHANNELS = ["t2m", "u10m", "z500"]


def _field(seed, cls=Field, n=3, shape=(19, 36), channels=CHANNELS, start=1):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(n, len(channels), *shape)) * 5 + 280).astype(np.float32)
    times = [T0 + datetime.timedelta(hours=6 * (i + start)) for i in range(n)]
    return cls.from_canonical(data, times, channels, np.linspace(90, -90, shape[0]),
                              np.arange(shape[1]) * 360.0 / shape[1])


def _pair(seed, **kw):
    return _field(seed, **kw), _field(seed, cls=JField, **kw)


def _assert_field_close(out, ref):
    assert tuple(out.dims) == tuple(ref.dims) == ("time", "channel")
    for dim in ref.dims:
        np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
    np.testing.assert_allclose(out.data, ref.data, rtol=1e-6, atol=0)


@pytest.mark.parametrize("metric", ["rmse", "bias", "mae", "acc"])
def test_metrics_equal_jax(metric):
    """Truth with a channel and a time the forecast lacks, and the other
    way round: both packages align on the same common subset."""
    pred, jpred = _pair(1, channels=["t2m", "u10m", "z500", "msl"])
    truth, jtruth = _pair(2, n=4, start=0)
    out = getattr(evaluate, metric)(pred, truth)
    ref = getattr(jevaluate, metric)(jpred, jtruth)
    assert out.data.shape == (3, 3)
    _assert_field_close(out, ref)
    assert list(out.coords["channel"]) == CHANNELS


def test_metrics_known_values():
    truth = _field(3)
    same = evaluate.rmse(truth, truth)
    np.testing.assert_array_equal(same.data, 0.0)
    off = Field(truth.data + 2.0, truth.dims, dict(truth.coords), {})
    np.testing.assert_allclose(evaluate.rmse(off, truth).data, 2.0, rtol=1e-5)
    np.testing.assert_allclose(evaluate.bias(off, truth).data, 2.0, rtol=1e-5)
    np.testing.assert_allclose(evaluate.mae(off, truth).data, 2.0, rtol=1e-5)
    anti = Field(2 * truth.data.mean(axis=0) - truth.data, truth.dims, dict(truth.coords), {})
    np.testing.assert_allclose(evaluate.acc(truth, truth).data, 1.0, rtol=1e-5)
    np.testing.assert_allclose(evaluate.acc(anti, truth).data, -1.0, rtol=1e-5)


def test_acc_with_climatology_and_score_table_equal_jax():
    pred, jpred = _pair(4)
    truth, jtruth = _pair(5)
    clim_data = np.random.default_rng(6).normal(280, 3, (3, 19, 36)).astype(np.float32)
    coords = {"channel": np.array(CHANNELS[::-1], dtype=object), "lat": pred.coords["lat"],
              "lon": pred.coords["lon"]}
    clim = Field(clim_data[::-1].copy(), ("channel", "lat", "lon"), coords, {})
    jclim = JField(clim_data[::-1].copy(), ("channel", "lat", "lon"), dict(coords), {})
    _assert_field_close(evaluate.acc(pred, truth, clim), jevaluate.acc(jpred, jtruth, jclim))
    for c in (None, clim):
        out = evaluate.score_table(pred, truth, c)
        ref = jevaluate.score_table(jpred, jtruth, None if c is None else jclim)
        assert out.keys() == ref.keys() == {"rmse", "bias", "mae", "acc", "lead_times"}
        assert out["lead_times"] == ref["lead_times"]
        for metric in ("rmse", "bias", "mae", "acc"):
            assert out[metric].keys() == ref[metric].keys() == set(CHANNELS)
            for ch in CHANNELS:
                np.testing.assert_allclose(out[metric][ch], ref[metric][ch], rtol=1e-6, atol=0)


class _FakeCDS:
    """CDS retrieval: per requested hour one message on the canonical grid,
    seeded by the request (shared by both packages)."""

    def __call__(self, dataset, body):
        out = b""
        for i, hour in enumerate(body["time"]):
            rng = np.random.default_rng(int(hour[:2]) + 100 * len(body["variable"]))
            small = rng.normal(size=(37, 72)) * 3 + 280
            out += grib.encode_simple(np.repeat(np.repeat(small, 20, 0), 20, 1)[:721], nbits=12)
        return out


class _Forecaster:
    """A model surface for benchmark_model: a 6-hourly step and a forecast
    that returns the IC and n_steps frames on the canonical grid."""

    time_step = datetime.timedelta(hours=6)

    def __init__(self, cls):
        self.cls = cls

    def forecast(self, start, n_steps=4):
        rng = np.random.default_rng(9)
        data = (rng.normal(size=(n_steps + 1, 2, 73, 144)) * 3 + 280).astype(np.float32)
        data = np.repeat(np.repeat(data, 10, 2), 10, 3)[:, :, :721]
        times = [start + i * self.time_step for i in range(n_steps + 1)]
        return self.cls.from_canonical(data, times, ["t2m", "u10m"], np.linspace(90, -90, 721),
                                       np.arange(1440) * 0.25)


def test_benchmark_model_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr("skyrim_tpu.data.cds.LOCAL_CACHE", str(tmp_path / "jax"))
    monkeypatch.setattr("skyrim_tpu_torch.data.cds.LOCAL_CACHE", str(tmp_path / "torch"))
    transport = _FakeCDS()
    out = evaluate.benchmark_model(_Forecaster(Field), cds.CDS(["t2m"], transport=transport), "20240501",
                                   "0000", lead_time=13)
    ref = jevaluate.benchmark_model(_Forecaster(JField), jcds.CDS(["t2m"], transport=transport), "20240501",
                                    "0000", lead_time=13)
    assert out["lead_times"] == ref["lead_times"] and len(out["lead_times"]) == 3  # 0, 6, 12 h
    assert out["rmse"].keys() == {"t2m"}
    for metric in ("rmse", "bias", "mae", "acc"):
        np.testing.assert_allclose(out[metric]["t2m"], ref[metric]["t2m"], rtol=1e-6, atol=0)
    assert np.all(np.asarray(out["rmse"]["t2m"]) > 0)


def test_benchmark_model_through_the_facade(tmp_path, monkeypatch):
    """A seeded small DLWP (face 16) on the canonical grid from a synthetic
    IC, scored against a constant 280 K truth: positive RMSE, |bias| <= RMSE."""
    from skyrim_tpu_torch.core import Skyrim

    monkeypatch.setattr("skyrim_tpu_torch.data.cds.LOCAL_CACHE", str(tmp_path))
    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))

    def constant(dataset, body):
        return grib.encode_simple(np.full((721, 1440), 280.0, np.float32)) * len(body["time"])

    sky = Skyrim("dlwp", ic_source="synthetic", model_kwargs={"face_size": 16, "features": (8, 16)}, device="cpu")
    scores = evaluate.benchmark_model(sky, cds.CDS(["t2m"], transport=constant), date="20240501", lead_time=6)
    rmse, bias = np.asarray(scores["rmse"]["t2m"]), np.asarray(scores["bias"]["t2m"])
    assert rmse.size >= 1 and np.isfinite(rmse).all() and (rmse > 0).all()
    assert (np.abs(bias) <= rmse + 1e-6).all()

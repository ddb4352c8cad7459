"""The port's host tools against the JAX package's: the Open-Meteo and
Meteostat clients (pandas frames from a fake transport) and the plotting
helpers (a rollout GIF and a point wind-speed plot).

pandas, matplotlib and imageio are imported by ``pytest.importorskip``
inside the tests, and JAX at collection: the card's machine lacks all of
them and skips this file.
"""

import datetime
import gzip
import json

import numpy as np
import pytest

from skyrim_tpu_torch.field import Field

pytest.importorskip("jax")


def _step(i, cls=Field):
    t = datetime.datetime(2024, 5, 1, 6 * (i + 1))
    data = np.random.default_rng(i).normal(280, 10, (1, 3, 19, 36)).astype(np.float32)
    return cls.from_canonical(data, [t], ["t2m", "u10m", "v10m"], np.linspace(90, -90, 19), np.arange(36) * 10.0)


def test_openmeteo_frames_equal_jax():
    pd = pytest.importorskip("pandas")
    from skyrim_tpu.data import openmeteo as jom

    from skyrim_tpu_torch.data import openmeteo

    payload = {"hourly": {"time": ["2024-05-01T00:00", "2024-05-01T01:00"], "temperature_2m": [15.0, 16.0],
                          "pressure_msl": [1013.0, 1012.5], "wind_speed_10m": [3.0, 4.5]}}
    urls = []

    def transport(url, **kw):
        urls.append(url)
        return json.dumps(payload).encode()

    for mod in (openmeteo, jom):
        mod.forecast.cache_clear()
    out = openmeteo.forecast(41.0, 29.0, "2024-05-01", "2024-05-01", ("t2m", "msl", "si10"), transport=transport)
    ref = jom.forecast(41.0, 29.0, "2024-05-01", "2024-05-01", ("t2m", "msl", "si10"), transport=transport)
    pd.testing.assert_frame_equal(out, ref)
    assert list(out.columns) == ["t2m", "msl", "si10"] and out["t2m"].iloc[1] == 16.0
    assert urls[0] == urls[1] and "hourly=temperature_2m,pressure_msl,wind_speed_10m" in urls[0]
    assert openmeteo.VARIABLE_MAP == jom.VARIABLE_MAP
    frame = openmeteo._to_frame({"hourly": {"time": ["2024-05-01T00:00"], "temperature_2m_previous_day1": [1.0],
                                            "temperature_2m": [2.0]}}, suffix_strip="_previous_day")
    jframe = jom._to_frame({"hourly": {"time": ["2024-05-01T00:00"], "temperature_2m_previous_day1": [1.0],
                                       "temperature_2m": [2.0]}}, suffix_strip="_previous_day")
    pd.testing.assert_frame_equal(frame, jframe)
    assert list(frame.columns) == ["t2m-1", "t2m"]
    with pytest.raises(ValueError, match="at most 7 days"):
        openmeteo.forecast_past(41.0, 29.0, past_days=8)


def test_observations_frames_equal_jax():
    pd = pytest.importorskip("pandas")
    from skyrim_tpu.data import observations as jobs

    from skyrim_tpu_torch.data import observations as obs

    stations = [{"id": "17060", "location": {"latitude": 40.9, "longitude": 29.2}},
                {"id": "99999", "location": {"latitude": -33.0, "longitude": 151.0}}]
    rows = "\n".join(f"2024-05-01,{h},15.{h},10.0,60,0.0,,180,18.0,,1013.2,,3" for h in range(24))

    def transport(url, **kw):
        if "stations" in url:
            return gzip.compress(json.dumps(stations).encode())
        assert "17060" in url  # the nearest station
        return gzip.compress(rows.encode())

    span = (datetime.datetime(2024, 5, 1, 3), datetime.datetime(2024, 5, 1, 20))
    try:
        obs._STATIONS_CACHE = jobs._STATIONS_CACHE = None
        out = obs.observe(41.0, 29.0, *span, transport=transport)
        ref = jobs.observe(41.0, 29.0, *span, transport=transport)
    finally:
        obs._STATIONS_CACHE = jobs._STATIONS_CACHE = None
    pd.testing.assert_frame_equal(out, ref)
    assert out.attrs == ref.attrs and out.attrs["station"]["id"] == "17060"
    assert len(out) == 18 and out["o_si10"].iloc[0] == pytest.approx(18.0 / 3.6)
    assert obs._haversine_km(41.0, 29.0, 40.9, 29.2) == jobs._haversine_km(41.0, 29.0, 40.9, 29.2)


def test_rollout_gif_and_wind_plot(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("imageio")
    from skyrim_tpu.field import Field as JField
    from skyrim_tpu.plotting import generate_rollout_gif as j_gif

    from skyrim_tpu_torch.core.prediction import GlobalPredictionRollout
    from skyrim_tpu_torch.io import write_netcdf
    from skyrim_tpu_torch.plotting import generate_rollout_gif, plot_wind_speed, visualize_rollout

    steps = [_step(i) for i in range(3)]
    out = generate_rollout_gif(steps, "t2m", str(tmp_path / "torch" / "roll.gif"))
    ref = j_gif([_step(i, JField) for i in range(3)], "t2m", str(tmp_path / "jax" / "roll.gif"))
    data = (tmp_path / "torch" / "roll.gif").read_bytes()
    assert out == str(tmp_path / "torch" / "roll.gif") and data[:6] in (b"GIF87a", b"GIF89a")
    assert data == (tmp_path / "jax" / "roll.gif").read_bytes() and ref.endswith("roll.gif")
    paths = []
    for i, s in enumerate(steps):  # saved files are read back as steps too
        paths.append(tmp_path / f"step{i}.nc")
        write_netcdf(s, paths[-1])
    gifs = visualize_rollout([str(p) for p in paths], ("t2m", "u10m"), str(tmp_path / "plots"))
    assert [g.rsplit("/", 1)[-1] for g in gifs] == ["rollout_t2m.gif", "rollout_u10m.gif"]
    png = plot_wind_speed(steps, 41.0, 29.0, output_path=str(tmp_path / "ws.png"))
    assert (tmp_path / "ws.png").read_bytes()[:4] == b"\x89PNG" and png.endswith("ws.png")
    fig = plot_wind_speed(GlobalPredictionRollout(steps), -33.9, 151.2)
    speeds = GlobalPredictionRollout(steps).wind_speed(-33.9, 151.2)
    np.testing.assert_allclose(fig.axes[0].lines[0].get_ydata(), speeds)

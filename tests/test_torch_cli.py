"""The port's CLI, serverless layer and data CLIs against the JAX package's.

Mirrors tests/test_cli.py and tests/test_serverless.py:

- ``skyrim_tpu_torch.cli``'s argparse flags held to ``skyrim_tpu.cli.main``'s
  click parameters: option strings, choices, defaults and help;
- ``--help``, ``-l``, a bad model and ``-ic file`` without ``--ic-path``;
- an end-to-end ``--device cpu`` forecast from a ``file:`` IC (the small
  Pangu put in place of the registry's), its files equal bit for bit to the
  facade's own;
- the serverless layer against a fake ``modal`` (the stubs of
  tests/test_serverless.py), and the clear error without ``modal``;
- the three data CLIs' ``--help`` and a run on
  tests/test_torch_fetchers.py's fake transports.

JAX is imported inside the tests: the card's machine has no JAX.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

from skyrim_tpu_torch import cli


def test_flags_match_the_jax_cli():
    pytest.importorskip("click")
    pytest.importorskip("jax")
    from skyrim_tpu.cli import IC_CHOICES, MODEL_CHOICES
    from skyrim_tpu.cli import main as jmain

    assert cli.MODEL_CHOICES == MODEL_CHOICES and cli.IC_CHOICES == IC_CHOICES
    actions = {a.dest: a for a in cli.build_parser()._actions if a.dest != "help"}
    assert set(actions) == {p.name for p in jmain.params} | {"device"}
    for p in jmain.params:
        a = actions[p.name]
        assert set(a.option_strings) == set(p.opts) | set(p.secondary_opts), p.name
        assert list(a.choices or []) == list(getattr(p.type, "choices", None) or []), p.name
        assert a.default == p.default and a.help == p.help, p.name
        if p.is_flag:
            assert a.nargs == 0 and a.const is True, p.name
        else:
            assert a.type is p.type.func if hasattr(p.type, "func") else True
    assert actions["device"].default == "cuda"


def test_help_list_and_bad_input(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0 and "--lead_time" in capsys.readouterr().out
    assert cli.main(["-l"]) == 0
    out = capsys.readouterr().out
    for name in ("pangu", "fuxi", "fengwu", "graphcast"):
        assert name in out
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", "nonsense"])
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:
        cli.main(["-m", "dlwp", "-ic", "file"])
    assert e.value.code != 0 and "ic-path" in capsys.readouterr().err
    with pytest.raises(ValueError, match="ic-path"):
        cli.run_forecast("dlwp", "20240501", "0000", 6, "file", "out", "")


def test_forecast_end_to_end_on_cpu(tmp_path, monkeypatch):
    """``-m pangu -ic file --ic-path … -lt 12 --device cpu``: two steps, two
    files, each equal bit for bit to the facade's on the same IC."""
    pytest.importorskip("jax")
    from test_torch_facade import CFG, START, _write_ic

    from skyrim_tpu_torch import models
    from skyrim_tpu_torch.core import Skyrim
    from skyrim_tpu_torch.io import SaveConfig, load_forecast
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

    monkeypatch.setenv("SKYRIM_WEIGHTS_DIR", str(tmp_path / "weights"))
    monkeypatch.setitem(models.MODELS, "pangu",
                        lambda device="cuda": PanguModel("pangu", cfg=PanguConfig(**CFG), device=device))
    ic = tmp_path / "ic.nc"
    _write_ic(ic)
    date = START.strftime("%Y%m%d")
    argv = ["-m", "pangu", "-ic", "file", "--ic-path", str(ic), "-d", date, "-lt", "12", "-o", str(tmp_path / "cli"),
            "-f", "t2m,msl", "--device", "cpu"]
    assert cli.main(argv) == 0
    # the first file's name embeds the whole IC source, its path included
    # (core/model.py, as the JAX package names it)
    files = sorted((tmp_path / "cli").rglob("*.nc"), key=lambda f: f.name[-20:])
    assert len(files) == 2
    _, paths = Skyrim("pangu", ic_source=f"file:{ic}", device="cpu").predict(
        date, "0000", 12, save=True, save_config=SaveConfig(output_dir=str(tmp_path / "facade"),
                                                            filter_vars=("t2m", "msl")))
    assert [Path(p).name for p in paths] == [f.name for f in files]
    for f, p in zip(files, paths):
        a, b = load_forecast(str(f)), load_forecast(p)
        assert a.data.shape[-3] == 2
        np.testing.assert_array_equal(a.data, b.data)


# --- serverless ---------------------------------------------------------------------


@pytest.fixture
def fake_modal(monkeypatch):
    from test_serverless import _FakeApp, _FakeImage, _FakeVolume

    mod = types.ModuleType("modal")
    mod.App = _FakeApp
    mod.Image = types.SimpleNamespace(debian_slim=lambda: _FakeImage())
    mod.Volume = types.SimpleNamespace(from_name=lambda name, create_if_missing=False: _FakeVolume(name))
    mod.forward = None
    monkeypatch.setitem(sys.modules, "modal", mod)
    _FakeVolume.instances.clear()
    return _FakeVolume


def test_build_app_wiring(fake_modal):
    from skyrim_tpu_torch.serverless import REQUIREMENTS, build_app

    app, run_inference = build_app()
    assert app.name.startswith("skyrim-tpu-torch-forecast-") and run_inference in app.functions
    meta = run_inference.meta
    assert "/outputs" in meta["volumes"] and meta["timeout"] == 900 and meta["gpu"] == "H100"
    pip = meta["image"].pip
    assert "skyrim-tpu" in pip and set(REQUIREMENTS) <= set(pip)
    assert not any("jax" in p or "flax" in p or "optax" in p for p in pip)


def test_run_remote_and_run_inference(fake_modal, monkeypatch):
    from skyrim_tpu_torch import serverless

    assert serverless.run_remote(model_name="pangu", date="20240507", lead_time=24)["dispatched"]["model_name"] == "pangu"
    assert serverless.main(model_name="dlwp")["dispatched"] == {"model_name": "dlwp"}
    app, run_inference = serverless.build_app()
    monkeypatch.setattr(cli, "run_forecast", lambda **kw: {"ok": kw})
    assert run_inference(model_name="pangu", output_dir="/outputs")["ok"]["model_name"] == "pangu"
    vol = fake_modal.instances[-1]
    assert vol.commits == 1
    run_inference(model_name="pangu", output_dir="s3://bkt/x")
    assert vol.commits == 1


def test_cli_remote_flag_dispatches(fake_modal, monkeypatch):
    from skyrim_tpu_torch import serverless

    sent = []
    monkeypatch.setattr(serverless, "run_remote", lambda **kw: sent.append(kw))
    assert cli.main(["--modal", "-m", "fuxi", "-lt", "24", "-ic", "synthetic"]) == 0
    assert sent[0]["model_name"] == "fuxi" and sent[0]["lead_time"] == 24 and sent[0]["initial_conditions"] == "synthetic"


def test_analysis_app_and_missing_modal(fake_modal, monkeypatch):
    from skyrim_tpu_torch.serverless import _require_modal, build_analysis_app

    app, run_analysis, token = build_analysis_app(token="tok123")
    assert app.name.startswith("skyrim-tpu-torch-analysis-") and token == "tok123"
    assert run_analysis.meta["timeout"] == 86400 and "/outputs" in run_analysis.meta["volumes"]
    monkeypatch.setitem(sys.modules, "modal", None)
    with pytest.raises(RuntimeError, match="modal"):
        _require_modal()


# --- the data CLIs --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gfs", "ifs", "ens"])
def test_data_cli_help(name, capsys):
    import importlib

    mod = importlib.import_module(f"skyrim_tpu_torch.data.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and f"python -m skyrim_tpu_torch.data.{name}" in out
    for flag in ("--date", "--time", "--lead_time", "--channels", "--members" if name == "ens" else "--output_dir"):
        assert flag in out
    with pytest.raises(SystemExit):
        mod.main([])  # --date is required


def test_data_clis_on_fake_transports(tmp_path, monkeypatch, capsys):
    """GFS and IFS save a forecast and print its path (the JAX fetchers'
    Field on the same transport); ENS prints the members' Field."""
    pytest.importorskip("jax")
    from test_torch_fetchers import FakeECMWF, FakeGFS, _gfs_levels

    from skyrim_tpu_torch.data import ens, gfs, ifs
    from skyrim_tpu_torch.io import load_forecast

    for mod in ("skyrim_tpu_torch.data.nwp_base", "skyrim_tpu.data.nwp_base"):
        monkeypatch.setattr(f"{mod}.LOCAL_CACHE", str(tmp_path / "cache" / mod))
    from skyrim_tpu.data import gfs as jgfs

    t = FakeGFS(_gfs_levels(["u10m", "t2m"]))
    gfs.main(["--date", "20240507", "--lead_time", "6", "--channels", "u10m,t2m", "--output_dir",
              str(tmp_path / "gfs")], transport=t)
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert Path(path).name == "gfs__gfs__20240507_00:00__20240507_06:00.nc"
    ref = jgfs.GFSModel(["u10m", "t2m"], transport=t, cache=False).forecast(
        __import__("datetime").datetime(2024, 5, 7), 6)
    np.testing.assert_array_equal(load_forecast(path).data, ref.data)

    e = FakeECMWF([("10u", "sfc", None, None), ("2t", "sfc", None, None)])
    ifs.main(["--date", "20240507", "--lead_time", "6", "--channels", "u10m,t2m", "--output_dir",
              str(tmp_path / "ifs")], transport=e)
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert Path(path).name == "ifs__ifs__20240507_00:00__20240507_06:00.nc" and Path(path).exists()

    e = FakeECMWF([(p, "sfc", None, m) for p in ("10u",) for m in (None, 1)])
    ens.main(["--date", "20240507", "--lead_time", "6", "--channels", "u10m", "--members", "2"], transport=e)
    assert "Field" in capsys.readouterr().out

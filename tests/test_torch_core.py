"""The port end to end: GlobalModel, IC sources, NetCDF output, imports, devices.

The end-to-end test writes a ``file:`` IC with the JAX package, runs
``GlobalModel("pangu").rollout(save=True)`` in both packages on the same
parameters, and compares the files: the same names, coordinates and
attributes, and fields within the golden bf16 tolerance
(tol = 3e-2·std, tests/test_golden.py:74, on mean, spread and RMS of
the difference; 10·tol elementwise).
"""

import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from skyrim_tpu_torch.core import GlobalModel
from skyrim_tpu_torch.data import get_data_source
from skyrim_tpu_torch.io import SaveConfig, load_forecast
from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel

jax = pytest.importorskip("jax")  # the card's machine has no JAX

CFG = dict(lat=49, lon=96, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2))
START = datetime.datetime(2024, 5, 1, 0)
REPO = Path(__file__).resolve().parents[1]


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


def test_global_model_rollout_matches_jax(tmp_path):
    from skyrim_tpu.core.model import GlobalModel as JGlobalModel
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast
    from skyrim_tpu.models.pangu import PanguConfig as JConfig

    from skyrim_tpu_torch.params import from_jax

    ic = tmp_path / "ic.nc"
    _write_ic(ic)
    jgm = JGlobalModel("pangu", ic_source=f"file:{ic}", model_kwargs={"cfg": JConfig(**CFG)},
                       params=_jax_params(JConfig(**CFG)))
    gm = GlobalModel("pangu", ic_source=f"file:{ic}", model_kwargs={"cfg": PanguConfig(**CFG)},
                     params=from_jax(jax.tree.map(np.asarray, jgm.params), _port_model()),
                     device="cpu")
    _, jpaths = jgm.rollout(START, n_steps=2, save=True,
                            save_config=JSaveConfig(forecast_id="fc", output_dir=str(tmp_path / "jax")))
    _, paths = gm.rollout(START, n_steps=2, save=True,
                          save_config=SaveConfig(forecast_id="fc", output_dir=str(tmp_path / "torch")))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths]
    # after the first step the source label is "file" (the first file's
    # label is the whole ic_source string, in both packages)
    assert Path(paths[1]).name == "pangu__file__20240501_06:00__20240501_12:00.nc"
    for p, jp in zip(paths, jpaths):
        out, ref = load_forecast(p), j_load_forecast(jp)
        assert out.dims == ref.dims and out.attrs == ref.attrs
        for dim in ref.dims:
            np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
        assert out.data.shape == ref.data.shape == (1, 69, 49, 96)
        d, r = out.data.astype(np.float64), ref.data.astype(np.float64)
        tol = 3e-2 * r.std()
        assert abs(d.mean() - r.mean()) < tol and abs(d.std() - r.std()) < tol
        assert np.sqrt(((d - r) ** 2).mean()) < tol and np.abs(d - r).max() < 10 * tol


def _jax_params(cfg):
    from skyrim_tpu.models.pangu import PanguModel as JModel

    return JModel("pangu", cfg=cfg).init_params(jax.random.key(0))


def _port_model():
    return PanguModel("pangu", cfg=PanguConfig(**CFG), device="cpu")


def test_forecast_and_predict_one_step(tmp_path):
    gm = GlobalModel("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)},
                     seed=1, device="cpu")
    fc = gm.forecast(START, n_steps=2, channels=["t2m", "z500"])
    assert fc.data.shape == (3, 2, 49, 96) and np.isfinite(fc.data).all()
    assert list(fc.coords["channel"]) == ["t2m", "z500"]
    assert fc.coords["time"][-1] == np.datetime64("2024-05-01T12:00", "ns")

    ic = tmp_path / "ic.nc"
    ic_data = _write_ic(ic)
    one = gm.predict_one_step(START, initial_condition=str(ic))
    assert one.data.shape == (2, 69, 49, 96)
    np.testing.assert_array_equal(one.data[0], ic_data[0])


def test_synthetic_ic_is_reproducible_across_processes():
    """The synthetic source seeds from a CRC32, not Python's salted hash."""
    from skyrim_tpu_torch.grid import LatLonGrid

    src = get_data_source(["t2m", "z500"], "synthetic", grid=LatLonGrid(19, 36))
    here = float(src.fetch(START).data.astype(np.float64).sum())
    code = (
        "import datetime, numpy as np\n"
        "from skyrim_tpu_torch.data import get_data_source\n"
        "from skyrim_tpu_torch.grid import LatLonGrid\n"
        "s = get_data_source(['t2m', 'z500'], 'synthetic', grid=LatLonGrid(19, 36))\n"
        "print(repr(float(s.fetch(datetime.datetime(2024, 5, 1)).data.astype(np.float64).sum())))\n"
    )
    env = dict(os.environ, PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    assert float(out.stdout.strip()) == here


def test_default_device_raises_without_cuda(monkeypatch):
    """No silent CPU fallback: the entry points default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PanguModel("pangu", cfg=PanguConfig(**CFG))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GlobalModel("pangu", ic_source="synthetic", model_kwargs={"cfg": PanguConfig(**CFG)})
    assert PanguModel("pangu", cfg=PanguConfig(**CFG), device="cpu").device.type == "cpu"
    from skyrim_tpu_torch.models.graphcast import GraphCastConfig, GraphCastModel

    tiny = GraphCastConfig(lat=19, lon=36, in_channels=4, latent=16, processor_rounds=2, mesh_refinements=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphCastModel(tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GlobalModel("graphcast", ic_source="synthetic", model_kwargs={"cfg": tiny})


def test_port_imports_no_jax_and_no_skyrim_tpu():
    """Every module of the port and chip_smoke.py import with the optional
    host packages the card's machine lacks blocked, and pull in neither
    jax, flax nor skyrim_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('pandas', 'fsspec', 'matplotlib', 'imageio', 'huggingface_hub'): sys.modules[m] = None\n"
        "import skyrim_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(skyrim_tpu_torch.__path__, 'skyrim_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "gc = {'skyrim_tpu_torch.models.graphcast', 'skyrim_tpu_torch.ops.graph_kernels',\n"
        "      'skyrim_tpu_torch.ops.fused_mlp', 'skyrim_tpu_torch.ops.graph', 'skyrim_tpu_torch.data.solar'}\n"
        "io = {'skyrim_tpu_torch.' + m for m in ('data.grib', 'data.gribcore', 'data.idx', 'data.vocab',\n"
        "      'data.schedules', 'data.regrid', 'data.transport', 'data.nwp_base', 'data.gfs', 'data.ifs',\n"
        "      'data.ens', 'data.cds', 'data.openmeteo', 'data.observations', 'io.zarrlite', 'evaluate',\n"
        "      'plotting')}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'skyrim_tpu'))\n"
        "print(len(names), bad, sorted(gc - set(sys.modules)), sorted(io - set(names)))\n"
        "sys.exit(1 if bad or gc - set(sys.modules) or io - set(names) or len(names) < 20 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr

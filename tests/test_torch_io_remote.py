"""The port's output layer against the JAX package's: Zarr stores, remote
targets and ``stream_save_forecast``.

- Zarr written by the port is read by the JAX package's ``read_zarr`` and
  the reverse, and the two packages' stores from the same Field are equal
  key for key and byte for byte (metadata and zlib chunks), appends
  included.
- ``save_forecast`` to a local Zarr, to fsspec's ``memory://`` store (Zarr
  and NetCDF), and to ``hf://`` through a stub ``huggingface_hub`` put in
  ``sys.modules``; ``remote_forecast_exists``, ``load_forecast`` and
  ``read_forecast`` on them.
- ``stream_save_forecast`` on the small DLWP configuration of
  tests/test_torch_dlwp.py (face 16, 73x144, two frames a call) against
  the JAX package's from the same parameters and IC, both in f32: float32
  within 3e-5 (tests/ops/test_fused_block.py:49), float16 with
  ``filter_vars`` within one float16 ulp of JAX's and equal bit for bit to
  the port's own ``stream_rollout`` frames cast to float16; a slow writer
  (so a reused frame buffer would show as a wrong frame) and a failing
  writer (raised, not swallowed).

JAX and fsspec are imported inside the tests (fsspec by
``pytest.importorskip``): the card's machine has neither and runs only the
``gpu`` test of this file.
"""

import datetime
import io
import sys
import threading
import time
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import skyrim_tpu_torch
from skyrim_tpu_torch.field import Field
from skyrim_tpu_torch.io import SaveConfig, load_forecast, read_forecast, save_forecast, stream_save_forecast
from skyrim_tpu_torch.io import save as save_mod
from skyrim_tpu_torch.io.zarrlite import DirectoryStore, ZarrStore, open_store, read_zarr, write_zarr

T0 = datetime.datetime(2024, 5, 1, 0)
CHANNELS = ["t2m", "u10m", "v10m", "z500"]


def _forecast(n=3, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(280, 10, (n, len(CHANNELS), 19, 36)).astype(np.float32)
    times = [T0 + datetime.timedelta(hours=6 * (i + 1)) for i in range(n)]
    return Field.from_canonical(data, times, CHANNELS, np.linspace(90, -90, 19), np.arange(36) * 10.0,
                                attrs={"source": "test"})


def _jax_field(f):
    from skyrim_tpu.field import Field as JField

    return JField(f.data, f.dims, dict(f.coords), dict(f.attrs), name=f.name)


def _store_bytes(store):
    return {k: store[k] for k in sorted(store.list_prefix(""))}


def assert_fields_equal(out, ref):
    assert tuple(out.dims) == tuple(ref.dims) and out.attrs == ref.attrs
    for dim in ref.dims:
        np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
    assert out.data.dtype == ref.data.dtype
    np.testing.assert_array_equal(out.data, ref.data)


# --- Zarr -------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 4])
def test_zarr_stores_interchange_with_jax(tmp_path, level):
    """The same Field written and appended by both packages: equal stores,
    each read by the other package's reader."""
    from skyrim_tpu.io import zarrlite as jz

    f = _forecast(4)
    for pkg, z, ff in (("torch", sys.modules[ZarrStore.__module__], f), ("jax", jz, _jax_field(f))):
        zs = z.ZarrStore(z.open_store(tmp_path / f"{pkg}.zarr"), level=level, workers=3)
        zs.write_field(ff.isel(time=[0]), channel_chunk=3)
        for i in (1, 2, 3):
            zs.append_field(ff.isel(time=[i]))
    port, jax_store = DirectoryStore(tmp_path / "torch.zarr"), DirectoryStore(tmp_path / "jax.zarr")
    assert _store_bytes(port) == _store_bytes(jax_store)
    assert ".zmetadata" in port and "forecast/3.1.0.0" in port  # channel chunks 3 + a padded 1
    assert_fields_equal(read_zarr(tmp_path / "jax.zarr"), jz.read_zarr(tmp_path / "torch.zarr"))
    back = read_zarr(tmp_path / "torch.zarr")
    np.testing.assert_array_equal(back.data, f.data)
    np.testing.assert_array_equal(back.coords["time"], f.coords["time"])
    assert back.attrs == {"source": "test"}


def test_write_zarr_append_and_float16(tmp_path):
    from skyrim_tpu.io.zarrlite import read_zarr as j_read_zarr

    f = _forecast(3)
    half = Field(f.data.astype(np.float16), f.dims, dict(f.coords), dict(f.attrs))
    write_zarr(half.isel(time=[0]), tmp_path / "h.zarr")
    write_zarr(half.isel(time=[1, 2]), tmp_path / "h.zarr", append=True)
    back = read_zarr(tmp_path / "h.zarr")
    assert back.data.dtype == np.float16
    np.testing.assert_array_equal(back.data, half.data)
    np.testing.assert_array_equal(j_read_zarr(tmp_path / "h.zarr").data, half.data)
    with pytest.raises(ValueError, match="no data variable"):
        ZarrStore(open_store(tmp_path / "empty.zarr")).read_field()


def test_save_forecast_zarr_local_equals_jax(tmp_path):
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.io.save import load_forecast as j_load_forecast
    from skyrim_tpu.io.save import save_forecast as j_save_forecast

    f = _forecast(3)
    paths = {}
    for pkg, save, cfg in (("torch", save_forecast, SaveConfig), ("jax", j_save_forecast, JSaveConfig)):
        ff = f if pkg == "torch" else _jax_field(f)
        c = cfg(forecast_id="fc", output_dir=str(tmp_path / pkg), file_type="zarr", filter_vars=("t2m", "z500"))
        for i in range(3):
            paths[pkg] = save(ff.isel(time=[i]), "pangu", T0, T0, "gfs", c)
    assert paths["torch"] == str(tmp_path / "torch" / "fc.zarr")
    assert _store_bytes(DirectoryStore(paths["torch"])) == _store_bytes(DirectoryStore(paths["jax"]))
    out = load_forecast(paths["torch"])
    assert_fields_equal(out, j_load_forecast(paths["jax"]))
    assert out.sizes == {"time": 3, "channel": 2, "lat": 19, "lon": 36}
    assert out.attrs == {"source": "test", "model": "pangu", "ic_source": "gfs", "forecast_id": "fc"}
    assert_fields_equal(read_forecast(str(tmp_path / "torch"), "fc"), out)
    assert skyrim_tpu_torch.read_forecast is read_forecast
    # a store directory without the suffix is read as Zarr too
    Path(paths["torch"]).rename(tmp_path / "renamed")
    assert_fields_equal(load_forecast(str(tmp_path / "renamed")), out)


# --- remote targets ---------------------------------------------------------------


def test_fsspec_memory_targets(tmp_path):
    """Zarr by default and NetCDF on request, on fsspec's memory store; the
    NetCDF bytes are those the JAX package writes to a local file (its
    write_netcdf_bytes loses its buffer to netcdf_file.close(): ROADMAP.md
    §3)."""
    fsspec = pytest.importorskip("fsspec")
    from skyrim_tpu.io.netcdf import write_netcdf as j_write_netcdf

    f = _forecast(2)
    base = "memory://skyrim-port-test"
    cfg = SaveConfig(forecast_id="mem", output_dir=base)
    assert not save_mod.remote_forecast_exists(f"{base}/mem.zarr")
    for i in range(2):
        target = save_forecast(f.isel(time=[i]), "pangu", T0, T0, "gfs", cfg)
    assert target == f"{base}/mem.zarr" and save_mod.remote_forecast_exists(target)
    back = read_forecast(base, "mem")
    np.testing.assert_array_equal(back.data, f.data)
    assert_fields_equal(load_forecast(target), back)
    nc = save_forecast(f.isel(time=[0]), "pangu", T0, T0 + datetime.timedelta(hours=6), "gfs",
                       SaveConfig(forecast_id="mem", output_dir=base, file_type="netcdf"))
    assert nc == f"{base}/mem/pangu__gfs__20240501_00:00__20240501_06:00.nc"
    with fsspec.open(nc, "rb") as fh:
        raw = fh.read()
    expected = f.isel(time=[0]).assign_attrs(model="pangu", ic_source="gfs", forecast_id="mem")
    j_write_netcdf(_jax_field(expected), tmp_path / "ref.nc")
    assert raw == (tmp_path / "ref.nc").read_bytes()
    np.testing.assert_array_equal(load_forecast(nc).data, f.data[:1])
    fsspec.filesystem("memory").rm("/skyrim-port-test", recursive=True)
    assert not save_mod.remote_forecast_exists(f"{base}/mem.zarr")


class _StubHfApi:
    uploads = []

    def upload_file(self, path_or_fileobj, path_in_repo, repo_id, repo_type):
        self.uploads.append((Path(path_or_fileobj).read_bytes(), path_in_repo, repo_id, repo_type))


def test_hf_target_through_stub(tmp_path, monkeypatch):
    """hf://org/repo/sub → a zipped Zarr handed to HfApi.upload_file; the
    same archive members and bytes as the JAX package's."""
    from skyrim_tpu.io import save as jsave

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(HfApi=_StubHfApi))
    monkeypatch.setattr(save_mod, "LOCAL_CACHE", str(tmp_path / "torch"))
    monkeypatch.setattr(jsave, "LOCAL_CACHE", str(tmp_path / "jax"))
    _StubHfApi.uploads.clear()
    f = _forecast(1)
    url = save_forecast(f, "pangu", T0, T0, "gfs", SaveConfig(forecast_id="hf1", output_dir="hf://org/repo/runs/"))
    jurl = jsave.save_forecast(_jax_field(f), "pangu", T0, T0, "gfs",
                               jsave.SaveConfig(forecast_id="hf1", output_dir="hf://org/repo/runs/"))
    assert url == jurl == "hf://org/repo/runs/hf1.zarr.zip"
    (blob, path_in_repo, repo_id, repo_type), (jblob, *jrest) = _StubHfApi.uploads
    assert (path_in_repo, repo_id, repo_type) == tuple(jrest) == ("runs/hf1.zarr.zip", "org/repo", "dataset")
    zf, jzf = zipfile.ZipFile(io.BytesIO(blob)), zipfile.ZipFile(io.BytesIO(jblob))
    assert sorted(zf.namelist()) == sorted(jzf.namelist())
    for name in zf.namelist():
        assert zf.read(name) == jzf.read(name)
    zf.extractall(tmp_path / "unzipped")
    back = read_zarr(tmp_path / "unzipped")
    np.testing.assert_array_equal(back.data, f.data)
    assert back.attrs["forecast_id"] == "hf1"


def test_hf_target_without_huggingface_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is required for hf:// targets"):
        save_forecast(_forecast(1), "pangu", T0, T0, "gfs", SaveConfig(output_dir="hf://org/repo"))


# --- stream_save_forecast ---------------------------------------------------------


@pytest.fixture(scope="module")
def dlwp():
    """tests/test_torch_dlwp.py's small pair, computing in f32, and a
    two-frame IC."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from test_torch_dlwp import SMALL, _drawn, _jax_class

    from skyrim_tpu_torch.models.dlwp import DLWPModel
    from skyrim_tpu_torch.params import from_jax

    jmodel = _jax_class()()
    tree = _drawn(jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(0))), 0)
    model = DLWPModel(**SMALL, device="cpu")
    jmodel.compute_dtype, model.compute_dtype = jnp.float32, torch.float32
    ic = np.random.default_rng(5).normal(size=(2, 7, 73, 144)).astype(np.float32)
    return jmodel, tree, model, from_jax(tree, model), ic


def _frames(model, params, ic, n_steps, **kw):
    from skyrim_tpu_torch.rollout import stream_rollout

    state = model.init_state(params, ic, start_time=T0)
    return np.stack(list(stream_rollout(model, params, state, n_steps, **kw)))


def test_stream_save_f32_matches_jax(dlwp, tmp_path):
    from skyrim_tpu.io.save import stream_save_forecast as j_stream_save

    jmodel, tree, model, params, ic = dlwp
    target = stream_save_forecast(model, params, ic, T0, 4, ic_source="gfs",
                                  config=SaveConfig(forecast_id="s32", output_dir=str(tmp_path / "torch")),
                                  writer_threads=3)
    jtarget = j_stream_save(jmodel, tree, ic, T0, 4, ic_source="gfs",
                            config={"forecast_id": "s32", "output_dir": str(tmp_path / "jax")}, writer_threads=3)
    assert target == str(tmp_path / "torch" / "s32.zarr")
    out, ref = read_zarr(target), read_zarr(jtarget)
    assert out.data.shape == (4, 7, 73, 144) and out.data.dtype == ref.data.dtype == np.float32
    assert out.attrs == ref.attrs == {"model": "dlwp", "ic_source": "gfs", "forecast_id": "s32"}
    for dim in ref.dims:
        np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
    np.testing.assert_allclose(out.data, ref.data, atol=3e-5, rtol=0)
    np.testing.assert_array_equal(out.data, _frames(model, params, ic, 4))
    store = DirectoryStore(target)
    assert sorted(k for k in store.list_prefix("forecast") if not k.endswith(("zarray", "zattrs"))) == \
        sorted(k for k in DirectoryStore(jtarget).list_prefix("forecast") if not k.endswith(("zarray", "zattrs")))


def test_stream_save_f16_filter_vars(dlwp, tmp_path):
    from skyrim_tpu.io.save import stream_save_forecast as j_stream_save

    jmodel, tree, model, params, ic = dlwp
    names = list(model.channels)
    keep = (names[5], names[0], names[3])
    cfg = {"forecast_id": "s16", "output_dir": str(tmp_path / "torch"), "filter_vars": keep}
    out = read_zarr(stream_save_forecast(model, params, ic, T0, 3, config=cfg, save_dtype="float16"))
    ref = read_zarr(j_stream_save(jmodel, tree, ic, T0, 3, config=dict(cfg, output_dir=str(tmp_path / "jax")),
                                  save_dtype="float16"))
    assert out.data.dtype == ref.data.dtype == np.float16 and out.data.shape == (3, 3, 73, 144)
    assert list(out.coords["channel"]) == list(keep) == list(ref.coords["channel"])
    idx = [names.index(c) for c in keep]
    np.testing.assert_array_equal(out.data, _frames(model, params, ic, 3)[:, idx].astype(np.float16))
    np.testing.assert_array_equal(out.data, _frames(model, params, ic, 3, transfer_dtype=torch.float16,
                                                    channel_idx=tuple(idx)))
    np.testing.assert_allclose(out.data.astype(np.float32), ref.data.astype(np.float32), rtol=2**-10, atol=3e-5)


def test_stream_save_slow_writer(dlwp, tmp_path, monkeypatch):
    """Each append waits: the rollout runs ahead as far as the queue lets
    it, and every stored frame is still its own step's."""
    jmodel, tree, model, params, ic = dlwp
    append = ZarrStore.append_field

    def slow(self, *a, **kw):
        time.sleep(0.15)
        return append(self, *a, **kw)

    monkeypatch.setattr(ZarrStore, "append_field", slow)
    target = stream_save_forecast(model, params, ic, T0, 6, config={"forecast_id": "slow",
                                                                    "output_dir": str(tmp_path)})
    out = read_zarr(target)
    np.testing.assert_array_equal(out.data, _frames(model, params, ic, 6))
    assert list(out.coords["time"]) == [np.datetime64(T0 + datetime.timedelta(hours=6 * (i + 1)), "ns")
                                        for i in range(6)]


def test_stream_save_writer_failure_is_raised(dlwp, tmp_path, monkeypatch):
    """A writer that fails on its second step: the error reaches the
    caller after the writer has ended, with the queue full, no hang."""
    jmodel, tree, model, params, ic = dlwp

    def failing(self, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ZarrStore, "append_field", failing)
    raised = []

    def run():
        try:
            stream_save_forecast(model, params, ic, T0, 10, config={"forecast_id": "fail", "output_dir": str(tmp_path)})
        except OSError as e:
            raised.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "stream_save_forecast still waits for a writer that has ended"
    assert len(raised) == 1 and "disk full" in str(raised[0])
    assert not (tmp_path / "fail.zarr" / ".zmetadata").exists() or read_zarr(tmp_path / "fail.zarr").sizes["time"] == 1


@pytest.mark.gpu
def test_stream_save_on_the_card(tmp_path):
    """On a CUDA device the cast and the channel subset happen on the card:
    the stored float16 frames are the card's f32 frames cast, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from skyrim_tpu_torch.grid import LatLonGrid
    from skyrim_tpu_torch.models.dlwp import DLWPModel

    model = DLWPModel(face_size=16, features=(8, 16), grid=LatLonGrid(73, 144), device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    ic = np.random.default_rng(5).normal(size=(2, 7, 73, 144)).astype(np.float32)
    keep = tuple(model.channels[i] for i in (4, 1))
    out = read_zarr(stream_save_forecast(model, params, ic, T0, 4, save_dtype="float16",
                                         config={"forecast_id": "card", "output_dir": str(tmp_path),
                                                 "filter_vars": keep}))
    ref = _frames(model, params, ic, 4)[:, [4, 1]]
    np.testing.assert_array_equal(out.data, torch.from_numpy(ref).cuda().half().cpu().numpy())

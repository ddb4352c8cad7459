"""The port's IC sources against the JAX package's, through shared fakes.

Each fetcher of both packages reads the same bytes from one fake
transport (the pattern of tests/data/test_fetchers.py): NOAA ``.idx``
text and GRIB2 byte ranges for GFS, ECMWF JSON-lines ``.index`` files for
IFS and ENS, a fake CDS retrieval for ERA5.  The Fields must be equal bit
for bit (data, coordinates, attributes); the byte-range cache must serve
a second fetch without a ranged call; a channel whose fetch fails must
come back as NaN with a warning in both packages.  Then the source
dispatch for every name, ``get_ic``, and
``Skyrim("pangu", ic_source="gfs")`` at a small width on the canonical
721x1440 grid (the GFS source always lands there) against the JAX
facade at the golden tolerance (tol = 3e-2·std, tests/test_golden.py:74,
on mean, spread and RMS of the difference; 10·tol elementwise).

JAX is imported by ``pytest.importorskip`` at collection: the card's
machine has no JAX and skips this file.
"""

import contextlib
import datetime
import json
import logging
import struct
from pathlib import Path

import numpy as np
import pytest

from skyrim_tpu_torch.data import cds, ens, get_data_source, gfs, grib, ifs
from skyrim_tpu_torch.data.transport import TransportError

pytest.importorskip("jax")
from skyrim_tpu.data import cds as jcds  # noqa: E402
from skyrim_tpu.data import ens as jens  # noqa: E402
from skyrim_tpu.data import gfs as jgfs  # noqa: E402
from skyrim_tpu.data import ifs as jifs  # noqa: E402

T0 = datetime.datetime(2024, 5, 7, 0)
SMALL = (37, 72)  # messages on a 5° grid, regridded onto 721x1440 by the fetchers


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Each package's byte-range cache in its own temporary directory."""
    for mod, sub in (("skyrim_tpu.data.nwp_base", "jax"), ("skyrim_tpu.data.cds", "jax"),
                     ("skyrim_tpu_torch.data.nwp_base", "torch"), ("skyrim_tpu_torch.data.cds", "torch")):
        monkeypatch.setattr(f"{mod}.LOCAL_CACHE", str(tmp_path / "cache" / sub))
    return tmp_path / "cache"


@contextlib.contextmanager
def warnings_logged():
    """The warnings both packages' loggers emit inside the block."""
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    loggers = [logging.getLogger(n) for n in ("skyrim_tpu", "skyrim_tpu_torch")]
    for lg in loggers:
        lg.addHandler(handler)
    try:
        yield records
    finally:
        for lg in loggers:
            lg.removeHandler(handler)


def _seeded(*key, shape=SMALL, scale=10.0):
    seed = sum(ord(c) * (i + 1) for i, c in enumerate("|".join(map(str, key)))) % 2**32
    return np.random.default_rng(seed).normal(size=shape) * scale


def _grid_kw(shape, lon_first=0.0):
    H, W = shape
    step = 360.0 / W
    return dict(lat_first=90.0, lat_last=-90.0, lon_first=lon_first, lon_last=lon_first + 360.0 - step)


def assert_fields_equal(out, ref):
    assert out.dims == ref.dims and out.attrs == ref.attrs and out.coords.keys() == ref.coords.keys()
    for dim in ref.coords:
        np.testing.assert_array_equal(out.coords[dim], ref.coords[dim])
    assert out.data.dtype == ref.data.dtype
    np.testing.assert_array_equal(out.data, ref.data)


# --- GFS --------------------------------------------------------------------------


class FakeGFS:
    """NOAA-style files for any key: one GRIB2 message per (PARAM, level),
    each a seeded field that depends on the key (so on the cycle and
    step), with its ``.idx``; byte ranges honoured.  Ranged reads of the
    messages in ``fail`` raise."""

    def __init__(self, levels, shape=SMALL, fail=(), make=None):
        self.levels, self.shape, self.fail = list(levels), shape, set(fail)
        self.make = make or (lambda param, level, key: grib.encode_simple(
            _seeded(param, level, key, shape=shape), **_grid_kw(shape)))
        self.files, self.failing, self.calls = {}, set(), []

    def _build(self, base):
        parts, lines, offset = [], [], 0
        for i, (param, level) in enumerate(self.levels):
            lines.append(f"{i + 1}:{offset}:d=2024050700:{param}:{level}:anl:")
            if (param, level) in self.fail:
                self.failing.add(offset)
            parts.append(self.make(param, level, base))
            offset += len(parts[-1])
        self.files[base] = b"".join(parts)
        self.files[base + ".idx"] = "\n".join(lines).encode()

    def __call__(self, url, offset=None, length=None):
        self.calls.append((url, offset, length))
        key = url.split(".com/")[1]
        base = key[:-4] if key.endswith(".idx") else key
        if base not in self.files:
            self._build(base)
        if offset is not None and offset in self.failing:
            raise TransportError(f"GET {url} failed")
        data = self.files[key]
        return data if offset is None else data[offset:offset + length]

    def ranged(self):
        return len([c for c in self.calls if c[1] is not None])


def _gfs_levels(channels):
    from skyrim_tpu_torch.data.vocab import GFS_VOCAB

    return [(GFS_VOCAB[c].provider_id, GFS_VOCAB[c].levtype) for c in channels]


GFS_CHANNELS = ["u10m", "t2m", "z500", "q850", "msl"]


@pytest.mark.parametrize("cache", [True, False])
def test_gfs_fields_equal_jax(cache, caches):
    transport = FakeGFS(_gfs_levels(GFS_CHANNELS))
    port = gfs.GFSModel(GFS_CHANNELS, transport=transport, cache=cache)
    ref = jgfs.GFSModel(GFS_CHANNELS, transport=transport, cache=cache).fetch_dataarray(T0, [0, 6])
    out = port.fetch_dataarray(T0, [0, 6])
    assert_fields_equal(out, ref)
    assert out.sizes == {"time": 2, "channel": 5, "lat": 721, "lon": 1440} and np.isfinite(out.data).all()
    assert out.attrs == {"source": "gfs", "init_time": T0.isoformat()}
    # HGT × 9.81 → geopotential, after the regrid
    from skyrim_tpu_torch.data.regrid import to_canonical_grid

    key = gfs.gfs_key(T0, 6)
    hgt = grib.decode_message(transport.make("HGT", "500 mb", key))
    np.testing.assert_array_equal(out.sel(channel="z500").data[1],
                                  to_canonical_grid(hgt.values, hgt.lat, hgt.lon) * 9.81)
    n = transport.ranged()
    port._index_cache.clear()
    again = port.fetch_dataarray(T0, [0, 6])
    assert transport.ranged() == n + (0 if cache else 10)
    np.testing.assert_array_equal(again.data, out.data)
    if cache:  # the same cache keys in both packages
        assert sorted(p.name for p in (caches / "torch" / "gfs").iterdir()) == \
            sorted(p.name for p in (caches / "jax" / "gfs").iterdir())
        assert len(list((caches / "torch" / "gfs").iterdir())) == 10


def test_gfs_failed_channel_is_nan_with_warning():
    transport = FakeGFS(_gfs_levels(GFS_CHANNELS), fail=[("TMP", "2 m above ground")])
    with warnings_logged() as records:
        out = gfs.GFSModel(GFS_CHANNELS, transport=transport, cache=False).fetch_dataarray(T0, [0])
        ref = jgfs.GFSModel(GFS_CHANNELS, transport=transport, cache=False).fetch_dataarray(T0, [0])
    assert_fields_equal(out, ref)
    assert np.isnan(out.sel(channel="t2m").data).all()
    others = [c for c in GFS_CHANNELS if c != "t2m"]
    assert np.isfinite(out.sel(channel=others).data).all()
    msgs = [(r.name, r.getMessage()) for r in records]
    for name in ("skyrim_tpu", "skyrim_tpu_torch"):
        assert any(n == name and "gfs fetch failed for t2m step 0" in m for n, m in msgs), msgs


def test_gfs_full_width_messages_and_source_history():
    """Messages already on the 0.25° grid take the identity regrid;
    GFSSource.fetch with two history frames (06 z and 00 z analyses)."""
    channels = ["u10m", "z500"]
    transport = FakeGFS(_gfs_levels(channels), shape=(721, 1440))
    src = get_data_source(channels, "gfs", transport=transport)
    jsrc = jgfs.GFSSource(channels, transport=transport)
    assert isinstance(src, gfs.GFSSource) and src.client.transport is transport
    t = datetime.datetime(2024, 5, 7, 6)
    out = src.fetch(t, n_history=2)
    assert_fields_equal(out, jsrc.fetch(t, n_history=2))
    np.testing.assert_array_equal(out.coords["time"], np.array(["2024-05-07T00", "2024-05-07T06"],
                                                               dtype="datetime64[ns]"))
    msg = grib.decode_message(transport.make("UGRD", "10 m above ground", gfs.gfs_key(t, 0)))
    np.testing.assert_array_equal(out.sel(channel="u10m").data[1], msg.values)


def test_gfs_predict_and_snipe(tmp_path, monkeypatch):
    from skyrim_tpu_torch.data.schedules import ScheduleError
    from skyrim_tpu_torch.io import load_forecast

    transport = FakeGFS(_gfs_levels(["u10m"]))
    model = gfs.GFSModel(["u10m"], transport=transport, cache=False, max_workers=1)
    jmodel = jgfs.GFSModel(["u10m"], transport=transport, cache=False, max_workers=1)
    field, path = model.predict("20240507", "0000", lead_time=12, time_step=6, save=True,
                                save_config={"output_dir": str(tmp_path / "torch"), "forecast_id": "fc"})
    jfield, jpath = jmodel.predict("20240507", "0000", lead_time=12, time_step=6, save=True,
                                   save_config={"output_dir": str(tmp_path / "jax"), "forecast_id": "fc"})
    assert Path(path).name == Path(jpath).name == "gfs__gfs__20240507_00:00__20240507_12:00.nc"
    assert_fields_equal(field, jfield)
    np.testing.assert_array_equal(load_forecast(path).data, field.data)
    with pytest.raises(ScheduleError):
        model.forecast(T0, lead_time=122)
    monkeypatch.setattr(gfs.GFSModel, "available", lambda self, init: init.hour != 0)
    monkeypatch.setattr(jgfs.GFSModel, "available", lambda self, init: init.hour != 0)
    out, ref = model.snipe("20240507", "1200", 12), jmodel.snipe("20240507", "1200", 12)
    assert sorted(out) == sorted(ref) == ["2024-05-07T06:00:00", "2024-05-07T12:00:00"]
    for k in ref:
        assert_fields_equal(out[k], ref[k])
    assert gfs.GFSModel.list_available_channels() == jgfs.GFSModel.list_available_channels()
    with pytest.raises(ValueError, match="not in GFS vocabulary"):
        gfs.GFSModel(["w500"])


# --- IFS and ENS ------------------------------------------------------------------


class FakeECMWF:
    """ECMWF open-data files for any key: messages encoded from −180°
    (the fetchers roll them to 0..360) with a JSON-lines ``.index``.
    ``entries`` lists (param, levtype, level, member); member None is the
    control.  Missing entries are simply absent from the index."""

    def __init__(self, entries, shape=SMALL):
        self.entries, self.shape, self.files = list(entries), shape, {}

    def _build(self, base):
        blob, index = b"", []
        for param, levtype, level, number in self.entries:
            vals = _seeded(param, level, number, base, shape=self.shape) + (5000.0 if param == "gh" else 0.0)
            msg = grib.encode_simple(vals, **_grid_kw(self.shape, lon_first=-180.0))
            e = {"domain": "g", "param": param, "levtype": levtype, "_offset": len(blob), "_length": len(msg)}
            if level:
                e["levelist"] = level
            if number is not None:
                e["number"] = str(number)
            index.append(json.dumps(e))
            blob += msg
        self.files[base] = blob
        self.files[base.replace(".grib2", ".index")] = "\n".join(index).encode()

    def __call__(self, url, offset=None, length=None):
        key = url.split(".com/")[1]
        base = key.replace(".index", ".grib2")
        if base not in self.files:
            self._build(base)
        data = self.files[key]
        return data if offset is None else data[offset:offset + length]


def test_ifs_fields_equal_jax_with_missing_level():
    """z925 is not published: both interpolate it from 850 and 1000 hPa
    (data/regrid.py, linear in hPa), with a warning."""
    transport = FakeECMWF([("10u", "sfc", None, None), ("2t", "sfc", None, None),
                           ("gh", "pl", "850", None), ("gh", "pl", "1000", None)])
    channels = ["u10m", "t2m", "z850", "z925"]
    with warnings_logged() as records:
        out = ifs.IFSModel(channels, transport=transport, cache=False).fetch_dataarray(T0, [0, 6])
        ref = jifs.IFSModel(channels, transport=transport, cache=False).fetch_dataarray(T0, [0, 6])
    assert_fields_equal(out, ref)
    assert np.isfinite(out.data).all()
    z850, z925 = out.sel(channel="z850").data, out.sel(channel="z925").data
    assert 0 < np.abs(z925 - z850).max()
    msgs = [(r.name, r.getMessage()) for r in records]
    for name in ("skyrim_tpu", "skyrim_tpu_torch"):
        assert any(n == name and "level 925 not published" in m for n, m in msgs), msgs
    assert ifs.ifs_key(T0, 24) == jifs.ifs_key(T0, 24)
    assert [ifs.ifs_stream(h) for h in (0, 6, 12, 18)] == ["oper", "scda", "oper", "scda"]
    with pytest.raises(ValueError, match="0.25° IFS open data starts"):
        ifs.IFSModel(["u10m"], transport=transport).fetch_channel("u10m", datetime.datetime(2024, 1, 1), 0)


def test_ifs_cache_shared_by_threads(monkeypatch):
    """z850 and the interpolated z925 fetch the 850 hPa message at once;
    the two cache writes are held until both have written, then both
    land and the Field is the uncached one.  (The JAX package's shared
    ".part" name loses the second rename there and turns a channel into
    NaN; ROADMAP.md §3.)"""
    import threading

    transport = FakeECMWF([("gh", "pl", "850", None), ("gh", "pl", "1000", None)])
    channels = ["z850", "z925"]
    ref = ifs.IFSModel(channels, transport=transport, cache=False).fetch_dataarray(T0, [0])
    write_bytes, both = Path.write_bytes, threading.Barrier(2, timeout=1.0)

    def held(self, data):
        n = write_bytes(self, data)
        if self.name.endswith(".part"):
            try:
                both.wait()  # the first two writes: the 850 hPa message's
            except threading.BrokenBarrierError:
                pass
        return n

    monkeypatch.setattr(Path, "write_bytes", held)
    for _ in range(2):  # filling the cache, then served from it
        out = ifs.IFSModel(channels, transport=transport).fetch_dataarray(T0, [0])
        assert_fields_equal(out, ref)
        assert np.isfinite(out.data).all()


def test_ifs_04deg_source_and_source_adapter():
    transport = FakeECMWF([("10u", "sfc", None, None)], shape=(451, 900))
    src, jsrc = get_data_source(["u10m"], "ifs", transport=transport), jifs.IFSSource(["u10m"], transport=transport)
    assert isinstance(src, ifs.IFSSource)
    out = src.fetch(datetime.datetime(2024, 5, 7, 12))
    assert out.data.shape == (1, 1, 721, 1440) and np.isfinite(out.data).all()
    assert_fields_equal(out, jsrc.fetch(datetime.datetime(2024, 5, 7, 12)))


def test_ens_members_equal_jax():
    """Control plus two perturbed members; member 3 is not in the index
    and is dropped with a warning in both packages."""
    entries = [(p, lt, lv, n) for n in (None, 1, 2) for p, lt, lv in
               (("10u", "sfc", None), ("gh", "pl", "500"))]
    transport = FakeECMWF(entries)
    with warnings_logged() as records:
        out = ens.ENSModel(["u10m", "z500"], members=[0, 1, 2, 3], transport=transport).fetch_members(T0, [0, 6])
        ref = jens.ENSModel(["u10m", "z500"], members=[0, 1, 2, 3], transport=transport).fetch_members(T0, [0, 6])
    assert_fields_equal(out, ref)
    assert out.dims[0] == "number" and out.data.shape[:3] == (3, 2, 2) and np.isfinite(out.data).all()
    assert not np.array_equal(out.data[0], out.data[1])
    msgs = [(r.name, r.getMessage()) for r in records]
    for name in ("skyrim_tpu", "skyrim_tpu_torch"):
        assert any(n == name and "ENS member 3 failed" in m for n, m in msgs), msgs
    src = get_data_source(["u10m"], "ens", transport=transport)
    assert isinstance(src, ens.ENSSource)
    assert_fields_equal(src.fetch(T0), jens.ENSSource(["u10m"], transport=transport).fetch(T0))


# --- CDS --------------------------------------------------------------------------


class FakeCDS:
    """A CDS retrieval: one message on the canonical grid (CDS does not
    regrid) per requested (day, hour), seeded by the request."""

    def __init__(self):
        self.calls = []

    def __call__(self, dataset, body):
        self.calls.append((dataset, json.dumps(body, sort_keys=True)))
        n = len(body["day"]) * len(body["time"])
        return b"".join(grib.encode_simple(
            np.repeat(np.repeat(_seeded(dataset, body["variable"], i), 20, 0), 20, 1)[:721] + 280.0, nbits=12)
            for i in range(n))


def test_cds_fields_equal_jax_and_cache(tmp_path):
    times = [datetime.datetime(2024, 5, 1, 0), datetime.datetime(2024, 5, 1, 6)]
    for ch in ("z500", "t2m"):
        assert cds.build_request(ch, times) == jcds.build_request(ch, times)
    retrieve = fake = FakeCDS()
    client = cds.CDS(["t2m", "z500"], transport=retrieve)
    out = client.fetch_dataarray(times)
    assert_fields_equal(out, jcds.CDS(["t2m", "z500"], transport=retrieve).fetch_dataarray(times))
    assert out.data.shape == (2, 2, 721, 1440) and np.isfinite(out.data).all()
    n = len(fake.calls)
    np.testing.assert_array_equal(client.fetch_dataarray(times).data, out.data)
    assert len(fake.calls) == n  # served from the cache
    src = get_data_source(["t2m"], "cds", transport=retrieve)
    assert isinstance(src, cds.CDSSource)
    assert_fields_equal(src.fetch(times[1], n_history=2), jcds.CDSSource(["t2m"], transport=retrieve).fetch(
        times[1], n_history=2))
    with pytest.raises(ValueError, match="not in CDS vocabulary"):
        cds.CDS(["nope"])


def test_cds_benchmark_and_dataset_factory(tmp_path):
    from skyrim_tpu.io.netcdf import read_netcdf as j_read_netcdf

    retrieve = FakeCDS()
    client, jclient = cds.CDS(["t2m"], transport=retrieve), jcds.CDS(["t2m"], transport=retrieve)
    assert_fields_equal(client.benchmark("20240501", "0000", lead_time=12, time_step=6),
                        jclient.benchmark("20240501", "0000", lead_time=12, time_step=6))
    start, end = datetime.datetime(2024, 5, 1, 0), datetime.datetime(2024, 5, 1, 18)
    meta = client.create_dataset(start, end, str(tmp_path / "torch"), slice_size=3)
    jmeta = jclient.create_dataset(start, end, str(tmp_path / "jax"), slice_size=3)
    assert meta == jmeta and meta["n_slices"] == 2 and meta["files"] == ["slice_00000.nc", "slice_00001.nc"]
    assert json.loads((tmp_path / "torch" / "metadata.json").read_text()) == meta
    for name in meta["files"]:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        assert j_read_netcdf(tmp_path / "torch" / name).sizes["time"] in (3, 1)


# --- dispatch, get_ic, the facade -------------------------------------------------


def test_get_data_source_dispatch(tmp_path):
    from skyrim_tpu_torch.data import FileSource, SyntheticSource
    from skyrim_tpu_torch.grid import LatLonGrid

    classes = {"gfs": gfs.GFSSource, "GFS": gfs.GFSSource, "ifs": ifs.IFSSource, "ens": ens.ENSSource,
               "cds": cds.CDSSource, "synthetic": SyntheticSource, f"file:{tmp_path}/ic.nc": FileSource}
    for name, cls in classes.items():
        kw = {"grid": LatLonGrid(19, 36)}
        src = get_data_source(["u10m", "t2m"], name, **kw)
        assert type(src) is cls and src.channel_names == ["u10m", "t2m"]
    assert get_data_source(["t2m"], "file", path="x.nc").path == "x.nc"
    with pytest.raises(ValueError, match="file source needs a path"):
        get_data_source(["t2m"], "file")
    with pytest.raises(ValueError, match="unknown IC source"):
        get_data_source(["t2m"], "era6")


def test_get_ic_equals_jax(monkeypatch):
    """get_ic honours its channels and source; the live transport is
    swapped for the fake in both packages."""
    from skyrim_tpu.data import ic as jic

    from skyrim_tpu_torch.data import ic

    transport = FakeGFS(_gfs_levels(["t2m", "z500"]))
    for mod in (ic, jic):
        dispatch = mod.get_data_source
        monkeypatch.setattr(mod, "get_data_source",
                            lambda ch, src, _d=dispatch: _d(ch, src, transport=transport, cache=False))
    out = ic.get_ic(["t2m", "z500"], datetime.datetime(2024, 5, 7, 6), "gfs")
    assert_fields_equal(out, jic.get_ic(["t2m", "z500"], datetime.datetime(2024, 5, 7, 6), "gfs"))
    assert list(out.coords["channel"]) == ["t2m", "z500"] and out.sizes["time"] == 1


def _pangu_messages():
    """A GFS transport for Pangu's 69 channels at 721x1440: three seeded
    base messages, each channel's a copy with its own reference value R
    and binary scale E written into section 5 (distinct fields, cheap)."""
    from skyrim_tpu_torch.channels import PANGU

    levels = _gfs_levels(PANGU)
    rng = np.random.default_rng(7)
    bases = [grib.encode_simple(rng.normal(size=(721, 1440)), nbits=12) for _ in range(3)]

    def make(param, level, key):
        i = levels.index((param, level))
        buf = bytearray(bases[i % 3])
        pos = 16
        while buf[pos + 4] != 5:
            pos += int.from_bytes(buf[pos:pos + 4], "big")
        buf[pos + 11:pos + 15] = struct.pack(">f", -0.5 * i / 69)
        buf[pos + 15:pos + 17] = grib._sm(-12 + i % 2, 2).to_bytes(2, "big")
        return bytes(buf)

    return FakeGFS(levels, make=make)


@pytest.fixture(scope="module")
def pangu_gfs():
    """The GFS transport of Pangu's 69 channels, shared by both tests."""
    return _pangu_messages()


def test_gfs_pangu_ic_equals_jax(pangu_gfs):
    """Pangu's 69 channels from GFS on the canonical grid: the same IC bit
    for bit in both packages, finite, every channel its own field."""
    from skyrim_tpu_torch.channels import PANGU

    start = datetime.datetime(2024, 5, 7, 0)
    ic = get_data_source(PANGU, "gfs", transport=pangu_gfs).fetch(start)
    assert_fields_equal(ic, jgfs.GFSSource(PANGU, transport=pangu_gfs).fetch(start))
    assert ic.data.shape == (1, 69, 721, 1440) and np.isfinite(ic.data).all()
    assert len({float(ic.data[0, c, 0, 0]) for c in range(69)}) == 69


def test_skyrim_pangu_from_gfs_matches_jax(pangu_gfs, tmp_path):
    """Skyrim("pangu") with its default IC source, GFS, through the fake:
    one step at the golden tolerance of JAX's, the file named for the gfs
    source and holding the prediction's channels."""
    import torch

    from skyrim_tpu.core.skyrim import Skyrim as JSkyrim
    from skyrim_tpu.io.save import SaveConfig as JSaveConfig
    from skyrim_tpu.models.pangu import PanguConfig as JConfig
    from skyrim_tpu.models.pangu import PanguModel as JModel

    from skyrim_tpu_torch.core import Skyrim
    from skyrim_tpu_torch.io import SaveConfig, load_forecast
    from skyrim_tpu_torch.models.pangu import PanguConfig, PanguModel
    from skyrim_tpu_torch.params import to_tree

    cfg = dict(lat=721, lon=1440, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 1))
    params = PanguModel("pangu", cfg=PanguConfig(**cfg), device="cpu").init_params(torch.Generator().manual_seed(0))
    jtree = JModel("pangu", cfg=JConfig(**cfg)).prepare_params(to_tree(params))
    sky = Skyrim("pangu", model_kwargs={"cfg": PanguConfig(**cfg)}, params=params, device="cpu")
    jsky = JSkyrim("pangu", model_kwargs={"cfg": JConfig(**cfg)}, params=jtree)
    assert sky.ic_source == "gfs" and isinstance(sky.model.data_source, gfs.GFSSource)
    sky.model.data_source.client.transport = jsky.model.data_source.client.transport = pangu_gfs

    keep = ("z500", "t850", "u10m")  # the files hold three channels; the predictions all 69
    pred, paths = sky.predict("20240507", "0000", lead_time=6, save=True, save_config=SaveConfig(
        forecast_id="fc", output_dir=str(tmp_path / "torch"), filter_vars=keep))
    jpred, jpaths = jsky.predict("20240507", "0000", lead_time=6, save=True, save_config=JSaveConfig(
        forecast_id="fc", output_dir=str(tmp_path / "jax"), filter_vars=keep))
    assert [Path(p).name for p in paths] == [Path(p).name for p in jpaths] == \
        ["pangu__gfs__20240507_00:00__20240507_06:00.nc"]
    out = pred.prediction
    assert out.data.shape == (1, 69, 721, 1440) and np.isfinite(out.data).all()
    _close_golden(out.data, np.asarray(jpred.prediction.data))
    saved = load_forecast(paths[0])
    assert list(saved.coords["channel"]) == list(keep)
    np.testing.assert_array_equal(saved.data, out.sel(channel=list(keep)).data)


def _close_golden(out, ref):
    """tests/test_torch_facade.py's golden check, its sums accumulated in
    float64 without float64 copies of the 72 M values."""
    ref_std = ref.std(dtype=np.float64)
    tol = 3e-2 * ref_std
    assert abs(out.mean(dtype=np.float64) - ref.mean(dtype=np.float64)) < tol
    assert abs(out.std(dtype=np.float64) - ref_std) < tol
    diff = out - ref
    assert np.sqrt(np.square(diff).mean(dtype=np.float64)) < tol and np.abs(diff).max() < 10 * tol

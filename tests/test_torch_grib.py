"""The port's GRIB decoder, its native fast path, and the small IC tables
against the JAX package.

- ``decode_message``/``decode_all`` on the committed GFS-style fixture
  (template 5.3, second-order spatial differencing) and on seeded
  ``encode_simple``/``encode_complex`` messages: values, NaN masks,
  coordinates and metadata equal to ``skyrim_tpu.data.grib`` bit for bit;
  the encoders' bytes equal to JAX's.
- The native ``gribcore`` (built here with ``g++``) against the numpy
  path bit for bit, at every decimal scale D, and the numpy fall-back
  when no compiler is found.
- ``idx``, ``vocab``, ``schedules`` and ``regrid`` equal to JAX's (the
  721x1440 identity regrid included).

JAX is imported by ``pytest.importorskip`` at collection: the card's
machine has no JAX and skips this file.
"""

import datetime
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from skyrim_tpu_torch.data import grib, gribcore, idx, regrid, schedules, vocab

pytest.importorskip("jax")
from skyrim_tpu.data import grib as jgrib  # noqa: E402
from skyrim_tpu.data import idx as jidx  # noqa: E402
from skyrim_tpu.data import regrid as jregrid  # noqa: E402
from skyrim_tpu.data import schedules as jschedules  # noqa: E402
from skyrim_tpu.data import vocab as jvocab  # noqa: E402

FIX = Path(__file__).parent / "data" / "fixtures"


@pytest.fixture
def gxx():
    """The native decoder's tests need the host's g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ for the native decoder")


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's decoder on its numpy path only (the hooks reset)."""
    monkeypatch.setattr(grib, "_native_tried", True)
    monkeypatch.setattr(grib, "_unpack_bits_impl", grib._unpack_bits_numpy)
    monkeypatch.setattr(grib, "_decode_simple_impl", None)


def _assert_messages_equal(out, ref):
    for name in ("discipline", "param_category", "param_number", "nlat", "nlon", "lat_first",
                 "lon_first", "lat_last", "lon_last", "scan_mode", "meta"):
        assert getattr(out, name) == getattr(ref, name), name
    assert out.values.dtype == ref.values.dtype == np.float32
    np.testing.assert_array_equal(out.values, ref.values)  # NaNs in the same places
    np.testing.assert_array_equal(out.lat, ref.lat)
    np.testing.assert_array_equal(out.lon, ref.lon)


def _field(seed, shape=(19, 36), scale=10.0, offset=280.0):
    return np.random.default_rng(seed).normal(size=shape) * scale + offset


# --- the decoder -----------------------------------------------------------------


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fixture_decodes_as_jax(path, request):
    request.getfixturevalue("numpy_path" if path == "numpy" else "gxx")
    raw = (FIX / "gfs_style.grib2").read_bytes()
    out, ref = grib.decode_all(raw), jgrib.decode_all(raw)
    assert len(out) == len(ref) == 3
    truth = np.load(FIX / "gfs_style_truth.npz")
    for m, r, key in zip(out, ref, ("tmp", "ug", "hgt")):
        _assert_messages_equal(m, r)
        assert m.meta["data_template"] == 3
        np.testing.assert_allclose(m.values, truth[key], atol=0.06)


def test_fixture_byte_range_through_idx():
    """The GFS fetcher's flow on the fixture: .idx → byte range → one message."""
    raw = (FIX / "gfs_style.grib2").read_bytes()
    text = (FIX / "gfs_style.grib2.idx").read_text()
    entries, jentries = idx.parse_idx(text), jidx.parse_idx(text)
    assert {k: vars(v) for k, v in entries.items()} == {k: vars(v) for k, v in jentries.items()}
    for key in entries:
        e = idx.lookup(entries, *key)
        end = None if e.length is None else e.offset + e.length
        _assert_messages_equal(grib.decode_message(raw[e.offset:end]), jgrib.decode_message(raw[e.offset:end]))
    with pytest.raises(KeyError, match="not in index"):
        idx.lookup(entries, "VGRD", "10 m above ground")


@pytest.mark.parametrize("nbits", [8, 12, 16, 24])
def test_encode_simple_bytes_and_decode_equal_jax(nbits):
    f = _field(nbits, (37, 72))
    kw = dict(nbits=nbits, param_category=2, param_number=2, forecast_hours=6, level_type=100,
              level_value=50000.0, lat_first=90.0, lon_first=0.0, lat_last=-90.0, lon_last=355.0)
    enc = grib.encode_simple(f, **kw)
    assert enc == jgrib.encode_simple(f, **kw)
    out = grib.decode_message(enc)
    _assert_messages_equal(out, jgrib.decode_message(enc))
    # the simple-packing quantum: |decoded - encoded| <= 2^E / 2 (+ f32 rounding)
    quantum = 2.0 ** int(np.ceil(np.log2((f.max() - f.min()) / (2**nbits - 1))))
    assert np.abs(out.values - f).max() <= quantum / 2 + 1e-4 * np.abs(f).max()


def test_encode_simple_constant_field():
    enc = grib.encode_simple(np.full((5, 8), 7.25))
    assert enc == jgrib.encode_simple(np.full((5, 8), 7.25))
    np.testing.assert_array_equal(grib.decode_message(enc).values, np.float32(7.25))


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("group_len", [7, 32])
def test_encode_complex_bytes_and_decode_equal_jax(order, group_len):
    f = _field(order + 10 * group_len)
    enc = grib.encode_complex(f, spatial_order=order, decimals=2, group_len=group_len)
    assert enc == jgrib.encode_complex(f, spatial_order=order, decimals=2, group_len=group_len)
    out = grib.decode_message(enc)
    _assert_messages_equal(out, jgrib.decode_message(enc))
    assert out.meta["data_template"] == (3 if order else 2)
    np.testing.assert_allclose(out.values, f, atol=0.0051)


def test_complex_missing_values_equal_jax():
    g = _field(4)
    g[3, 4] = np.nan
    g[10, :] = np.nan  # a whole row: some all-missing groups
    enc = grib.encode_complex(g, spatial_order=0, decimals=2)
    assert enc == jgrib.encode_complex(g, spatial_order=0, decimals=2)
    out = grib.decode_message(enc)
    _assert_messages_equal(out, jgrib.decode_message(enc))
    np.testing.assert_array_equal(np.isnan(out.values), np.isnan(g))


def test_bitmap_and_south_first_scan_equal_jax():
    """A section-6 bitmap and +j scanning (south→north), spliced into an
    encoded message: masked points NaN, rows flipped north-first."""
    f = _field(5, (6, 8))
    buf = bytearray(grib.encode_simple(f, lat_first=-90.0, lat_last=90.0, lon_last=315.0))
    pos, sections = 16, {}
    while buf[pos:pos + 4] != b"7777":
        ln = int.from_bytes(buf[pos:pos + 4], "big")
        sections[buf[pos + 4]] = (pos, ln)
        pos += ln
    p3, _ = sections[3]
    buf[p3 + 71] |= 0x40  # scanning mode: +j
    mask = np.random.default_rng(6).random(48) > 0.3
    p6, ln6 = sections[6]
    s6 = (6 + (48 + 7) // 8).to_bytes(4, "big") + bytes([6, 0]) + np.packbits(mask).tobytes()
    # the bitmap keeps only the first mask.sum() values of section 7's stream
    n_keep = int(mask.sum())
    p5, _ = sections[5]
    buf[p5 + 5:p5 + 9] = n_keep.to_bytes(4, "big")
    out_buf = bytes(buf[:p6]) + s6 + bytes(buf[p6 + ln6:])
    out_buf = out_buf[:8] + len(out_buf).to_bytes(8, "big") + out_buf[16:]
    out, ref = grib.decode_message(out_buf), jgrib.decode_message(out_buf)
    _assert_messages_equal(out, ref)
    assert out.lat_first == 90.0 and np.isnan(out.values).sum() == 48 - n_keep


def test_refusals_equal_jax():
    with pytest.raises(ValueError, match="missing values require"):
        grib.encode_complex(np.array([[1.0, np.nan]]), spatial_order=2)
    with pytest.raises(ValueError, match="no GRIB header"):
        grib.decode_message(b"nothing here")
    buf = bytearray(grib.encode_simple(np.ones((2, 2))))
    buf[7] = 1
    with pytest.raises(NotImplementedError, match="edition 1"):
        grib.decode_message(bytes(buf))


# --- the native fast path --------------------------------------------------------


def test_native_builds_and_installs(gxx):
    assert gribcore.available()
    path = gribcore.lib_path()
    assert path.exists() and path.parent.name == "skyrim_tpu_torch" and path.parent.parent.name == "build"
    grib._install_native()
    assert grib._unpack_bits_impl is gribcore.unpack_bits
    assert grib._decode_simple_impl is gribcore.decode_simple


@pytest.mark.parametrize("nbits", [1, 7, 8, 12, 16, 24, 32])
def test_native_unpack_bits_equals_numpy(nbits, gxx):
    rng = np.random.default_rng(nbits)
    n = 2053
    raw = rng.integers(0, 256, size=(n * nbits + 7) // 8 + 4, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(gribcore.unpack_bits(raw, nbits, n), grib._unpack_bits_numpy(raw, nbits, n))
    with pytest.raises(ValueError):
        gribcore.unpack_bits(raw[:2], nbits, n)


def _with_decimal_scale(enc: bytes, D: int) -> bytes:
    """An encode_simple message with its decimal scale factor set to D."""
    buf = bytearray(enc)
    pos = 16
    while buf[pos + 4] != 5:
        pos += int.from_bytes(buf[pos:pos + 4], "big")
    buf[pos + 17:pos + 19] = grib._sm(D, 2).to_bytes(2, "big")
    return bytes(buf)


@pytest.mark.parametrize("D", [-3, -1, 0, 1, 2, 5])
def test_native_decode_simple_equals_numpy_bitwise(D, gxx, monkeypatch):
    f = _field(20 + D, (73, 144), scale=300.0, offset=1000.0)
    enc = _with_decimal_scale(grib.encode_simple(f, nbits=16), D)
    native = grib.decode_message(enc).values
    assert grib._decode_simple_impl is gribcore.decode_simple
    monkeypatch.setattr(grib, "_unpack_bits_impl", grib._unpack_bits_numpy)
    monkeypatch.setattr(grib, "_decode_simple_impl", None)
    pure = grib.decode_message(enc).values
    np.testing.assert_array_equal(native, pure)
    np.testing.assert_array_equal(pure, jgrib.decode_message(enc).values)


def test_native_leaves_complex_packing_to_numpy(gxx):
    """Complex packing decodes the same with and without the native path."""
    grib._install_native()
    f = _field(30)
    for enc in (grib.encode_complex(f, spatial_order=2), (FIX / "gfs_style.grib2").read_bytes()):
        with_native = [m.values for m in grib.decode_all(enc)]
        saved = grib._unpack_bits_impl, grib._decode_simple_impl
        grib._unpack_bits_impl, grib._decode_simple_impl = grib._unpack_bits_numpy, None
        try:
            pure = [m.values for m in grib.decode_all(enc)]
        finally:
            grib._unpack_bits_impl, grib._decode_simple_impl = saved
        for a, b in zip(with_native, pure):
            np.testing.assert_array_equal(a, b)


def test_no_compiler_keeps_numpy_path(monkeypatch, tmp_path):
    """Without g++ the library is not built: a warning, and the numpy path."""
    import logging

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("skyrim_tpu_torch").addHandler(handler)
    monkeypatch.setattr(gribcore, "_tried", False)
    monkeypatch.setattr(gribcore, "_lib", None)
    monkeypatch.setattr(gribcore, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(gribcore.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    try:
        assert not gribcore.available() and not gribcore.install()
    finally:
        logging.getLogger("skyrim_tpu_torch").removeHandler(handler)
    assert any("native GRIB decoder unavailable" in r.getMessage() for r in records)
    assert not list(tmp_path.iterdir())


# --- idx, vocab, schedules, regrid -----------------------------------------------


def test_parse_idx_equals_jax():
    lines = [f"{i + 1}:{i * 1000}:d=2024050700:{p}:{lvl}:anl:" for i, (p, lvl) in
             enumerate([("UGRD", "10 m above ground"), ("TMP", "2 m above ground"), ("HGT", "500 mb"),
                        ("HGT", "500 mb"), ("RH", "850 mb")])]
    lines.insert(2, "garbage line")
    lines.append(f"7:{10_000_000}:d=2024050700:PRMSL:mean sea level:anl:")
    text = "\n".join(lines)
    out, ref = idx.parse_idx(text), jidx.parse_idx(text)
    assert {k: vars(v) for k, v in out.items()} == {k: vars(v) for k, v in ref.items()}
    assert out[("HGT", "500 mb")].offset == 2000  # the first occurrence kept
    assert out[("RH", "850 mb")].length == idx.MAX_BYTE_SIZE  # capped
    assert out[("PRMSL", "mean sea level")].length is None


def test_ecmwf_index_equals_jax():
    rows = [{"param": "gh", "levtype": "pl", "levelist": str(lv), "number": str(n), "_offset": 10 * i,
             "_length": 10} for i, (lv, n) in enumerate([(500, 1), (850, 1), (500, 2)])]
    text = "\n".join(json.dumps(r) + ("," if i % 2 else "") for i, r in enumerate(rows)) + "\n\nnot json"
    out, ref = idx.parse_ecmwf_index(text), jidx.parse_ecmwf_index(text)
    assert out == ref and len(out) == 3
    assert idx.ecmwf_lookup(out, "gh", "pl", "500", 2) == jidx.ecmwf_lookup(ref, "gh", "pl", "500", 2) == rows[2]
    with pytest.raises(KeyError):
        idx.ecmwf_lookup(out, "gh", "pl", "925")


@pytest.mark.parametrize("name", ["GFS_VOCAB", "IFS_VOCAB", "ENS_VOCAB", "CDS_VOCAB"])
def test_vocabularies_equal_jax(name):
    out, ref = getattr(vocab, name), getattr(jvocab, name)
    assert out.channels == ref.channels and len(out) == len(ref)
    for ch in ref.channels:
        a, b = out[ch], ref[ch]
        assert (a.channel, a.provider_id, a.levtype, a.level, a.scale) == \
            (b.channel, b.provider_id, b.levtype, b.level, b.scale)
        x = np.float32(5500.0)
        assert a.modifier(x) == b.modifier(x)
    assert vocab.GRAVITY == jvocab.GRAVITY == 9.81
    assert (vocab.CDS_SINGLE_DATASET, vocab.CDS_PRESSURE_DATASET) == \
        (jvocab.CDS_SINGLE_DATASET, jvocab.CDS_PRESSURE_DATASET)


def test_schedules_equal_jax():
    for product in ("gfs", "ifs", "ens"):
        for cycle in (0, 6, 12, 18):
            steps = schedules._PRODUCT_STEPS[product](cycle)
            assert steps == jschedules._PRODUCT_STEPS[product](cycle)
            for lead, step in ((24, 6), (90, 3), (144, None), (240, 6)):
                try:
                    ref = jschedules.forecast_steps(product, cycle, lead, step)
                except jschedules.ScheduleError as e:
                    with pytest.raises(schedules.ScheduleError, match=str(e)[:20]):
                        schedules.forecast_steps(product, cycle, lead, step)
                else:
                    assert schedules.forecast_steps(product, cycle, lead, step) == ref
    with pytest.raises(schedules.ScheduleError):
        schedules.gfs_steps(3)
    target = datetime.datetime(2024, 5, 7, 6)
    for product in ("gfs", "ifs", "ens"):
        assert schedules.available_start_times(product, target, 30) == \
            jschedules.available_start_times(product, target, 30)


def test_regrid_equals_jax():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 3, 19, 36)).astype(np.float32)
    src_lat, src_lon = np.linspace(-90, 90, 19), np.arange(36) * 10.0  # south-first source
    dst_lat, dst_lon = np.linspace(88, -88, 23), np.arange(0.0, 360.0, 7.5)
    out = regrid.regrid_latlon(vals, src_lat, src_lon, dst_lat, dst_lon)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jregrid.regrid_latlon(vals, src_lat, src_lon, dst_lat, dst_lon))
    lv = rng.normal(size=(4, 5, 6)).astype(np.float32)
    src, dst = np.array([1000.0, 850.0, 500.0, 250.0]), np.array([925.0, 700.0, 50.0, 1000.0])
    np.testing.assert_array_equal(regrid.interp_pressure_levels(lv, src, dst),
                                  jregrid.interp_pressure_levels(lv, src, dst))
    up = regrid.to_canonical_grid(vals[0, 0], src_lat, src_lon)
    assert up.shape == (721, 1440)
    np.testing.assert_array_equal(up, jregrid.to_canonical_grid(vals[0, 0], src_lat, src_lon))


def test_identity_regrid_at_full_width():
    """The canonical 721x1440 grid in: the values come back unchanged."""
    vals = np.random.default_rng(1).normal(size=(721, 1440)).astype(np.float32)
    lat, lon = np.linspace(90.0, -90.0, 721), np.arange(0.0, 360.0, 0.25)
    out = regrid.to_canonical_grid(vals, lat, lon)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, vals)
    np.testing.assert_array_equal(out, jregrid.to_canonical_grid(vals, lat, lon))

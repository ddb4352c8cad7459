"""NetCDF persistence for Field (the port's copy of skyrim_tpu/io/netcdf.py).

The reference saves forecasts as NetCDF via xarray's scipy engine
(reference skyrim/common.py:134-147).  Neither xarray nor netCDF4 is a
dependency, so we write NetCDF3-classic directly with
``scipy.io.netcdf_file`` — the same on-disk format the reference's scipy
engine produces.  String coords (channel) are encoded as fixed-width
char arrays with a ``{dim}_strlen`` dimension, times as float64 hours
since epoch — both standard CF conventions, readable by xarray.
"""

from __future__ import annotations

import io as _io
from pathlib import Path

import numpy as np
from scipy.io import netcdf_file

from skyrim_tpu_torch.field import Field

_EPOCH = np.datetime64("1970-01-01T00:00:00", "ns")
_TIME_UNITS = "hours since 1970-01-01 00:00:00"


def _encode_times(times: np.ndarray) -> np.ndarray:
    return (times.astype("datetime64[ns]") - _EPOCH) / np.timedelta64(1, "h")


def _decode_times(hours: np.ndarray) -> np.ndarray:
    return _EPOCH + (np.asarray(hours, dtype="float64") * 3.6e12).astype("timedelta64[ns]")


def write_netcdf(field: Field, target, var_name: str = "forecast") -> None:
    """Write a Field to a local path or file-like object (NetCDF3 classic)."""
    if isinstance(target, (str, Path)):
        Path(target).parent.mkdir(parents=True, exist_ok=True)
    f = netcdf_file(target, "w")
    try:
        # same global attribute as the JAX package: files are interchangeable
        f.history = "created by skyrim_tpu"
        for dim, size in field.sizes.items():
            f.createDimension(dim, size)
        for dim in field.dims:
            if dim not in field.coords:
                continue
            coord = field.coords[dim]
            if dim == "time":
                v = f.createVariable(dim, "d", (dim,))
                v[:] = _encode_times(coord)
                v.units = _TIME_UNITS
            elif coord.dtype == object or coord.dtype.kind in "SU":
                names = [str(c) for c in coord]
                strlen = max(max((len(n) for n in names), default=1), 1)
                f.createDimension(f"{dim}_strlen", strlen)
                v = f.createVariable(dim, "S1", (dim, f"{dim}_strlen"))
                buf = np.zeros((len(names), strlen), dtype="S1")
                for i, n in enumerate(names):
                    b = n.encode()
                    buf[i, : len(b)] = np.frombuffer(b, dtype="S1")
                v[:] = buf
            else:
                v = f.createVariable(dim, "d", (dim,))
                v[:] = coord.astype("float64")
        data = field.data
        if data.dtype == np.float64:
            data = data.astype(np.float32)
        v = f.createVariable(var_name, data.dtype.char, field.dims)
        v[:] = data
        for k, val in field.attrs.items():
            if isinstance(val, (str, int, float)):
                setattr(f, k, val)
        f.flush()
    finally:
        f.close()


def write_netcdf_bytes(field: Field, var_name: str = "forecast") -> bytes:
    buf = _io.BytesIO()
    write_netcdf(field, buf, var_name)
    return buf.getvalue()


def read_netcdf(source, var_name: str | None = None) -> Field:
    """Read a Field back from a path or file-like object."""
    f = netcdf_file(source, "r", mmap=False)
    try:
        dims_set = set(f.dimensions)
        if var_name is None:
            candidates = [
                name
                for name, v in f.variables.items()
                if name not in dims_set and not name.endswith("_strlen") and v.data.ndim >= 2
            ]
            if not candidates:
                raise ValueError("no data variable found")
            var_name = candidates[0]
        v = f.variables[var_name]
        dims = tuple(v.dimensions)
        coords = {}
        for dim in dims:
            if dim not in f.variables:
                continue
            cv = f.variables[dim]
            if dim == "time":
                coords[dim] = _decode_times(cv[:].copy())
            elif cv.data.dtype.kind == "S":
                raw = cv[:].copy()
                coords[dim] = np.asarray(
                    [b"".join(row).decode().rstrip("\x00") for row in raw], dtype=object
                )
            else:
                coords[dim] = cv[:].copy()
        data = np.array(v[:])
        attrs = {
            k: (val.decode() if isinstance(val, bytes) else val)
            for k, val in f._attributes.items()
        }
        return Field(data, dims, coords, attrs, name=var_name)
    finally:
        f.close()

"""Field — a lightweight labeled N-d array (the canonical data contract).

The port's own copy of skyrim_tpu/field.py.  The reference passes every
forecast/IC around as an ``xarray.DataArray(time, channel, lat, lon)``
(SURVEY.md §1).  xarray is not a dependency, so Field provides the slice
of that API the framework needs — named dims, 1-D coords, label-based
selection, concat/mean — over a plain numpy array.  Device compute never
touches Field (models operate on raw tensors); Field is the host-side
interchange + IO type.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field as _field, replace
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

CANONICAL_DIMS = ("time", "channel", "lat", "lon")


def _as_coord(dim: str, values) -> np.ndarray:
    arr = np.asarray(values)
    if dim == "time" and arr.dtype.kind not in "M":
        arr = np.asarray(arr, dtype="datetime64[ns]")
    if arr.ndim != 1:
        raise ValueError(f"coord {dim!r} must be 1-D, got shape {arr.shape}")
    return arr


def to_datetime64(t) -> np.datetime64:
    if isinstance(t, np.datetime64):
        return t.astype("datetime64[ns]")
    if isinstance(t, _dt.datetime):
        return np.datetime64(t.isoformat(), "ns")
    return np.datetime64(t, "ns")


@dataclass
class Field:
    data: np.ndarray
    dims: tuple[str, ...]
    coords: dict[str, np.ndarray] = _field(default_factory=dict)
    attrs: dict[str, Any] = _field(default_factory=dict)
    name: str | None = None

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.dims = tuple(self.dims)
        if self.data.ndim != len(self.dims):
            raise ValueError(
                f"data has {self.data.ndim} dims but dims={self.dims}"
            )
        coords = {}
        for dim, values in self.coords.items():
            arr = _as_coord(dim, values)
            if dim in self.dims:
                size = self.data.shape[self.dims.index(dim)]
                if len(arr) != size:
                    raise ValueError(
                        f"coord {dim!r} has length {len(arr)} but dim size {size}"
                    )
            coords[dim] = arr
        self.coords = coords

    # -- construction -------------------------------------------------------

    @classmethod
    def from_canonical(
        cls,
        data,
        times: Sequence,
        channels: Sequence[str],
        lat: Sequence[float],
        lon: Sequence[float],
        attrs: Mapping[str, Any] | None = None,
    ) -> "Field":
        return cls(
            np.asarray(data),
            CANONICAL_DIMS,
            coords={
                "time": np.asarray([to_datetime64(t) for t in times]),
                "channel": np.asarray(list(channels), dtype=object),
                "lat": np.asarray(lat, dtype=np.float64),
                "lon": np.asarray(lon, dtype=np.float64),
            },
            attrs=dict(attrs or {}),
        )

    # -- basic introspection ------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self) -> np.ndarray:
        return self.data

    def axis(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dim {dim!r} not in {self.dims}") from None

    def __repr__(self):
        dims = ", ".join(f"{d}: {s}" for d, s in self.sizes.items())
        return f"<Field ({dims}) dtype={self.data.dtype}>"

    # -- selection ----------------------------------------------------------

    def isel(self, **indexers) -> "Field":
        """Integer/position-based selection. Scalars drop the dim."""
        out = self
        for dim, idx in indexers.items():
            ax = out.axis(dim)
            drop = np.isscalar(idx) or (isinstance(idx, np.ndarray) and idx.ndim == 0)
            if isinstance(idx, slice):
                data = out.data[(slice(None),) * ax + (idx,)]
            else:
                data = np.take(out.data, idx, axis=ax)
            coords = dict(out.coords)
            if dim in coords:
                if drop:
                    coords.pop(dim)
                else:
                    coords[dim] = coords[dim][idx]
            dims = out.dims if not drop else tuple(d for d in out.dims if d != dim)
            out = Field(data, dims, coords, dict(out.attrs), out.name)
        return out

    def _label_to_index(self, dim: str, key, method: str | None):
        coord = self.coords[dim]
        if isinstance(key, slice):
            # value-based slice: keep entries within [start, stop] regardless
            # of coordinate ordering direction (lat is descending).
            lo, hi = key.start, key.stop
            if dim == "time":
                lo = to_datetime64(lo) if lo is not None else None
                hi = to_datetime64(hi) if hi is not None else None
            mask = np.ones(len(coord), dtype=bool)
            if lo is not None and hi is not None:
                a, b = (lo, hi) if not _descending(coord) else (hi, lo)
                mask = (coord >= min(a, b)) & (coord <= max(a, b))
            elif lo is not None:
                mask = coord >= lo if not _descending(coord) else coord <= lo
            elif hi is not None:
                mask = coord <= hi if not _descending(coord) else coord >= hi
            return np.nonzero(mask)[0]
        if isinstance(key, (list, tuple, np.ndarray)):
            return np.asarray([self._scalar_index(dim, k, method) for k in key])
        return self._scalar_index(dim, key, method)

    def _scalar_index(self, dim: str, key, method: str | None) -> int:
        coord = self.coords[dim]
        if dim == "time":
            key = to_datetime64(key)
        if coord.dtype == object or coord.dtype.kind in "SU":
            matches = np.nonzero(coord == key)[0]
            if len(matches) == 0:
                raise KeyError(f"{key!r} not found in coord {dim!r}")
            return int(matches[0])
        if method == "nearest":
            if dim == "lon":
                key = float(key) % 360.0
            diff = np.abs(coord.astype("float64" if coord.dtype.kind != "M" else coord.dtype) - key)
            return int(diff.argmin())
        matches = np.nonzero(coord == key)[0]
        if len(matches) == 0:
            raise KeyError(f"{key!r} not found in coord {dim!r} (try method='nearest')")
        return int(matches[0])

    def sel(self, method: str | None = None, **indexers) -> "Field":
        """Label-based selection (xarray-style), with ``method='nearest'``."""
        isel_kw = {}
        for dim, key in indexers.items():
            if dim not in self.coords:
                raise KeyError(f"no coord for dim {dim!r}")
            isel_kw[dim] = self._label_to_index(dim, key, method)
        return self.isel(**isel_kw)

    # -- transforms ----------------------------------------------------------

    def transpose(self, *dims: str) -> "Field":
        perm = [self.axis(d) for d in dims]
        return Field(np.transpose(self.data, perm), tuple(dims), dict(self.coords), dict(self.attrs), self.name)

    def expand_dims(self, dim: str, coord=None, axis: int = 0) -> "Field":
        data = np.expand_dims(self.data, axis)
        dims = self.dims[:axis] + (dim,) + self.dims[axis:]
        coords = dict(self.coords)
        if coord is not None:
            coords[dim] = _as_coord(dim, [coord] if np.isscalar(coord) or isinstance(coord, (str, _dt.datetime, np.datetime64)) else coord)
        return Field(data, dims, coords, dict(self.attrs), self.name)

    def mean(self, dim: str) -> "Field":
        ax = self.axis(dim)
        coords = {k: v for k, v in self.coords.items() if k != dim}
        dims = tuple(d for d in self.dims if d != dim)
        return Field(self.data.mean(axis=ax), dims, coords, dict(self.attrs), self.name)

    def astype(self, dtype) -> "Field":
        return replace(self, data=self.data.astype(dtype))

    def assign_coords(self, **coords) -> "Field":
        new = dict(self.coords)
        for dim, values in coords.items():
            new[dim] = _as_coord(dim, values)
            if dim in self.dims:
                size = self.data.shape[self.axis(dim)]
                if len(new[dim]) != size:
                    raise ValueError(f"coord {dim!r} length mismatch")
        return replace(self, coords=new)

    def assign_attrs(self, **attrs) -> "Field":
        merged = dict(self.attrs)
        merged.update(attrs)
        return replace(self, attrs=merged)

    # -- combination ---------------------------------------------------------

    @staticmethod
    def concat(fields: Iterable["Field"], dim: str) -> "Field":
        fields = list(fields)
        if not fields:
            raise ValueError("cannot concat empty list")
        first = fields[0]
        add_axis = dim not in first.dims
        if add_axis:
            fields = [f.expand_dims(dim, axis=0) for f in fields]
            first = fields[0]
        ax = first.axis(dim)
        data = np.concatenate([f.data for f in fields], axis=ax)
        coords = dict(first.coords)
        if all(dim in f.coords for f in fields):
            coords[dim] = np.concatenate([np.atleast_1d(f.coords[dim]) for f in fields])
        else:
            coords.pop(dim, None)
        return Field(data, first.dims, coords, dict(first.attrs), first.name)

    # -- arithmetic (numpy broadcasting on aligned dims) ---------------------

    def _binop(self, other, op):
        other_data = other.data if isinstance(other, Field) else other
        return replace(self, data=op(self.data, other_data))

    def __add__(self, other):
        return self._binop(other, np.add)

    def __sub__(self, other):
        return self._binop(other, np.subtract)

    def __mul__(self, other):
        return self._binop(other, np.multiply)

    def __truediv__(self, other):
        return self._binop(other, np.divide)


def _descending(coord: np.ndarray) -> bool:
    return len(coord) > 1 and coord.dtype.kind not in "OSUM" and coord[0] > coord[-1]

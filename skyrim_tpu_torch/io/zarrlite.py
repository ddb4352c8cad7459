"""Self-contained Zarr v2 store (write + read + append).

The reference persists remote forecasts as consolidated Zarr with
``append_dim="time"`` (reference skyrim/common.py:148-160,176-192).
Without zarr-python, this module implements the Zarr v2 on-disk format
directly: ``.zgroup``/``.zarray``/``.zattrs`` JSON
metadata, C-order chunks compressed with stdlib zlib (numcodecs codec id
``"zlib"``), and ``.zmetadata`` consolidation — fully readable by stock
zarr-python.  Stores are addressed through a minimal key-value
abstraction so local paths and any fsspec-backed URL (s3://, memory://)
share one code path (fsspec is imported only by ``FsspecStore``).

The port's copy of skyrim_tpu/io/zarrlite.py: at the same zlib level it
writes the same chunk bytes, so either package reads the other's store.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from skyrim_tpu_torch.field import Field

_FILL = {"f": "NaN", "i": 0, "u": 0, "S": "", "U": ""}


class KVStore:
    """Minimal key→bytes store interface."""

    def __setitem__(self, key: str, value: bytes):
        raise NotImplementedError

    def __getitem__(self, key: str) -> bytes:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> list[str]:
        raise NotImplementedError


class DirectoryStore(KVStore):
    def __init__(self, root: str | Path):
        self.root = Path(root)

    def __setitem__(self, key, value):
        p = self.root / key
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(value)

    def __getitem__(self, key):
        p = self.root / key
        if not p.exists():
            raise KeyError(key)
        return p.read_bytes()

    def __contains__(self, key):
        return (self.root / key).exists()

    def list_prefix(self, prefix):
        base = self.root / prefix if prefix else self.root
        if not base.exists():
            return []
        return [str(p.relative_to(self.root)) for p in base.rglob("*") if p.is_file()]


class FsspecStore(KVStore):
    """Store over an fsspec filesystem (s3://, gs://, memory://, ...)."""

    def __init__(self, url: str, **storage_options):
        import fsspec

        self.fs, self.root = fsspec.core.url_to_fs(url, **storage_options)

    def _key(self, key):
        return f"{self.root}/{key}"

    def __setitem__(self, key, value):
        with self.fs.open(self._key(key), "wb") as fh:
            fh.write(value)

    def __getitem__(self, key):
        try:
            with self.fs.open(self._key(key), "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def __contains__(self, key):
        return self.fs.exists(self._key(key))

    def list_prefix(self, prefix):
        base = self._key(prefix) if prefix else self.root
        try:
            files = self.fs.find(base)
        except FileNotFoundError:
            return []
        return [f[len(self.root) + 1 :] for f in files]


def open_store(target, **storage_options) -> KVStore:
    if isinstance(target, KVStore):
        return target
    target = str(target)
    if "://" in target:
        return FsspecStore(target, **storage_options)
    return DirectoryStore(target)


class ZarrStore:
    """A Zarr v2 group holding one chunked data variable + 1-D coords.

    ``level`` is the zlib level written into chunk metadata (1 ≈ 2×
    faster than the default 4 at ~equal ratio on weather fields — the
    streaming production path uses it); ``workers`` > 1 compresses
    chunks in a thread pool (zlib releases the GIL)."""

    def __init__(self, store: KVStore, level: int = 4, workers: int = 1):
        self.store = store
        self.level = int(level)
        self.workers = int(workers)

    # -- metadata helpers ---------------------------------------------------

    def _write_json(self, key: str, obj: dict):
        self.store[key] = json.dumps(obj, indent=2, sort_keys=True).encode()

    def _read_json(self, key: str) -> dict:
        return json.loads(self.store[key].decode())

    def exists(self) -> bool:
        return ".zgroup" in self.store

    # -- array write --------------------------------------------------------

    def _zarray_meta(self, shape, chunks, dtype: np.dtype) -> dict:
        kind = dtype.kind
        return {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": dtype.str,
            "compressor": {"id": "zlib", "level": self.level},
            "fill_value": _FILL.get(kind, 0),
            "order": "C",
            "filters": None,
        }

    def _write_chunk(self, name: str, chunk_key: str, data: np.ndarray):
        self.store[f"{name}/{chunk_key}"] = zlib.compress(
            np.ascontiguousarray(data).tobytes(), self.level
        )

    def _write_chunks(self, name: str, items: list[tuple[str, np.ndarray]]):
        """Compress + store chunks, in parallel when ``workers`` > 1."""
        if self.workers > 1 and len(items) > 1:
            from concurrent.futures import ThreadPoolExecutor

            def one(kv):
                key, data = kv
                blob = zlib.compress(
                    np.ascontiguousarray(data).tobytes(), self.level)
                return key, blob

            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                for key, blob in pool.map(one, items):
                    self.store[f"{name}/{key}"] = blob
        else:
            for key, data in items:
                self._write_chunk(name, key, data)

    def write_array(
        self,
        name: str,
        data: np.ndarray,
        dims: tuple[str, ...],
        chunks: tuple[int, ...] | None = None,
        attrs: dict | None = None,
    ):
        data = np.asarray(data)
        if data.dtype == object:  # string coords → fixed-width unicode
            data = data.astype("U")
        if chunks is None:
            chunks = data.shape if data.ndim else (1,)
        self._write_json(f"{name}/.zarray", self._zarray_meta(data.shape, chunks, data.dtype))
        zattrs = {"_ARRAY_DIMENSIONS": list(dims)}
        zattrs.update(attrs or {})
        self._write_json(f"{name}/.zattrs", zattrs)
        items = []
        for idx in np.ndindex(*[-(-s // c) for s, c in zip(data.shape, chunks)]):
            sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
            block = data[sl]
            # pad partial edge chunks to full chunk shape (zarr convention)
            if block.shape != tuple(chunks):
                pad = np.zeros(chunks, dtype=data.dtype)
                pad[tuple(slice(0, s) for s in block.shape)] = block
                block = pad
            items.append((".".join(map(str, idx)) or "0", block))
        self._write_chunks(name, items)

    def read_array(self, name: str) -> tuple[np.ndarray, list[str]]:
        meta = self._read_json(f"{name}/.zarray")
        zattrs = self._read_json(f"{name}/.zattrs")
        dims = zattrs.get("_ARRAY_DIMENSIONS", [])
        shape, chunks = meta["shape"], meta["chunks"]
        dtype = np.dtype(meta["dtype"])
        out = np.zeros(shape, dtype=dtype)
        grid = [-(-s // c) for s, c in zip(shape, chunks)] or [1]
        for idx in np.ndindex(*grid):
            key = f"{name}/{'.'.join(map(str, idx)) or '0'}"
            if key not in self.store:
                continue
            raw = zlib.decompress(self.store[key])
            block = np.frombuffer(raw, dtype=dtype).reshape(chunks)
            sl = tuple(
                slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
            )
            out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
        return out, dims

    # -- group-level ops ----------------------------------------------------

    def consolidate(self):
        meta = {}
        for key in self.store.list_prefix(""):
            leaf = key.rsplit("/", 1)[-1]
            if leaf in (".zgroup", ".zarray", ".zattrs"):
                meta[key] = self._read_json(key)
        self._write_json(
            ".zmetadata", {"zarr_consolidated_format": 1, "metadata": meta}
        )

    def write_field(self, field: Field, var_name: str = "forecast",
                    time_chunk: int = 1, channel_chunk: int | None = None):
        """``channel_chunk`` splits the channel dim into multiple chunks
        so per-step appends compress in parallel across ``workers``."""
        self._write_json(".zgroup", {"zarr_format": 2})
        self._write_json(".zattrs", dict(field.attrs))
        chunks = tuple(
            time_chunk if d == "time"
            else (min(channel_chunk, s) if (d == "channel" and channel_chunk)
                  else s)
            for d, s in field.sizes.items()
        )
        data = field.data
        if data.dtype == np.float64:
            data = data.astype(np.float32)
        self.write_array(var_name, data, field.dims, chunks)
        for dim, coord in field.coords.items():
            enc = coord
            attrs = {}
            if dim == "time":
                enc = (coord.astype("datetime64[ns]").astype("int64") / 3.6e12).astype(
                    "float64"
                )
                attrs = {"units": "hours since 1970-01-01 00:00:00", "calendar": "proleptic_gregorian"}
            self.write_array(dim, enc, (dim,), attrs=attrs)
        self.consolidate()

    def append_field(self, field: Field, var_name: str = "forecast", append_dim: str = "time"):
        """Append along ``append_dim`` (reference common.py:155-160 semantics)."""
        if not self.exists() or f"{var_name}/.zarray" not in self.store:
            self.write_field(field, var_name)
            return
        meta = self._read_json(f"{var_name}/.zarray")
        zattrs = self._read_json(f"{var_name}/.zattrs")
        dims = zattrs["_ARRAY_DIMENSIONS"]
        ax = dims.index(append_dim)
        old_n = meta["shape"][ax]
        chunks = meta["chunks"]
        if chunks[ax] != 1:
            raise ValueError("append requires chunk size 1 along append dim")
        new = field.transpose(*dims)
        data = new.data
        if data.dtype == np.float64:
            data = data.astype(np.float32)
        data = data.astype(np.dtype(meta["dtype"]))
        items = []
        grid = [1 if d == ax else -(-s // c)
                for d, (s, c) in enumerate(zip(data.shape, chunks))]
        for k in range(data.shape[ax]):
            frame = np.take(data, [k], axis=ax)
            for idx in np.ndindex(*grid):
                sl = tuple(
                    slice(0, 1) if d == ax else slice(i * c, (i + 1) * c)
                    for d, (i, c) in enumerate(zip(idx, chunks))
                )
                block = frame[sl]
                want = tuple(1 if d == ax else c
                             for d, c in enumerate(chunks))
                if block.shape != want:  # pad partial edge chunks
                    pad = np.zeros(want, dtype=data.dtype)
                    pad[tuple(slice(0, s) for s in block.shape)] = block
                    block = pad
                key = [str(i) for i in idx]
                key[ax] = str(old_n + k)
                items.append((".".join(key), block))
        self._write_chunks(var_name, items)
        meta["shape"][ax] += data.shape[ax]
        self._write_json(f"{var_name}/.zarray", meta)
        # extend the append-dim coord
        if f"{append_dim}/.zarray" in self.store and append_dim in field.coords:
            old_coord, _ = self.read_array(append_dim)
            coord = field.coords[append_dim]
            if append_dim == "time":
                coord = (
                    coord.astype("datetime64[ns]").astype("int64") / 3.6e12
                ).astype("float64")
            merged = np.concatenate([old_coord, coord])
            self.write_array(
                append_dim,
                merged,
                (append_dim,),
                attrs={"units": "hours since 1970-01-01 00:00:00"} if append_dim == "time" else None,
            )
        self.consolidate()

    def read_field(self, var_name: str | None = None) -> Field:
        keys = {k.split("/")[0] for k in self.store.list_prefix("") if "/" in k}
        arrays = {k for k in keys if f"{k}/.zarray" in self.store}
        if var_name is None:
            data_vars = [
                k for k in arrays if len(self._read_json(f"{k}/.zarray")["shape"]) >= 2
            ]
            if not data_vars:
                raise ValueError("no data variable in store")
            var_name = sorted(data_vars)[0]
        data, dims = self.read_array(var_name)
        coords = {}
        for dim in dims:
            if dim in arrays:
                cdata, _ = self.read_array(dim)
                if dim == "time":
                    cdata = np.datetime64("1970-01-01", "ns") + (
                        cdata * 3.6e12
                    ).astype("timedelta64[ns]")
                if cdata.dtype.kind == "U":
                    cdata = cdata.astype(object)
                coords[dim] = cdata
        attrs = self._read_json(".zattrs") if ".zattrs" in self.store else {}
        return Field(data, tuple(dims), coords, attrs, name=var_name)


def write_zarr(field: Field, target, var_name: str = "forecast", append: bool = False,
               append_dim: str = "time", **storage_options):
    zs = ZarrStore(open_store(target, **storage_options))
    if append and zs.exists():
        zs.append_field(field, var_name, append_dim)
    else:
        zs.write_field(field, var_name)
    return zs


def read_zarr(target, var_name: str | None = None, **storage_options) -> Field:
    return ZarrStore(open_store(target, **storage_options)).read_field(var_name)

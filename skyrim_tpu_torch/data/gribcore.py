"""ctypes binding of the GRIB decoder's native fast path (port of
skyrim_tpu/data/gribcore.py).

The source is the port's own copy, ``skyrim_tpu_torch/native/gribcore.cc``,
a host library with a plain C interface.  It is built at first use with
the host's ``g++ -O3 -fPIC -std=c++17 -shared`` into
``build/skyrim_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one is reused.  Where no compiler is
found, or the build fails, a warning is logged and data/grib.py keeps its
numpy path.  ``install()`` wires the library into grib.py's
``_unpack_bits_impl`` and ``_decode_simple_impl`` hooks; ``available()``
says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from skyrim_tpu_torch.utils.logging import logger

SOURCE = Path(__file__).resolve().parents[1] / "native" / "gribcore.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "skyrim_tpu_torch"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_tried = False
_lock = threading.Lock()


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgribcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises with the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native GRIB decoder needs a host C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} gribcore.cc (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded library, built first if needed; None (with a warning)
    where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                logger.warning("native GRIB decoder unavailable, using numpy: %s", e)
                return None
            lib.gribcore_unpack_bits.restype = ctypes.c_int
            lib.gribcore_unpack_bits.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.gribcore_decode_simple.restype = ctypes.c_int
            lib.gribcore_decode_simple.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
                ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.gribcore_undo_second_diff.restype = None
            lib.gribcore_undo_second_diff.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return load() is not None


def unpack_bits(data: bytes, nbits: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    rc = load().gribcore_unpack_bits(
        data, len(data), nbits, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    )
    if rc != 0:
        raise ValueError(f"gribcore_unpack_bits failed (rc={rc})")
    return out


def decode_simple(data: bytes, nbits: int, n: int, R: float, E: int, D: int) -> np.ndarray:
    out = np.empty(n, dtype=np.float32)
    rc = load().gribcore_decode_simple(
        data, len(data), nbits, n, R, E, D,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"gribcore_decode_simple failed (rc={rc})")
    return out


def install() -> bool:
    """Wire the native fast path into data/grib.py. Returns success."""
    if load() is None:
        return False
    from skyrim_tpu_torch.data import grib

    grib._unpack_bits_impl = unpack_bits
    grib._decode_simple_impl = decode_simple
    return True

"""ctypes bindings to the native data-plane library ``native/fastpack.cpp``:
the counterpart of ``pangu_tpu/data/fastpack.py`` (``unpack_i16``,
``stack_flip``, ``normalize``).

The library is host code (multithreaded C++ for the ERA5 ingest), not a
device kernel.  It is built at first use with ``g++`` and the flags of
``native/build.sh`` into ``pangu_tpu_torch/_build/`` (ignored by git; the
source is read, never written), named by a hash of the source and flags.
Where no compiler or build is available every entry point runs the JAX
package's numpy route instead; :func:`route` says which one loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "fastpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# native/build.sh's flags
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def _build() -> Path:
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(repr(CXX_FLAGS).encode() + src).hexdigest()[:16]
    lib = BUILD_DIR / f"libfastpack_{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = Path(tmp) / lib.name
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp_lib)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all
    return lib


@functools.cache
def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first call), or None where it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.fp_unpack_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int]
    lib.fp_unpack_i16.restype = None
    lib.fp_stack_flip.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int]
    lib.fp_stack_flip.restype = None
    lib.fp_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int]
    lib.fp_normalize.restype = None
    lib.fp_version.argtypes = []
    lib.fp_version.restype = ctypes.c_int32
    if lib.fp_version() != 1:
        return None
    return lib


def route() -> str:
    """"native" where the library loaded, else "numpy"."""
    return "native" if load() is not None else "numpy"


def unpack_i16(src: np.ndarray, scale: float, offset: float,
               fill: Optional[int] = None) -> np.ndarray:
    """CF int16 unpacking: src * scale + offset (fill -> NaN)."""
    src = np.ascontiguousarray(src, dtype=np.int16)
    lib = load()
    if lib is None:
        out = src.astype(np.float32) * np.float32(scale) + np.float32(offset)
        if fill is not None:
            out = np.where(src == fill, np.nan, out).astype(np.float32)
        return out
    dst = np.empty(src.shape, np.float32)
    lib.fp_unpack_i16(src.ctypes.data, dst.ctypes.data, src.size,
                      float(scale), float(offset),
                      int(fill or 0), int(fill is not None), _threads())
    return dst


def stack_flip(fields: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-variable (levels, lat, lon) cubes into
    (vars, levels, lat, lon) with the level axis reversed."""
    fields = [np.ascontiguousarray(f, dtype=np.float32) for f in fields]
    if any(f.shape != fields[0].shape for f in fields):
        raise ValueError(f"stack_flip: shapes differ "
                         f"{[f.shape for f in fields]}")
    levels = fields[0].shape[0]
    plane = int(np.prod(fields[0].shape[1:]))
    lib = load()
    if lib is None:
        return np.ascontiguousarray(np.stack(fields)[:, ::-1])
    out = np.empty((len(fields),) + fields[0].shape, np.float32)
    ptrs = (ctypes.c_void_p * len(fields))(*[f.ctypes.data for f in fields])
    lib.fp_stack_flip(ptrs, out.ctypes.data, len(fields), levels, plane,
                      _threads())
    return out


def normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """(x - mean) / std as a new array; mean/std broadcast over the trailing
    (lat, lon) plane."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    lead = int(np.prod(x.shape[:-2]))
    plane = int(np.prod(x.shape[-2:]))
    m = np.ascontiguousarray(np.broadcast_to(
        mean.reshape(mean.shape[0], -1, 1, 1), x.shape[:-2] + (1, 1)
    ).reshape(lead), np.float32)
    s = np.ascontiguousarray(np.broadcast_to(
        std.reshape(std.shape[0], -1, 1, 1), x.shape[:-2] + (1, 1)
    ).reshape(lead), np.float32)
    lib = load()
    if lib is None:
        return ((x.reshape(lead, plane) - m[:, None]) / s[:, None]
                ).reshape(x.shape)
    out = x.copy()
    lib.fp_normalize(out.ctypes.data, m.ctypes.data, s.ctypes.data,
                     lead, 1, plane, _threads())
    return out

"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by plain ``nvcc`` (one process per source,
all started together) for ``sm_90a`` and linked into ONE shared library with
a plain C interface, loaded with ``ctypes``.  No PyTorch headers are involved,
so a cold build takes seconds.  The library lands in ``_build/`` beside this
file (ignored by git), named by a hash of the sources and flags, and is built
at first use in a process, never at import.

``library()`` raises if ``nvcc`` is missing or a compile fails;
``check(code)`` raises on a nonzero ``cudaError_t`` returned by an entry.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-arch=sm_90a", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry: a pointer or the stream is c_void_p, an int c_int
_SIGNATURES = {
    "pangu_block_wm": [_I, _I] + [_P] * 18 + [_I] * 20 + [_P],
    "pangu_down_sample": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "pangu_up_sample": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    "pangu_down_sample_wm": [_I] + [_P] * 6 + [_I] * 16 + [_P],
    "pangu_up_sample_wm": [_I] + [_P] * 7 + [_I] * 17 + [_P],
    "pangu_embed_wm": [_I] + [_P] * 6 + [_I] * 14 + [_P],
    "pangu_transition_wm": [_I] + [_P] * 10 + [_I] * 13 + [_P],
    "pangu_recovery_wm": [_I] * 2 + [_P] * 5 + [_I] * 17 + [_P],
    "pangu_block_bwd": [_I, _I] + [_P] * 25 + [_I] * 22 + [_P],
    "pangu_embed_dw": [_I] + [_P] * 5 + [_I] * 14 + [_P],
    "pangu_recovery_bwd": [_I] + [_P] * 11 + [_I] * 18 + [_P],
    "pangu_grid_attn": [_I, _I] + [_P] * 9 + [_I] * 10 + [_P],
    "pangu_grid_attn_bwd": [_I, _I] + [_P] * 13 + [_I] * 10 + [_P],
    "pangu_block_noroll": [_I, _I] + [_P] * 16 + [_I] * 12 + [_P],
    "pangu_block_tail": [_I] + [_P] * 12 + [_I] * 4 + [_P],
    "pangu_sdpa": [_I] + [_P] * 3 + [_I] * 5 + [_P],
    "pangu_sdpa_bwd": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "pangu_window_attn": [_I] + [_P] * 8 + [_I] * 5 + [_P],
}
_LL = ctypes.c_longlong
# entries that return a size (long long) instead of a cudaError_t
_SIZE_SIGNATURES = {
    "pangu_block_bwd_ws": [_LL, _I, _I, _I],
    "pangu_embed_dw_ws": [_I] * 11,
    "pangu_recovery_bwd_ws": [_I] * 7,
    "pangu_grid_attn_ws": [_LL, _I, _I],
    "pangu_window_attn_ws": [_LL, _I],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into ``_build/libpangu_kernels_<hash>.so`` unless
    that file exists already; return its path."""
    lib = BUILD_DIR / f"libpangu_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all or none
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _LL
    lib.pangu_error_string.argtypes = [ctypes.c_int]
    lib.pangu_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().pangu_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

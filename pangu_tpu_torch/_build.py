"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by plain ``nvcc`` (one process per source,
or per part of a source listed in ``PARTS``, all started together) for ``sm_90a`` and linked into ONE shared library with
a plain C interface, loaded with ``ctypes``.  No PyTorch headers are involved,
so a cold build takes seconds.  The library lands in ``_build/`` beside this
file (ignored by git), named by a hash of the sources and flags, and is built
at first use in a process, never at import.

``library()`` raises if ``nvcc`` is missing or a compile fails;
``check(code)`` raises on a nonzero ``cudaError_t`` returned by an entry;
``launch_stream(*tensors)`` is the one way a launch gets its stream: it
makes the CUDA device of the launch's tensors current around the launch.
The sources in ``VERBOSE_SOURCES`` are compiled with ``-Xptxas -v`` besides,
and ``ptxas_report()`` returns what ptxas said of their kernels (registers,
spills, shared memory), each object's part headed ``== <stem>_<part>``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-arch=sm_90a", "-Xcompiler", "-fPIC"]
# compiled with -Xptxas -v too (it reports; the code is the same)
VERBOSE_SOURCES = ("sdpa.cu", "block_bwd.cu", "grid_attn.cu", "block_wm.cu",
                   "block_tail.cu", "recovery_bwd.cu", "updown_wm.cu",
                   "transition_wm.cu", "recovery_wm.cu", "embed_wm.cu",
                   "embed_dw.cu", "updown.cu", "window_attn.cu")
# sources built as several objects in parallel, one per set of defines (the
# source says what each part holds)
PARTS = {"sdpa.cu": (["-DSDPA_PART=0"], ["-DSDPA_PART=1"]),
         "block_bwd.cu": (["-DBLOCK_BWD_PART=0"], ["-DBLOCK_BWD_PART=1"]),
         "block_wm.cu": (["-DBLOCK_WM_PART=0"], ["-DBLOCK_WM_PART=1"]),
         "grid_attn.cu": (["-DGRID_ATTN_PART=0"], ["-DGRID_ATTN_PART=1"],
                          ["-DGRID_ATTN_PART=2"]),
         "window_attn.cu": (["-DWINDOW_ATTN_PART=0"],
                            ["-DWINDOW_ATTN_PART=1"])}

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
    "pangu_transition_wm": [_I] + [_P] * 10 + [_I] * 15 + [_P],
    "pangu_recovery_wm": [_I] * 2 + [_P] * 5 + [_I] * 17 + [_P],
    "pangu_block_bwd": [_I, _I] + [_P] * 25 + [_I] * 22 + [_P],
    "pangu_embed_dw": [_I] + [_P] * 5 + [_I] * 14 + [_P],
    "pangu_recovery_bwd": [_I] + [_P] * 11 + [_I] * 18 + [_P],
    "pangu_recovery_cot_wm": [_P] * 3 + [_I] * 17 + [_P],
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
    "pangu_recovery_bwd_ws": [_I] * 13,
    "pangu_grid_attn_ws": [_LL, _I, _I],
    "pangu_window_attn_ws": [_LL, _I],
    "pangu_sdpa_ws": [_I] * 4,
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
    h = hashlib.sha256(repr((NVCC_FLAGS, VERBOSE_SOURCES, PARTS)).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _report_path(digest: str) -> Path:
    return BUILD_DIR / f"ptxas_{digest}.txt"


def build() -> Path:
    """Compile the sources into ``_build/libpangu_kernels_<hash>.so`` unless
    that file exists already; return its path."""
    digest = _digest()
    lib = BUILD_DIR / f"libpangu_kernels_{digest}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            verbose = ["-Xptxas", "-v"] if src.name in VERBOSE_SOURCES else []
            for i, defines in enumerate(PARTS.get(src.name, ([],))):
                obj = Path(tmp) / f"{src.stem}_{i}.o"
                procs.append((src, obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *verbose, *defines, "-c", str(src),
                     "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        errors, report = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
            elif src.name in VERBOSE_SOURCES:
                report.append(f"== {obj.stem}\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        _report_path(digest).write_text("".join(report))
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


def ptxas_report() -> str:
    """What ptxas printed for ``VERBOSE_SOURCES`` in the build of the
    current sources (built first if need be)."""
    build()
    return _report_path(_digest()).read_text()


@contextlib.contextmanager
def launch_stream(*tensors):
    """Around one kernel launch: check that every tensor of the launch
    (``None`` entries skipped) lies on one CUDA device, make that device
    the current one (the C entries launch on the runtime's current
    device), and yield the handle of its current stream for the entry."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("a kernel launch needs all its tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    (device,) = devices
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().pangu_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

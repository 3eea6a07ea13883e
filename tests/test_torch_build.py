"""The kernel build and its ctypes binding, checked without a card: the
argtypes declared for every C entry match the entry's signature in the CUDA
source, every pointer and the stream are c_void_p, and a missing nvcc is a
clear error rather than a silent fallback."""

import ctypes
import re

import pytest

from pangu_tpu_torch import _build


def _c_signature(name):
    src = "\n".join(p.read_text() for p in _build._sources())
    m = re.search(r'extern "C" int ' + name + r"\s*\(([^)]*)\)", src)
    assert m, name
    params = [p.strip() for p in m.group(1).split(",")]
    return ["ptr" if "*" in p else p.split()[0] for p in params]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_argtypes_match_cuda_signature(name):
    kinds = _c_signature(name)
    want = [ctypes.c_void_p if k == "ptr" else ctypes.c_int for k in kinds]
    assert kinds[-1] == "ptr"           # the stream
    assert _build._SIGNATURES[name] == want


def test_build_flags_target_hopper():
    assert "-arch=sm_90a" in _build.NVCC_FLAGS
    assert "-O3" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.name == "_build"
    assert {p.suffix for p in _build._sources()} == {".cu"}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()

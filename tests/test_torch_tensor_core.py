"""The bf16 route of the backward units (the block backward and the grid
attention backward) on Hopper's tensor cores, checked on the CPU: what the
wrappers refuse before a launch, the 16-byte alignment of the operands
their tiles copy, and, scanned from the sources, that ``csrc/block_bwd.cu``
and ``csrc/grid_attn.cu`` reach their products and attention only through
the dtype dispatch of ``csrc/mma_gemm.cuh`` and ``csrc/wattn_mma.cuh``,
whose bf16 branches run the tensor-core kernels (``mma.sync``) and whose
float32 branches the first CUDA-core kernels.  The kernels themselves run
only on the card (``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import pytest
import torch

from pangu_tpu_torch.ops.earth_block_bwd import (aligned16,
                                                 check_tensor_core_shape)

CSRC = Path(__file__).resolve().parent.parent / "pangu_tpu_torch" / "csrc"


def _code(name):
    """A source without its comments."""
    text = (CSRC / name).read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("channels,n", [((16, 64), 144), ((384, 1536), 144),
                                        ((192,), None), ((48, 192), 37)])
def test_tensor_core_shapes_are_taken(channels, n):
    check_tensor_core_shape(channels, n, "test")


@pytest.mark.parametrize("channels,n", [((20, 80), 144), ((16, 60), 144),
                                        ((16, 64), 145), ((12,), None)])
def test_tensor_core_shapes_outside_the_tiles_raise(channels, n):
    with pytest.raises(ValueError, match="multiples of 8"):
        check_tensor_core_shape(channels, n, "test")


def test_aligned16_copies_only_a_misaligned_tensor():
    base = torch.arange(64, dtype=torch.bfloat16)
    assert aligned16(base) is base
    view = base[1:17]                   # 2 bytes past a 16-byte boundary
    assert view.data_ptr() % 16 != 0
    copy = aligned16(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


@pytest.mark.parametrize("source", ["block_bwd.cu", "grid_attn.cu"])
def test_backward_units_reach_products_and_attention_through_the_dispatch(
        source):
    """No direct call of grad_gemm.cuh's xgemm / wgrad or of attn_bwd.cuh's
    attention backward: every product of the backward units is a
    unit_gemm / unit_wgrad (or, in grid_attn.cu's bf16 qkv product, an
    mma_gemm), every attention of a backward a unit_attention(_bwd)."""
    code = _code(source)
    assert not re.search(r"\bxgemm\s*\(", code)
    assert not re.search(r"\bwgrad\s*<", code)
    assert not re.search(r"\battention_bwd\s*<", code)
    assert re.search(r"\bunit_gemm\s*<", code)
    assert re.search(r"\bunit_wgrad\s*\(", code)
    assert re.search(r"\bunit_attention_bwd\s*<", code)
    body = code[code.index("grid_attn_bwd(") if source == "grid_attn.cu"
                else code.index("int block_bwd("):]
    body = body[:body.index("\n}\n")]
    assert not re.search(r"\bwindow_attention\s*<", body)  # the recompute
    assert re.search(r"\bunit_attention\s*<", body)


def test_dispatch_sends_bf16_to_the_tensor_cores():
    """The bf16 branch of each dispatch names the tensor-core entry, the
    float32 branch the first version's kernel; the tensor-core kernels use
    mma.sync through attn_mma.cuh."""
    gemm, attn = _code("mma_gemm.cuh"), _code("wattn_mma.cuh")
    for code, pairs in ((gemm, [("unit_gemm", "mma_gemm<kBT>", "xgemm("),
                                ("unit_wgrad", "mma_wgrad(", "wgrad<T>(")]),
                        (attn, [("unit_attention", "wa_attention<TB>(",
                                 "window_attention<T, TB>("),
                                ("unit_attention_bwd", "wa_attention_bwd<TB>(",
                                 "attention_bwd<T, TB>(")])):
        for fn, tc, first in pairs:
            body = code[code.index(f"inline int {fn}("):]
            body = body[:body.index("\n}\n")]
            bf16 = body[body.index("std::is_same<T, bf16>"):]
            assert bf16.index(tc) < bf16.index(first)
    assert "mma_bf16(" in gemm and "mma_bf16(" in attn
    assert "mma.sync.aligned.m16n8k16" in _code("attn_mma.cuh")

"""The bf16 route of the block kernel, its backward, the grid attention
(forward and backward), the block tail and the recovery backward on
Hopper's tensor cores, checked on the CPU: what the wrappers refuse before
a launch, the 16-byte alignment of the operands their tiles copy, and,
scanned from the sources, that ``csrc/block_wm.cu``, ``csrc/block_bwd.cu``,
``csrc/grid_attn.cu`` and ``csrc/block_tail.cu`` reach their products and
attention only through the dtype dispatches of ``csrc/mma_gemm.cuh`` and
``csrc/wattn_mma.cuh`` (or, in the block kernel, its own attention
dispatch), whose bf16 branches run the tensor-core kernels (``mma.sync``)
and whose float32 branches the first CUDA-core kernels, and that the bf16
route of ``csrc/recovery_bwd.cu`` runs its products on ``mma_gemm.cuh``;
and that the bf16 route of ``csrc/updown_wm.cu`` (DownSample, UpSample)
runs its products on ``mma_gemm.cuh`` with the pad-row epilogue and its
gather and LayerNorm in one pass, what its wrappers refuse before a launch
and the alignment of their operands; and that the bf16 transition, the
recovery (both branches) and the embed (``csrc/transition_wm.cu``,
``csrc/recovery_wm.cu``, ``csrc/embed_wm.cu``) run on
``csrc/edge_mma.cuh``'s tensor-core kernel and float32 on
``csrc/edge_gemm.cuh``'s first kernels, what the recovery's and the
embed's wrappers refuse before a launch and the alignment of their
operands; and that the bf16 upper embed weight gradient
(``csrc/embed_dw.cu``: a relayout, then one transposed-A product of
``mma_gemm.cuh`` whose bias row is an indicator column, not a row of
ones) and the bf16 canonical UpSample (``csrc/updown.cu``: two
``mma_gemm.cuh`` products around the gather + LayerNorm kernel that the
window-major UpSample runs too, ``csrc/updown_rows.cuh``) run on the
tensor cores while float32 keeps the first kernels (``grad_gemm.cuh`` has
no bf16 route left), what their wrappers refuse before a launch and the
alignment of their operands; and that the bf16 canonical DownSample
(``csrc/updown.cu``: the gather + LayerNorm kernel that the window-major
DownSample runs too, then one ``mma_gemm.cuh`` product) and the bf16 fused
window attention (``csrc/window_attn.cu``: the qkv product with q scaled
in its epilogue, ``wattn_mma.cuh``'s attention with the logit scale 1, the
proj product) run on the tensor cores while float32 keeps the first
kernels, what their wrappers refuse before a launch and the alignment of
their operands.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from pangu_tpu_torch.config import PANGU_24, TINY
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.ops.block_tail import tail_operands
from pangu_tpu_torch.ops.earth_block_wm import (aligned16, block_operands,
                                                check_tensor_core_shape)
from pangu_tpu_torch.ops.embed_wm import embed_dw_operands, embed_operands
from pangu_tpu_torch.ops.recovery_wm import recovery_operands
from pangu_tpu_torch.ops.updown import (LN_ROW_MAX, check_updown_shape,
                                        down_sample_operands,
                                        up_sample_operands)
from pangu_tpu_torch.ops.updown_wm import down_operands, up_operands
from pangu_tpu_torch.ops.window_attention import _checked, window_operands

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
    unit_gemm / unit_wgrad (or, in the recomputed qkv product, a fwd_gemm),
    every attention of a backward a unit_attention(_bwd)."""
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


def _body(code, head):
    """The body of the function whose definition starts with ``head``."""
    body = code[code.index(head):]
    return body[:body.index("\n}\n")]


def test_block_forward_reaches_products_through_fwd_gemm():
    """The block kernel's four products and the grid attention's qkv
    product go through fwd_gemm only, whose bf16 branch is mma_gemm (the
    tensor cores) and whose float32 branch common.cuh's gemm."""
    block, grid = _code("block_wm.cu"), _code("grid_attn.cu")
    for code in (block, grid):
        assert not re.search(r"(?<![\w.])gemm\s*\(", code)
        assert not re.search(r"\bmma_gemm\s*<", code)
    assert len(re.findall(r"\bfwd_gemm\s*\(", _body(block, "int block_wm("))) == 4
    assert re.search(r"\bfwd_gemm\s*\(", _body(grid, "int grid_qkv("))
    body = _body(_code("mma_gemm.cuh"), "inline int fwd_gemm(")
    bf16, f32 = body.split("} else {")
    assert "std::is_same<T, bf16>" in bf16
    assert "mma_gemm<false>(" in bf16 and "BiasEpi<T>" in bf16
    assert "ZhEpi<T>{bias, nullptr, out" in bf16
    assert "gemm(a, w, bias, out" in f32 and "mma_gemm" not in f32


def test_block_forward_attention_dispatch():
    """bf16: wa_attention (tensor cores) whatever gh; float32: the CUDA-core
    window_attention, or group_attn_kernel where gh > 1.  No bf16 branch
    names the CUDA-core attention, and the grid attention's forward goes
    through unit_attention."""
    block = _code("block_wm.cu")
    body = _body(block, "int block_attention(")
    bf16, f32 = body.split("} else {", 1)
    assert "std::is_same<T, bf16>" in bf16 and "wa_attention<TB>(" in bf16
    for first in ("window_attention", "group_attn_kernel", "window_attn_kernel"):
        assert first not in bf16
    assert "window_attention<T, TB>(" in f32
    assert "group_attn_kernel<T, TB>" in f32
    assert "gemm_bf16_kernel" not in block and "window_attn_kernel" not in block
    assert re.search(r"\bblock_attention\s*<", _body(block, "int block_wm("))
    fwd = _body(_code("grid_attn.cu"), "int grid_attn(")
    assert re.search(r"\bunit_attention\s*<", fwd)
    assert not re.search(r"\bwindow_attention\s*<", fwd)


def test_block_forward_row_passes_by_dtype():
    """The block kernel's gather and LayerNorm passes go through the dtype
    dispatches of block_common.cuh: bf16 the 16-byte kernels, float32 the
    first version's (the float32 outputs stay the same bit for bit)."""
    common = _code("block_common.cuh")
    for head, vec, first in (("inline void block_gather(",
                              "block_gather16_kernel<<<",
                              "block_gather_kernel<T><<<"),
                             ("inline void block_ln(", "ln_rows16_kernel<<<",
                              "ln_rows<T>(")):
        body = _body(common, head)
        assert body.index("std::is_same<T, bf16>") < body.index(vec)
        assert body.index(vec) < body.index("else") < body.index(first)
    block = _body(_code("block_wm.cu"), "int block_wm(")
    assert "block_gather<T>(" in block and block.count("block_ln<T>(") == 2
    assert not re.search(r"\bln_rows\s*<|block_gather_kernel", block)


def _block_params(c, hidden, heads, ntype, n, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return (0.02 * torch.randn(shape, generator=g)).to(dtype)

    return {"attn": {"qkv": {"kernel": r(c, 3 * c), "bias": r(3 * c)},
                     "proj": {"kernel": r(c, c), "bias": r(c)},
                     "bias_table": r(ntype, heads, n, n)},
            "norm1": {"scale": r(c), "bias": r(c)},
            "norm2": {"scale": r(c), "bias": r(c)},
            "mlp": {"fc1": {"kernel": r(c, hidden), "bias": r(hidden)},
                    "fc2": {"kernel": r(hidden, c), "bias": r(c)}}}


# (C, hidden, heads, window): TINY's stage 0 is C 16, hidden 64, 2 heads,
# window (2, 6, 12); the rest break one bound of the bf16 route each
BF16_SHAPES = {"taken": (16, 64, 2, (2, 6, 12)),
               "c20": (20, 80, 2, (2, 6, 12)),
               "hidden60": (16, 60, 2, (2, 6, 12)),
               "n192": (16, 64, 2, (2, 6, 16))}


def _stage(c, heads, window):
    return dataclasses.replace(TINY.stage(0), dim=c, heads=heads,
                               window=window)


@pytest.mark.parametrize("case", sorted(BF16_SHAPES))
def test_bf16_block_checks_shapes_before_a_launch(case):
    """``block_operands``, which every block wrapper (wm, grouped, canon
    ends, drop, v2, no-roll) runs before a launch, raises ValueError on a
    bf16 block whose C or hidden is not a multiple of 8 or whose window
    holds more than 144 tokens, and takes the rest; float32 keeps the
    CUDA-core kernels' shapes.  CPU tensors: nothing is launched."""
    c, hidden, heads, window = BF16_SHAPES[case]
    geom = _stage(c, heads, window)
    wz, wh, ww = window
    n = wz * wh * ww
    nz, nlat, nlon = geom.z // wz, geom.h_padded // wh, geom.w // ww
    for dtype in (torch.bfloat16, torch.float32):
        p = _block_params(c, hidden, heads, nz * nlat, n, dtype)
        x = torch.zeros((1, nz, nlat, nlon, n, c), dtype=dtype)
        if case == "taken" or dtype == torch.float32:
            block_operands(p, x, geom, 1, False, "block_wm")
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                block_operands(p, x, geom, 1, False, "block_wm")


@pytest.mark.parametrize("case", ["taken", "c20", "n192"])
def test_bf16_grid_attention_checks_shapes_before_a_launch(case):
    """The grid attention's check (forward and backward) raises ValueError
    on a bf16 C that is not a multiple of 8 or a window of more than 144
    tokens, and takes the rest."""
    c, _, heads, window = BF16_SHAPES[case]
    geom = _stage(c, heads, window)
    wz, wh, ww = window
    n = wz * wh * ww
    ntype = (geom.z // wz) * (geom.h_padded // wh)
    bf = torch.bfloat16
    x = torch.zeros((1, geom.z, geom.h_padded, geom.w, c), dtype=bf)
    weights = [torch.zeros(s, dtype=bf) for s in ((c, 3 * c), (3 * c,),
                                                  (c, c), (c,))]
    table = torch.zeros((ntype, heads, n, n))
    if case == "taken":
        _checked(x, weights, table, window, None, "grid_attention")
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            _checked(x, weights, table, window, None, "grid_attention")


def test_bf16_forward_operands_are_16_byte_aligned():
    """A bf16 block input or grid that starts off a 16-byte boundary is
    handed to the kernel as an aligned copy (the 16-byte row passes read
    it), and so are the four weights."""
    c, hidden, heads, window = BF16_SHAPES["taken"]
    geom = _stage(c, heads, window)
    wz, wh, ww = window
    n = wz * wh * ww
    nz, nlat, nlon = geom.z // wz, geom.h_padded // wh, geom.w // ww
    p = _block_params(c, hidden, heads, nz * nlat, n)
    p["attn"]["qkv"]["kernel"] = torch.zeros(
        c * 3 * c + 1, dtype=torch.bfloat16)[1:].view(c, 3 * c)
    shape = (1, nz, nlat, nlon, n, c)
    numel = torch.Size(shape).numel()
    x = torch.randn(numel + 1).to(torch.bfloat16)[1:].view(shape)
    assert x.data_ptr() % 16
    got, q, _, _, _ = block_operands(p, x, geom, 1, False, "block_wm")
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    assert all(q[s][l]["kernel"].data_ptr() % 16 == 0 for s, l in (
        ("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")))
    grid = torch.randn(x.numel() + 1).to(torch.bfloat16)[1:].view(
        1, geom.z, geom.h_padded, geom.w, c)
    weights = [torch.zeros(s) for s in ((c, 3 * c), (3 * c,), (c, c), (c,))]
    got, _, _, _ = _checked(grid, weights, torch.zeros(nz * nlat, heads, n, n),
                            window, None, "grid_attention")
    assert got.data_ptr() % 16 == 0 and torch.equal(got, grid)


def test_block_tail_reaches_products_and_row_passes_through_the_dispatch():
    """The tail's two products go through fwd_gemm and its two LayerNorm
    passes through block_ln, as the block kernel's steps 5-8 do: bf16 on
    the tensor cores and the 16-byte row kernels, float32 on the first
    version's kernels."""
    body = _body(_code("block_tail.cu"), "int block_tail(")
    assert len(re.findall(r"\bfwd_gemm\s*\(", body)) == 2
    assert body.count("block_ln<T>(") == 2
    assert not re.search(r"(?<![\w.])gemm\s*\(|\bln_rows\s*<|\bmma_gemm\s*<",
                         body)


def test_recovery_bwd_bf16_route_runs_on_the_tensor_cores():
    """The bf16 entry runs recovery_bwd_bf16, whose token-cotangent and
    weight-gradient products are mma_gemm.cuh's (no grad_gemm.cuh product
    and no gathering functor); float32 keeps the first version's xgemm /
    wgrad."""
    code = _code("recovery_bwd.cu")
    bf16 = _body(code, "static int recovery_bwd_bf16(")
    assert re.search(r"\bmma_gemm\s*<true>\s*\(", bf16)
    assert len(re.findall(r"\bmma_gemm_launch\s*<true,\s*false>", bf16)) == 2
    assert "field_cot_wm(" in bf16 and "head_sum_kernel<<<" in bf16
    for first in ("xgemm(", "wgrad<", "FieldCot", "PairCols", "PairStore"):
        assert first not in bf16
    f32 = _body(code, "int recovery_bwd(")
    assert "xgemm(" in f32 and "wgrad<T>(" in f32
    entry = _body(code, 'extern "C" int pangu_recovery_bwd(')
    assert entry.index("recovery_bwd<float>(") < entry.index(
        "recovery_bwd_bf16(")
    assert "recovery_bwd<bf16>" not in code


def _tail_params(c, hidden, dtype=torch.bfloat16):
    p = _block_params(c, hidden, 1, 1, 1, dtype)
    return {k: p[k] for k in ("norm1", "norm2", "mlp")}


@pytest.mark.parametrize("c,hidden", [(16, 64), (20, 80), (16, 60)])
def test_bf16_block_tail_checks_shapes_before_a_launch(c, hidden):
    """``tail_operands``, which the tail wrapper runs before a launch,
    raises ValueError on a bf16 C or hidden that is not a multiple of 8 and
    takes the rest; float32 keeps the CUDA-core kernels' shapes."""
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.zeros((37, c), dtype=dtype)
        p = _tail_params(c, hidden, dtype)
        if (c, hidden) == (16, 64) or dtype == torch.float32:
            tail_operands(p, a, a)
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                tail_operands(p, a, a)


def test_bf16_block_tail_operands_are_16_byte_aligned():
    """A bf16 attention branch, shortcut or dense weight that starts off a
    16-byte boundary is handed to the kernel as an aligned copy."""
    c, hidden = 16, 64
    p = _tail_params(c, hidden)
    p["mlp"]["fc2"]["kernel"] = torch.ones(
        hidden * c + 1, dtype=torch.bfloat16)[1:].view(hidden, c)
    a = torch.randn(37 * c + 1).to(torch.bfloat16)[1:].view(37, c)
    s = torch.randn(37 * c + 1).to(torch.bfloat16)[1:].view(37, c)
    assert a.data_ptr() % 16 and s.data_ptr() % 16
    a2, s2, q, got_hidden = tail_operands(p, a, s)
    assert got_hidden == hidden
    for got, want in ((a2, a), (s2, s)):
        assert got.data_ptr() % 16 == 0 and torch.equal(got, want)
    assert all(q["mlp"][leaf]["kernel"].data_ptr() % 16 == 0
               for leaf in ("fc1", "fc2"))


def test_updown_bf16_route_runs_on_the_tensor_cores():
    """The bf16 entries of csrc/updown_wm.cu run down_sample_wm_bf16 /
    up_sample_wm_bf16: one fused gather + LayerNorm pass each and their
    products on mma_gemm.cuh (one for DownSample, two for UpSample) with
    the pad-row epilogue, no common.cuh gemm, ln_rows or element-a-lane
    gather; float32 keeps the first version's gather, ln_rows and gemm."""
    code = _code("updown_wm.cu")
    for fn, products, gather in (("down_sample_wm_bf16(", 1,
                                  "down_gather_ln_kernel<"),
                                 ("up_sample_wm_bf16(", 2,
                                  "up_gather_ln_kernel<")):
        body = _body(code, f"static int {fn}")
        assert len(re.findall(r"\bmma_gemm\s*<false>\s*\(", body)) == products
        assert body.count("PadEpi<bf16>") == products
        assert gather in body
        assert not re.search(r"(?<![\w.])gemm\s*\(|\bln_rows\s*<|"
                             r"\b(down|up)_gather_kernel\b", body)
    for fn, gather in (("int down_sample_wm(", "down_gather_kernel<T>"),
                       ("int up_sample_wm(", "up_gather_kernel<T>")):
        body = _body(code, fn)
        assert re.search(r"(?<![\w.])gemm\s*\(", body)
        assert "ln_rows<T>(" in body and gather in body
        assert "mma_gemm" not in body
    for entry, f32, bf16 in (
            ('extern "C" int pangu_down_sample_wm(', "down_sample_wm<float>(",
             "down_sample_wm_bf16("),
            ('extern "C" int pangu_up_sample_wm(', "up_sample_wm<float>(",
             "up_sample_wm_bf16(")):
        body = _body(code, entry)
        assert body.index(f32) < body.index("aligned16_all(") < body.index(bf16)
    assert not re.search(r"\b(down|up)_sample_wm\s*<bf16>", code)
    epi = _body(_code("mma_gemm.cuh"), "struct PadEpi {")
    assert "is_pad_row(r, pad)" in epi and "PadRows pad;" in epi


# (channels, LayerNorm width) of DownSample and UpSample by config: (C,
# 2C) and 4C; (C2, C3) and C3
def _updown_shapes(cfg):
    c0, c2, c3 = cfg.stage(0).dim, cfg.stage(2).dim, cfg.stage(3).dim
    return {"down": ((c0, 2 * c0), 4 * c0), "up": ((c2, c3), c3)}


@pytest.mark.parametrize("cfg", [PANGU_24, TINY], ids=["full width", "TINY"])
@pytest.mark.parametrize("which", ["down", "up"])
def test_updown_shapes_are_taken(cfg, which):
    channels, ln_width = _updown_shapes(cfg)[which]
    check_updown_shape(channels, ln_width, "test")


@pytest.mark.parametrize("channels,ln_width,match", [
    ((20, 40), 80, "multiples of 8"), ((384, 12), 12, "multiples of 8"),
    ((8, 16), LN_ROW_MAX + 8, "LayerNorm rows")])
def test_updown_shapes_outside_the_bf16_route_raise(channels, ln_width,
                                                    match):
    with pytest.raises(ValueError, match=match):
        check_updown_shape(channels, ln_width, "test")


def _updown_params(c_in, c_out, which, dtype):
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return (0.02 * torch.randn(shape, generator=g)).to(dtype)

    if which == "down":
        return {"norm": {"scale": r(4 * c_in), "bias": r(4 * c_in)},
                "reduce": {"kernel": r(4 * c_in, 2 * c_in)}}
    return {"expand": {"kernel": r(c_in, 4 * c_out)},
            "norm": {"scale": r(c_out), "bias": r(c_out)},
            "mix": {"kernel": r(c_out, c_out)}}


def _updown_case(dims, which, dtype, misaligned=False):
    """(operands function, params, storage input, geometries) of TINY with
    the stage widths ``dims``; CPU tensors, nothing is launched."""
    cfg = dataclasses.replace(TINY, dims=dims)
    i, fn = (0, down_operands) if which == "down" else (2, up_operands)
    gin, gout = cfg.stage(i), cfg.stage(i + 1)
    wz, wh, ww = gin.window
    shape = (1, gin.z // wz, gin.h_padded // wh, gin.w // ww, wz * wh * ww,
             gin.dim)
    numel = torch.Size(shape).numel()
    x = torch.randn(numel + misaligned).to(dtype)[int(misaligned):].view(shape)
    return fn, _updown_params(gin.dim, gout.dim, which, dtype), x, gin, gout


@pytest.mark.parametrize("which", ["down", "up"])
@pytest.mark.parametrize("dims", [(16, 32, 32, 16), (20, 40, 40, 20)],
                         ids=["TINY", "C 20"])
def test_bf16_updown_checks_shapes_before_a_launch(which, dims):
    """``down_operands`` / ``up_operands``, which the wrappers run before a
    launch, raise ValueError on a bf16 input whose channels are not
    multiples of 8 and take TINY's; float32 takes both."""
    for dtype in (torch.bfloat16, torch.float32):
        fn, p, x, gin, gout = _updown_case(dims, which, dtype)
        if dims[0] % 8 == 0 or dtype == torch.float32:
            _, _, shape = fn(p, x, gin, gout)
            assert shape[:2] == x.shape[:2] and shape[-1] == gout.dim
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                fn(p, x, gin, gout)


@pytest.mark.parametrize("which", ["down", "up"])
def test_bf16_updown_operands_are_16_byte_aligned(which):
    """A bf16 input or weight that starts off a 16-byte boundary is handed
    to the kernel as an aligned copy."""
    fn, p, x, gin, gout = _updown_case((16, 32, 32, 16), which,
                                       torch.bfloat16, misaligned=True)
    leaf = "reduce" if which == "down" else "mix"
    w = p[leaf]["kernel"]
    p[leaf]["kernel"] = torch.zeros(w.numel() + 1,
                                    dtype=w.dtype)[1:].view(w.shape)
    assert x.data_ptr() % 16 and p[leaf]["kernel"].data_ptr() % 16
    got, q, _ = fn(p, x, gin, gout)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    for sub in q.values():
        assert all(t.data_ptr() % 16 == 0 for t in sub.values())


@pytest.mark.parametrize("source,fn,op,entry,first,bf16", [
    ("transition_wm.cu", "static int transition_wm_bf16(", "TransitionMma",
     'extern "C" int pangu_transition_wm(', "transition_wm<float>(",
     "transition_wm_bf16("),
    ("recovery_wm.cu", "static int recovery_bf16(", "RecoveryMma<kSurface>",
     'extern "C" int pangu_recovery_wm(', "recovery_wm<float>(",
     "recovery_bf16<false>"),
    ("recovery_wm.cu", "static int recovery_bf16(", "RecoveryMma<kSurface>",
     'extern "C" int pangu_recovery_wm(', "recovery_wm<float>(",
     "recovery_bf16<true>"),
    ("embed_wm.cu", "static int embed_wm_bf16(", "EmbedMma",
     'extern "C" int pangu_embed_wm(', "embed_wm<float>(", "embed_wm_bf16(")])
def test_edge_bf16_routes_run_on_the_tensor_cores(source, fn, op, entry, first,
                                                  bf16):
    """The bf16 transition, both recovery branches and the embed launch
    edge_mma.cuh's kernel (mma.sync fed by cp.async copies of the gathered
    rows: 16 bytes of the pair, 8 bytes (4 w_off values) of the embed's
    field) through their Op, after the entry's shape and alignment check;
    float32 keeps edge_gemm.cuh's first kernels, which have no bf16 route
    left."""
    code = _code(source)
    body = _body(code, fn)
    assert f"{op} op;" in body and re.search(r"\bedge_mma\(op, \w+\)", body)
    assert "edge_gemm(" not in body
    head = _body(code, entry)
    assert head.index(first) < head.index("aligned16_all(") < head.index(bf16)
    assert "edge_gemm(op, " in _body(code, "int " + first.replace("<float>",
                                                                  ""))
    assert first.replace("<float>", "<bf16>") not in code
    edge = _code("edge_mma.cuh")
    for name in ("load_a<T>(", "cp_async16_zfill(", "load_a_n(", "load_b_t(",
                 "mma_bf16("):
        assert name in _body(edge, "edge_mma_kernel(Op op) {")
    loader = (_body(code, "struct EmbedMma") if source == "embed_wm.cu"
              else _body(edge, "struct PairA"))
    assert ("cp_async8_zfill(" if source == "embed_wm.cu"
            else "cp_async16_zfill(") in loader
    first_route = _code("edge_gemm.cuh")
    assert "edge_gemm_bf16" not in first_route and "wmma" not in first_route


def _edge_case(which, dims, dtype, misaligned=False):
    """(call, operands' params) of the bf16 embed or recovery at TINY with
    the stage widths ``dims``: ``call()`` runs the operands function that
    the wrapper runs before a launch, on CPU tensors (nothing is
    launched); with ``misaligned``, the field-side inputs and the kernel
    start 2 bytes off a 16-byte boundary."""
    cfg = dataclasses.replace(TINY, dims=dims, compute_dtype="bfloat16"
                              if dtype == torch.bfloat16 else "float32")
    params = pangu.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")

    def off16(t):                   # the same values, 2 bytes further on
        t = t.to(dtype)
        if not misaligned:
            return t
        flat = torch.zeros(t.numel() + 1, dtype=dtype)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    if which == "embed":
        consts = to_device(synthetic_constants(cfg), "cpu")
        consts["const_h"] = off16(consts["const_h"])
        p = params["patch_embed"]
        p["upper"]["kernel"] = off16(p["upper"]["kernel"])
        g = torch.Generator().manual_seed(1)
        upper = torch.randn((1, 5, cfg.levels, cfg.lat, cfg.lon), generator=g)
        surface = torch.randn((1, 4, cfg.lat, cfg.lon), generator=g)
        return (lambda: embed_operands(p, upper, surface, consts, cfg)), p
    gs = cfg.stage(3)
    wz, wh, ww = gs.window
    shape = (1, gs.z // wz, gs.h_padded // wh, gs.w // ww, wz * wh * ww,
             gs.dim)
    skip, dec = (off16(torch.randn(shape)) for _ in range(2))
    p = params["patch_recovery"]
    head = "surface" if which == "recovery_surface" else "upper"
    p[head]["kernel"] = off16(p[head]["kernel"])
    return (lambda: recovery_operands(head == "surface", p, skip, dec,
                                      cfg)), p


@pytest.mark.parametrize("which", ["embed", "recovery_surface",
                                   "recovery_upper"])
@pytest.mark.parametrize("dims", [(16, 32, 32, 16), (20, 40, 40, 20)],
                         ids=["TINY", "C 20"])
def test_bf16_edge_checks_shapes_before_a_launch(which, dims):
    """``embed_operands`` / ``recovery_operands``, which the wrappers run
    before a launch, raise ValueError on a bf16 C that is not a multiple of
    8 and take TINY's; float32 takes both."""
    for dtype in (torch.bfloat16, torch.float32):
        call, _ = _edge_case(which, dims, dtype)
        if dims[0] % 8 == 0 or dtype == torch.float32:
            assert all(t.dtype == dtype for t in call()
                       if isinstance(t, torch.Tensor))
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                call()


@pytest.mark.parametrize("which", ["embed", "recovery_surface"])
def test_bf16_edge_operands_are_16_byte_aligned(which):
    """A bf16 field-side input or kernel that starts off a 16-byte boundary
    is handed to the embed or the surface recovery as an aligned copy of
    the same values."""
    call, p = _edge_case(which, (16, 32, 32, 16), torch.bfloat16,
                         misaligned=True)
    if which == "embed":
        w = p["upper"]["kernel"]
        assert w.data_ptr() % 16
        ops = call()
        assert torch.equal(ops[3], w)
    else:
        w = p["surface"]["kernel"]
        assert w.data_ptr() % 16
        skip, dec, q, _ = call()
        ops = (skip, dec, q["kernel"])
        assert torch.equal(q["kernel"], w)
    assert all(t.data_ptr() % 16 == 0 for t in ops)


def test_embed_dw_bf16_route_runs_on_the_tensor_cores():
    """The bf16 entry runs embed_dw_bf16: the relayout (patch_rows, which
    writes the indicator), one transposed-A mma_gemm.cuh product with no
    row of ones (``ones`` 0: mma_wgrad's row would sum plane 0 and the pad
    rows into db) and split_sum; no grad_gemm.cuh product or gathering
    functor.  float32 keeps the first version's wgrad, and grad_gemm.cuh
    has no bf16 route left."""
    code = _code("embed_dw.cu")
    bf16 = _body(code, "static int embed_dw_bf16(")
    m = re.search(r"\bmma_gemm_launch\s*<true,\s*false>\s*\(([^;]*)\);", bf16)
    assert [a.strip() for a in m.group(1).split(",")][3] == "0"
    assert "patch_rows(" in bf16 and "split_sum(" in bf16
    for first in ("wgrad<", "xgemm(", "PatchCols", "TokenRows", "mma_wgrad("):
        assert first not in bf16
    assert "0x3F80u" in _body(code, "patch_rows_kernel(")
    assert "wgrad<T>(" in _body(code, "int embed_dw(")
    entry = _body(code, 'extern "C" int pangu_embed_dw(')
    assert entry.index("embed_dw<float>(") < entry.index(
        "aligned16_all(") < entry.index("embed_dw_bf16(")
    assert "embed_dw<bf16>" not in code
    grad = _code("grad_gemm.cuh")
    assert "xgemm_bf16_kernel" not in grad and "wmma" not in grad
    assert "xgemm(bf16*" not in grad.replace(" ", "")


def test_canonical_up_sample_bf16_route_runs_on_the_tensor_cores():
    """The bf16 canonical UpSample: two mma_gemm.cuh products with a plain
    rounding store and one gather + LayerNorm pass, the kernel of
    updown_rows.cuh with the canonical row map -- the one the window-major
    UpSample launches with its rolled map; no common.cuh gemm, ln_rows or
    element-a-lane gather.  float32 keeps the first version's kernels."""
    code = _code("updown.cu")
    body = _body(code, "static int up_sample_bf16(")
    assert len(re.findall(r"\bmma_gemm\s*<false>\s*\(", body)) == 2
    assert body.count("RoundEpi<bf16>") == 2
    assert "up_gather_ln_kernel<NJ, UpCanonMap>" in body
    assert not re.search(r"(?<![\w.])gemm\s*\(|\bln_rows\s*<|"
                         r"\bup_canon_gather_kernel\b", body)
    f32 = _body(code, "int up_sample(")
    assert re.search(r"(?<![\w.])gemm\s*\(", f32)
    assert "ln_rows<T>(" in f32 and "up_canon_gather_kernel<T>" in f32
    entry = _body(code, 'extern "C" int pangu_up_sample(')
    assert entry.index("up_sample<float>(") < entry.index(
        "aligned16_all(") < entry.index("up_sample_bf16(")
    assert "up_sample<bf16>" not in code
    assert "up_gather_ln_kernel(" in _code("updown_rows.cuh")
    for source, rmap in (("updown.cu", "UpCanonMap"),
                         ("updown_wm.cu", "UpWmMap")):
        text = _code(source)
        assert '#include "updown_rows.cuh"' in text
        assert f"up_gather_ln_kernel<NJ, {rmap}>" in text
        assert not re.search(r"\bup_gather_ln_kernel\s*\(", text)


def _dw_case(dims, dtype, misaligned=False):
    """(dxs, upper, constants, cfg) of TINY with the stage widths ``dims``,
    batch 1, CPU tensors; with ``misaligned``, dxs starts 2 bytes off a
    16-byte boundary."""
    cfg = dataclasses.replace(TINY, dims=dims)
    consts = to_device(synthetic_constants(cfg), "cpu")
    g = cfg.stage(0)
    wz, wh, ww = g.window
    shape = (1, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, g.dim)
    numel = torch.Size(shape).numel()
    dxs = torch.randn(numel + misaligned).to(dtype)[int(misaligned):]
    upper = torch.randn((1, 5, cfg.levels, cfg.lat, cfg.lon))
    return dxs.view(shape), upper, consts, cfg


@pytest.mark.parametrize("dims", [(16, 32, 32, 16), (20, 40, 40, 20)],
                         ids=["TINY", "C 20"])
def test_bf16_embed_dw_checks_shapes_before_a_launch(dims):
    """``embed_dw_operands``, which the weight-gradient wrapper runs before
    a launch, raises ValueError on a bf16 C that is not a multiple of 8 and
    takes TINY's; float32 takes both."""
    for dtype in (torch.bfloat16, torch.float32):
        dxs, upper, consts, cfg = _dw_case(dims, dtype)
        if dims[0] % 8 == 0 or dtype == torch.float32:
            assert all(t.dtype == dtype
                       for t in embed_dw_operands(dxs, upper, consts, cfg))
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                embed_dw_operands(dxs, upper, consts, cfg)


def test_bf16_embed_dw_operands_are_16_byte_aligned():
    """A bf16 cotangent that starts off a 16-byte boundary is handed to the
    kernel as an aligned copy of the same values, beside the aligned
    normalised field and const_h."""
    dxs, upper, consts, cfg = _dw_case((16, 32, 32, 16), torch.bfloat16,
                                       misaligned=True)
    assert dxs.data_ptr() % 16
    ops = embed_dw_operands(dxs, upper, consts, cfg)
    assert torch.equal(ops[0], dxs)
    assert all(t.data_ptr() % 16 == 0 for t in ops)


def _up_canon_case(dims, dtype, misaligned=False):
    """(params, input, out_h) of the canonical UpSample at TINY with the
    stage widths ``dims``, batch 1, an odd crop; with ``misaligned``, the
    input and the mix kernel start 2 bytes off a 16-byte boundary."""
    cfg = dataclasses.replace(TINY, dims=dims)
    g2 = cfg.stage(2)
    p = _updown_params(g2.dim, cfg.stage(3).dim, "up", dtype)
    shape = (1, g2.z, g2.h, g2.w, g2.dim)
    numel = torch.Size(shape).numel()
    x = torch.randn(numel + misaligned).to(dtype)[int(misaligned):]
    if misaligned:
        w = p["mix"]["kernel"]
        p["mix"]["kernel"] = torch.zeros(w.numel() + 1,
                                         dtype=w.dtype)[1:].view(w.shape)
    return p, x.view(shape), 2 * g2.h - 1


@pytest.mark.parametrize("dims", [(16, 32, 32, 16), (20, 40, 40, 20)],
                         ids=["TINY", "C 20"])
def test_bf16_canonical_up_sample_checks_shapes_before_a_launch(dims):
    """``up_sample_operands``, which the canonical UpSample runs before a
    launch, raises ValueError on bf16 channels that are not multiples of 8
    and takes TINY's; float32 takes both."""
    for dtype in (torch.bfloat16, torch.float32):
        p, x, out_h = _up_canon_case(dims, dtype)
        if dims[0] % 8 == 0 or dtype == torch.float32:
            _, q, c_out = up_sample_operands(p, x, out_h)
            assert c_out == dims[3] and q["mix"]["kernel"].dtype == dtype
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                up_sample_operands(p, x, out_h)


def test_bf16_canonical_up_sample_operands_are_16_byte_aligned():
    """A bf16 input or weight that starts off a 16-byte boundary is handed
    to the canonical UpSample as an aligned copy."""
    p, x, out_h = _up_canon_case((16, 32, 32, 16), torch.bfloat16,
                                 misaligned=True)
    assert x.data_ptr() % 16 and p["mix"]["kernel"].data_ptr() % 16
    got, q, _ = up_sample_operands(p, x, out_h)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    for sub in q.values():
        assert all(t.data_ptr() % 16 == 0 for t in sub.values())


def test_canonical_down_sample_bf16_route_runs_on_the_tensor_cores():
    """The bf16 canonical DownSample: one gather + LayerNorm pass, the
    kernel of updown_rows.cuh with the canonical row map -- the one the
    window-major DownSample launches with its rolled map -- then one
    mma_gemm.cuh product with a plain rounding store; no common.cuh gemm,
    ln_rows or element-a-lane gather.  float32 keeps the first version's
    kernels."""
    code = _code("updown.cu")
    body = _body(code, "static int down_sample_bf16(")
    assert len(re.findall(r"\bmma_gemm\s*<false>\s*\(", body)) == 1
    assert body.count("RoundEpi<bf16>") == 1
    assert "down_gather_ln_kernel<NJ, DownCanonMap>" in body
    assert not re.search(r"(?<![\w.])gemm\s*\(|\bln_rows\s*<|"
                         r"\bdown_canon_gather_kernel\b", body)
    f32 = _body(code, "int down_sample(")
    assert re.search(r"(?<![\w.])gemm\s*\(", f32)
    assert "ln_rows<T>(" in f32 and "down_canon_gather_kernel<T>" in f32
    entry = _body(code, 'extern "C" int pangu_down_sample(')
    assert entry.index("down_sample<float>(") < entry.index(
        "aligned16_all(") < entry.index("down_sample_bf16(")
    assert "down_sample<bf16>" not in code
    assert "down_gather_ln_kernel(" in _code("updown_rows.cuh")
    for source, rmap in (("updown.cu", "DownCanonMap"),
                         ("updown_wm.cu", "DownWmMap")):
        text = _code(source)
        assert f"down_gather_ln_kernel<NJ, {rmap}>" in text
        assert not re.search(r"\bdown_gather_ln_kernel\s*\(", text)


def test_window_attention_bf16_route_runs_on_the_tensor_cores():
    """The bf16 fused window attention: the qkv product on mma_gemm.cuh
    whose epilogue scales q in bf16, wattn_mma.cuh's attention with a float32
    table, no region ids and the logit scale 1 (q is scaled already), the
    proj product through fwd_gemm; no common.cuh gemm or CUDA-core
    attention.  float32 keeps the first version (gemm and window_attend's
    kScaleQ mode); the other callers of wa_attention keep hd^-1/2."""
    code = _code("window_attn.cu")
    body = code[code.rindex("int window_attn_bf16("):]   # the definition
    body = body[:body.index("\n}\n")]
    assert re.search(r"\bmma_gemm\s*<false>\s*\([^;]*QScaleEpi\{", body)
    m = re.search(r"\bwa_attention\s*<float>\s*\(([^;]*)\);", body)
    args = [a.strip() for a in m.group(1).split(",")]
    assert args[3] == "nullptr" and args[-1] == "1.f"
    assert re.search(r"\bfwd_gemm\s*\(", body)
    assert not re.search(r"(?<![\w.])gemm\s*\(|window_attend|"
                         r"fused_attn_kernel", body)
    epi = _body(code, "struct QScaleEpi {")
    assert "round_t<bf16>(o[e]) * scale_t" in epi and "if (c < C)" in epi
    f32 = _body(code, "int window_attn(")
    assert len(re.findall(r"(?<![\w.])gemm\s*\(", f32)) == 2
    assert "fused_attn_kernel<T>" in f32
    assert "window_attend<T, float, true>" in _body(
        code, "fused_attn_kernel(")
    entry = _body(code, 'extern "C" int pangu_window_attn(')
    assert entry.index("window_attn<float>(") < entry.index(
        "aligned16_all(") < entry.index("window_attn_bf16(")
    assert "window_attn<bf16>" not in code
    for source in ("grid_attn.cu", "block_wm.cu", "block_bwd.cu"):
        assert not re.search(r"\bwa_attention\s*<[^>]*>\s*\([^;]*1\.f\)",
                             _code(source))


@pytest.mark.parametrize("dims", [(16, 32, 32, 16), (20, 40, 40, 20)],
                         ids=["TINY", "C 20"])
def test_bf16_canonical_down_sample_checks_shapes_before_a_launch(dims):
    """``down_sample_operands``, which the canonical DownSample runs before
    a launch, raises ValueError on a bf16 C that is not a multiple of 8 and
    takes TINY's; float32 takes both."""
    for dtype in (torch.bfloat16, torch.float32):
        p, x = _down_canon_case(dims, dtype)
        if dims[0] % 8 == 0 or dtype == torch.float32:
            _, q = down_sample_operands(p, x)
            assert q["reduce"]["kernel"].dtype == dtype
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                down_sample_operands(p, x)


def _down_canon_case(dims, dtype, misaligned=False):
    """(params, input) of the canonical DownSample at TINY with the stage
    widths ``dims``, batch 1, an odd latitude count; with ``misaligned``,
    the input and the reduce kernel start 2 bytes off a 16-byte
    boundary."""
    cfg = dataclasses.replace(TINY, dims=dims)
    g0 = cfg.stage(0)
    p = _updown_params(g0.dim, cfg.stage(1).dim, "down", dtype)
    shape = (1, g0.z, g0.h - 1 + g0.h % 2, g0.w, g0.dim)
    numel = torch.Size(shape).numel()
    x = torch.randn(numel + misaligned).to(dtype)[int(misaligned):]
    if misaligned:
        w = p["reduce"]["kernel"]
        p["reduce"]["kernel"] = torch.zeros(w.numel() + 1,
                                            dtype=w.dtype)[1:].view(w.shape)
    return p, x.view(shape)


def test_bf16_canonical_down_sample_operands_are_16_byte_aligned():
    """A bf16 input or weight that starts off a 16-byte boundary is handed
    to the canonical DownSample as an aligned copy."""
    p, x = _down_canon_case((16, 32, 32, 16), torch.bfloat16,
                            misaligned=True)
    assert x.shape[2] % 2 == 1
    assert x.data_ptr() % 16 and p["reduce"]["kernel"].data_ptr() % 16
    got, q = down_sample_operands(p, x)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    for sub in q.values():
        assert all(t.data_ptr() % 16 == 0 for t in sub.values())


def _window_case(c, n, dtype, misaligned=False):
    """(x, [wqkv, bqkv, wp, bp], bias) of the fused window attention: 2
    longitude windows of 3 types, n tokens, C c, 2 heads; with
    ``misaligned``, x and wqkv start 2 bytes off a 16-byte boundary."""
    shape = (1, 2, 3, n, c)
    numel = torch.Size(shape).numel()
    x = torch.randn(numel + misaligned).to(dtype)[int(misaligned):]
    weights = [torch.zeros(s, dtype=dtype) for s in ((c, 3 * c), (3 * c,),
                                                     (c, c), (c,))]
    if misaligned:
        weights[0] = torch.zeros(3 * c * c + 1, dtype=dtype)[1:].view(c,
                                                                    3 * c)
    return x.view(shape), weights, torch.zeros((3, 2, n, n))


@pytest.mark.parametrize("c,n", [(16, 144), (20, 144), (16, 145), (24, 37)],
                         ids=["TINY", "C 20", "N 145", "N 37"])
def test_bf16_window_attention_checks_shapes_before_a_launch(c, n):
    """``window_operands``, which the fused window attention runs before a
    launch, raises ValueError on a bf16 C that is not a multiple of 8 or a
    window of more than 144 tokens and takes the rest (any head dim: C 24
    has head dim 12); float32 takes every one of them."""
    for dtype in (torch.bfloat16, torch.float32):
        x, weights, bias = _window_case(c, n, dtype)
        if (c % 8 == 0 and n <= 144) or dtype == torch.float32:
            _, got, heads = window_operands(x, weights, bias)
            assert heads == 2 and all(t.dtype == dtype for t in got)
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                window_operands(x, weights, bias)


def test_bf16_window_operands_are_16_byte_aligned():
    """A bf16 input or weight that starts off a 16-byte boundary is handed
    to the fused window attention as an aligned copy."""
    x, weights, bias = _window_case(16, 144, torch.bfloat16, misaligned=True)
    assert x.data_ptr() % 16 and weights[0].data_ptr() % 16
    got, got_w, _ = window_operands(x, weights, bias)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
    assert all(t.data_ptr() % 16 == 0 for t in got_w)
    assert torch.equal(got_w[0], weights[0])

"""Window-major DownSample / UpSample kernels: the counterpart of
``pangu_tpu/ops/updown_wm.py`` (``down_sample_wm``, ``up_sample_wm``).

Both consume the previous stage's ROLLED window-major storage (storage
position p holds canonical token p + off) and emit the next stage's
window-major entry storage in canonical coordinates, latitude-pad rows zeroed:

  * DownSample: 2x2 space-to-depth on (lat, lon), merge order
    (h_off, w_off, C), LayerNorm(4C), Linear(4C -> 2C, no bias);
  * UpSample: Linear(2C -> 4C', no bias), 2x2 depth-to-space, crop to the odd
    latitude count, LayerNorm(C'), Linear(C' -> C', no bias).

The JAX kernels' roll-back (``_lon_unroll`` and the chunk index maps) is
index arithmetic in the CUDA gathers (``csrc/updown_wm.cu``); the plain
versions here canonicalise with ``wm_to_canonical`` and run the canonical
pair's plain versions (``ops/updown``).  The JAX UpSample kernel leaves junk in its latitude-pad rows;
both versions here write zeros there.

bf16 runs on the tensor cores (a fused gather + LayerNorm row pass, then
``csrc/mma_gemm.cuh`` products), so it takes channel counts that are
multiples of 8, LayerNorm rows of at most ``ops.updown.LN_ROW_MAX`` values
and 16-byte aligned operands: ``down_operands`` / ``up_operands`` check
the input before a launch and raise ValueError on the rest (aligned copies
of a misaligned input or weight); float32 runs the first CUDA-core kernels
and takes any width.

Training: ``down_sample_wm_train`` / ``up_sample_wm_train`` run the kernel
forward and, backward, PyTorch autograd through a recompute of the plain
version, as the JAX package's ``*_train`` take an XLA ``jax.vjp`` of their
reference outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import StageGeometry
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset,
                                                aligned16, check_shard_read,
                                                params_in, require_device,
                                                to_window_major, wm_extent,
                                                wm_to_canonical)
from pangu_tpu_torch.ops.updown import (aligned_tree, check_updown_shape,
                                        down_sample_plain, recompute_train,
                                        up_sample_plain)


def _pad_lat(x, hp: int):
    """Zero-pad the latitude axis of (B, Z, H, W, C) to hp rows."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, hp - x.shape[2]))


def _operands(p, xs, channels, ln_width: int, what: str):
    """xs (16-byte aligned in bf16) and the params in its dtype, on its
    device; in bf16 the shapes checked (``check_updown_shape``) and every
    leaf 16-byte aligned."""
    q = params_in(p, xs.dtype)
    require_device(q, xs.device, what)
    if xs.dtype == torch.bfloat16:
        check_updown_shape(channels, ln_width, what)
        xs, q = aligned16(xs), aligned_tree(q)
    return xs, q


# ---------------------------------------------------------------------------
# DownSample (stage-0 wm rolled -> stage-1 wm canonical)
# ---------------------------------------------------------------------------

def down_sample_wm_plain(p, xs, geom0: StageGeometry, geom1: StageGeometry,
                         off: Offset):
    """Plain PyTorch version of the DownSample kernel (any device): the
    canonical DownSample between the relayouts."""
    y = down_sample_plain(p, wm_to_canonical(xs, off, geom0))
    return to_window_major(_pad_lat(y, geom1.h_padded), geom1.window)


def down_operands(p, xs, geom0: StageGeometry, geom1: StageGeometry):
    """What the DownSample kernel takes, checked before a launch: ``(xs,
    q, out_shape)``, q the params in xs's dtype.  Raises ValueError on an
    unsupported input or, in bf16, on a C that is not a multiple of 8."""
    b, nz, nlat0, nlon0, n, c = xs.shape
    wh = geom0.window[1]
    if (xs.dtype not in DTYPE_CODE or not xs.is_contiguous()
            or c != geom0.dim or nlat0 * wh != geom0.h_padded):
        raise ValueError(f"down_sample_wm: unsupported input {tuple(xs.shape)} "
                         f"{xs.dtype}")
    xs, q = _operands(p, xs, (c, 2 * c), 4 * c, "down_sample_wm")
    return xs, q, (b, nz, geom1.h_padded // wh, nlon0 // 2, n, 2 * c)


def down_sample_wm(p, xs, geom0: StageGeometry, geom1: StageGeometry,
                   off: Offset):
    """xs: (B, nz, nlat0, nlon0, N, C) rolled wm storage with offset ``off``.
    Returns (B, nz, nlat1, nlon1, N, 2C) wm entry storage of the next stage
    in canonical coordinates: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  On a shard (a z share, a lon share of the
    windows) it stays shard-local where ``off`` has no z or lon component;
    it raises otherwise."""
    check_shard_read(wm_extent(xs, geom0.window), geom0, off,
                     "down_sample_wm")
    if not xs.is_cuda:
        return down_sample_wm_plain(p, xs, geom0, geom1, off)
    xs, q, shape = down_operands(p, xs, geom0, geom1)
    b, nz, nlat0, nlon0, n, c = xs.shape
    wz, wh, ww = geom0.window
    nlat1, nlon1 = shape[2], shape[3]
    out = torch.empty(shape, dtype=xs.dtype, device=xs.device)
    ws = torch.empty(out.numel() * 2, dtype=xs.dtype, device=xs.device)  # 4C rows
    tensors = (xs, out, ws, q["norm"]["scale"], q["norm"]["bias"],
               q["reduce"]["kernel"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_down_sample_wm(
            DTYPE_CODE[xs.dtype], *(t.data_ptr() for t in tensors),
            b, nz, nlat0, nlon0, nlat1, nlon1, n, c, wz, wh, ww, *off,
            geom0.h, geom1.h, stream)
    _build.check(code, "down_sample_wm")
    down_sample_wm.launches += 1
    return out


down_sample_wm.launches = 0


# ---------------------------------------------------------------------------
# UpSample (stage-2 wm rolled -> stage-3 wm canonical)
# ---------------------------------------------------------------------------

def up_sample_wm_plain(p, xs, geom2: StageGeometry, geom3: StageGeometry,
                       off: Offset):
    """Plain PyTorch version of the UpSample kernel (any device): the
    canonical UpSample between the relayouts."""
    y = up_sample_plain(p, wm_to_canonical(xs, off, geom2), geom3.h)
    return to_window_major(_pad_lat(y, geom3.h_padded), geom3.window)


def up_operands(p, xs, geom2: StageGeometry, geom3: StageGeometry):
    """What the UpSample kernel takes, checked before a launch: ``(xs, q,
    out_shape)``, as :func:`down_operands`; in bf16 C2 and C3 multiples of
    8."""
    b, nz, nlat2, nlon2, n, c_in = xs.shape
    wh = geom2.window[1]
    c_out = p["expand"]["kernel"].shape[-1] // 4
    if (xs.dtype not in DTYPE_CODE or not xs.is_contiguous()
            or c_in != geom2.dim or nlat2 * wh != geom2.h_padded):
        raise ValueError(f"up_sample_wm: unsupported input {tuple(xs.shape)} "
                         f"{xs.dtype}")
    xs, q = _operands(p, xs, (c_in, c_out), c_out, "up_sample_wm")
    return xs, q, (b, nz, geom3.h_padded // wh, nlon2 * 2, n, c_out)


def up_sample_wm(p, xs, geom2: StageGeometry, geom3: StageGeometry,
                 off: Offset):
    """xs: (B, nz, nlat2, nlon2, N, C2) rolled wm storage with offset
    ``off``.  Returns (B, nz, nlat3, nlon3, N, C3) wm entry storage of stage
    3 in canonical coordinates: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor; on a shard as :func:`down_sample_wm`."""
    check_shard_read(wm_extent(xs, geom2.window), geom2, off, "up_sample_wm")
    if not xs.is_cuda:
        return up_sample_wm_plain(p, xs, geom2, geom3, off)
    xs, q, shape = up_operands(p, xs, geom2, geom3)
    b, nz, nlat2, nlon2, n, c_in = xs.shape
    wz, wh, ww = geom2.window
    nlat3, nlon3, c_out = shape[2], shape[3], shape[5]
    out = torch.empty(shape, dtype=xs.dtype, device=xs.device)
    # workspace: e (rows2 x 4C') | y (rows3 x C')
    ws = torch.empty(xs.numel() // c_in * 4 * c_out + out.numel(),
                     dtype=xs.dtype, device=xs.device)
    tensors = (xs, out, ws, q["expand"]["kernel"], q["norm"]["scale"],
               q["norm"]["bias"], q["mix"]["kernel"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_up_sample_wm(
            DTYPE_CODE[xs.dtype], *(t.data_ptr() for t in tensors),
            b, nz, nlat2, nlon2, nlat3, nlon3, n, c_in, c_out, wz, wh, ww,
            *off, geom2.h, geom3.h, stream)
    _build.check(code, "up_sample_wm")
    up_sample_wm.launches += 1
    return out


up_sample_wm.launches = 0


# ---------------------------------------------------------------------------
# Training: kernel forward, autograd through the plain recompute backward
# ---------------------------------------------------------------------------

def down_sample_wm_train(p, xs, geom0: StageGeometry, geom1: StageGeometry,
                         off: Offset, *, kernels: bool = True):
    """Differentiable :func:`down_sample_wm` (in ``xs`` and ``p``): the
    kernel forward (``kernels=False``: the plain version), the backward
    through the plain recompute."""
    return recompute_train(down_sample_wm, down_sample_wm_plain, p, xs,
                           (geom0, geom1, tuple(off)), kernels)


def up_sample_wm_train(p, xs, geom2: StageGeometry, geom3: StageGeometry,
                       off: Offset, *, kernels: bool = True):
    """Differentiable :func:`up_sample_wm`, as :func:`down_sample_wm_train`."""
    return recompute_train(up_sample_wm, up_sample_wm_plain, p, xs,
                           (geom2, geom3, tuple(off)), kernels)

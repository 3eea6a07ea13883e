"""Canonical-layout DownSample / UpSample kernels: the counterpart of
``pangu_tpu/ops/updown.py`` (``down_sample_fused`` / ``_down_pallas`` and
``up_sample_fused`` / ``_up_pallas``), which the canonical-layout forward
(``models/pangu.py::forward_core``: the ``taps`` path and the
``block_layout="v2"`` trunk) runs between stages.

  * ``down_sample``: (B, Z, H, W, C) -> (B, Z, ceil(H/2), W/2, 2C): a zero
    latitude row where H is odd, 2x2 space-to-depth with merge order
    (h_off, w_off, C), LayerNorm(4C), Linear(4C -> 2C, no bias);
  * ``up_sample``: (B, Z, H, W, 2C) -> (B, Z, out_h, 2W, C'):
    Linear(2C -> 4C', no bias), 2x2 depth-to-space in (h_off, w_off) order,
    crop to ``out_h`` latitude rows, LayerNorm(C'), Linear(C' -> C', no bias).

Each wrapper launches its CUDA kernel (``csrc/updown.cu``) on a CUDA tensor
and counts the launch in ``launches``, and runs its plain version on a CPU
tensor.  In bf16 both run on the tensor cores, with the window-major
pair's plans: DownSample one fused gather + LayerNorm pass and one
``csrc/mma_gemm.cuh`` product, UpSample two products around a fused
gather + LayerNorm pass.  So they take channel counts that are multiples
of 8 and LayerNorm rows of at most ``LN_ROW_MAX`` values:
``down_sample_operands`` and ``up_sample_operands`` check the input before
a launch.
``down_sample_train`` / ``up_sample_train`` (the ``block_layout="v2"``
training trunk) run the kernel forward and, backward, autograd
through a recompute of the plain version (``recompute_train``, which the
window-major pair in ``ops/updown_wm`` shares), as the JAX package's
``_down_core`` / ``_up_core`` take an XLA ``jax.vjp`` of their reference.

Both read only their own longitude columns (DownSample a pair, UpSample
one), so on a rank's longitude shard of the canonical-layout route they
run as they do on the whole grid; ``down_sample`` raises where the shard
holds an odd number of columns (a pair would straddle two shards).
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.models.layers import dense, layer_norm
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, aligned16,
                                                check_tensor_core_shape,
                                                params_in, require_device)


# the bf16 row passes hold a LayerNorm row in registers: at most 8 chunks of
# 8 values a lane (csrc/updown_rows.cuh, LN_MAX_NJ)
LN_ROW_MAX = 32 * 8 * 8


def check_updown_shape(channels, ln_width: int, what: str) -> None:
    """Raise ValueError on what the bf16 routes of ``csrc/updown_wm.cu``
    and ``csrc/updown.cu`` do not take: a channel count (input, output,
    LayerNorm) that is not a multiple of 8, or a LayerNorm row wider than
    ``LN_ROW_MAX``."""
    check_tensor_core_shape(channels, None, what)
    if ln_width > LN_ROW_MAX:
        raise ValueError(f"{what}: the bf16 row pass takes LayerNorm rows of "
                         f"at most {LN_ROW_MAX} values, got {ln_width}")


def aligned_tree(tree):
    """A param tree with every leaf 16-byte aligned (copies where not)."""
    return {k: aligned_tree(v) if isinstance(v, dict) else aligned16(v)
            for k, v in tree.items()}


def down_sample_plain(p, x):
    """Plain PyTorch version of the DownSample kernel (any device)."""
    p = params_in(p, x.dtype)
    B, Z, H, W, C = x.shape
    h2, w2 = -(-H // 2), W // 2
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 2 * h2 - H))
    x = x.reshape(B, Z, h2, 2, w2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(B, Z, h2, w2, 4 * C)
    return dense(p["reduce"], layer_norm(p["norm"], x))


def down_sample_operands(p, x):
    """What the DownSample kernel takes, checked before a launch: ``(x,
    q)``, q the params in x's dtype.  Raises ValueError on an unsupported
    input or, in bf16 (the tensor-core route), on a channel count that is
    not a multiple of 8 or a LayerNorm row the row pass cannot hold; the
    bf16 input and params are 16-byte aligned (copies where they are
    not)."""
    B, Z, H, W, C = x.shape
    check_lon_pairs(W)
    if x.dtype not in DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"down_sample: unsupported input {tuple(x.shape)} "
                         f"{x.dtype}")
    q = params_in(p, x.dtype)
    require_device(q, x.device, "down_sample")
    if q["reduce"]["kernel"].shape != (4 * C, 2 * C):
        raise ValueError(f"down_sample: reduce kernel "
                         f"{tuple(q['reduce']['kernel'].shape)} for C={C}")
    if x.dtype == torch.bfloat16:
        check_updown_shape((C,), 4 * C, "down_sample")
        x, q = aligned16(x), aligned_tree(q)
    return x, q


def check_lon_pairs(w: int) -> None:
    """Raise where DownSample's longitude pairs would not lie within the
    ``w`` columns of its input (a shard of odd width)."""
    if w % 2:
        raise ValueError(f"down_sample: {w} longitude columns: a pair would "
                         "straddle two shards (it reads across shards)")


def down_sample(p, x):
    """x: the canonical (B, Z, H, W, C) grid, W even (the whole grid, or a
    longitude shard of it).  The CUDA kernel for a CUDA tensor (in bf16
    the tensor-core route, whose operands ``down_sample_operands`` checks
    and aligns), the plain version for a CPU tensor."""
    check_lon_pairs(x.shape[3])
    if not x.is_cuda:
        return down_sample_plain(p, x)
    x, q = down_sample_operands(p, x)
    B, Z, H, W, C = x.shape
    out = torch.empty((B, Z, -(-H // 2), W // 2, 2 * C), dtype=x.dtype,
                      device=x.device)
    ws = torch.empty(out.numel() * 2, dtype=x.dtype, device=x.device)  # 4C rows
    tensors = (x, out, ws, q["norm"]["scale"], q["norm"]["bias"],
               q["reduce"]["kernel"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_down_sample(
            DTYPE_CODE[x.dtype], *(t.data_ptr() for t in tensors),
            B * Z, H, W, C, stream)
    _build.check(code, "down_sample")
    down_sample.launches += 1
    return out


down_sample.launches = 0


def up_sample_plain(p, x, out_h: int):
    """Plain PyTorch version of the UpSample kernel (any device)."""
    p = params_in(p, x.dtype)
    B, Z, H, W, _ = x.shape
    e = dense(p["expand"], x)
    c_out = e.shape[-1] // 4
    e = e.reshape(B, Z, H, W, 2, 2, c_out).permute(0, 1, 2, 4, 3, 5, 6)
    y = e.reshape(B, Z, 2 * H, 2 * W, c_out)[:, :, :out_h]
    return dense(p["mix"], layer_norm(p["norm"], y))


def up_sample_operands(p, x, out_h: int):
    """What the UpSample kernel takes, checked before a launch: ``(x, q,
    c_out)``, q the params in x's dtype.  Raises ValueError on an
    unsupported input or, in bf16 (the tensor-core route), on channel
    counts that are not multiples of 8 or a LayerNorm row the row pass
    cannot hold; the bf16 input and params are 16-byte aligned (copies
    where they are not)."""
    B, Z, H, W, c_in = x.shape
    if (x.dtype not in DTYPE_CODE or not x.is_contiguous()
            or not 0 < out_h <= 2 * H):
        raise ValueError(f"up_sample: unsupported input {tuple(x.shape)} "
                         f"{x.dtype}, out_h {out_h}")
    q = params_in(p, x.dtype)
    require_device(q, x.device, "up_sample")
    c_out = q["expand"]["kernel"].shape[-1] // 4
    if (q["expand"]["kernel"].shape != (c_in, 4 * c_out)
            or q["mix"]["kernel"].shape != (c_out, c_out)):
        raise ValueError(f"up_sample: kernels for C={c_in} -> {c_out}")
    if x.dtype == torch.bfloat16:
        check_updown_shape((c_in, c_out), c_out, "up_sample")
        x, q = aligned16(x), aligned_tree(q)
    return x, q, c_out


def up_sample(p, x, out_h: int):
    """x: the canonical (B, Z, H, W, 2C) grid; ``out_h`` <= 2H latitude rows
    are kept.  The CUDA kernel for a CUDA tensor (in bf16 the tensor-core
    route, whose operands ``up_sample_operands`` checks and aligns), the
    plain version for a CPU tensor."""
    if not x.is_cuda:
        return up_sample_plain(p, x, out_h)
    x, q, c_out = up_sample_operands(p, x, out_h)
    B, Z, H, W, c_in = x.shape
    out = torch.empty((B, Z, out_h, 2 * W, c_out), dtype=x.dtype,
                      device=x.device)
    # workspace: e (rows x 4C') | y (out rows x C')
    ws = torch.empty(x.numel() // c_in * 4 * c_out + out.numel(),
                     dtype=x.dtype, device=x.device)
    tensors = (x, out, ws, q["expand"]["kernel"], q["norm"]["scale"],
               q["norm"]["bias"], q["mix"]["kernel"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_up_sample(
            DTYPE_CODE[x.dtype], *(t.data_ptr() for t in tensors),
            B * Z, H, W, c_in, c_out, out_h, stream)
    _build.check(code, "up_sample")
    up_sample.launches += 1
    return out


up_sample.launches = 0


# ---------------------------------------------------------------------------
# Training: kernel forward, autograd through the plain recompute backward
# ---------------------------------------------------------------------------

class _RecomputeTrain(torch.autograd.Function):
    """``fwd`` forward; backward: autograd of ``plain`` recomputed from the
    saved input and parameters."""

    @staticmethod
    def forward(ctx, meta, xs, *leaves):
        fwd, plain, rebuild, args = meta
        ctx.meta = meta
        ctx.save_for_backward(xs, *leaves)
        return fwd(rebuild(leaves), xs, *args)

    @staticmethod
    def backward(ctx, g):
        _, plain, rebuild, args = ctx.meta
        xs, *leaves = ctx.saved_tensors
        with torch.enable_grad():
            xs = xs.detach().requires_grad_(True)
            leaves = [t.detach().requires_grad_(True) for t in leaves]
            y = plain(rebuild(leaves), xs, *args)
            grads = torch.autograd.grad(y, [xs, *leaves], g)
        return (None, *grads)


def recompute_train(fwd, plain, p, xs, args, kernels: bool):
    """``fwd(p, xs, *args)`` forward (``kernels=False``: ``plain``), the
    backward through autograd of ``plain`` recomputed from ``xs`` and the
    leaves of the two-level param dict ``p``."""
    keys = [(k, j) for k in sorted(p) for j in sorted(p[k])]

    def rebuild(leaves):
        out = {}
        for (k, j), t in zip(keys, leaves):
            out.setdefault(k, {})[j] = t
        return out

    meta = (fwd if kernels else plain, plain, rebuild, args)
    return _RecomputeTrain.apply(meta, xs, *(p[k][j] for k, j in keys))


def down_sample_train(p, x, *, kernels: bool = True):
    """Differentiable :func:`down_sample` (in ``x`` and ``p``): the kernel
    forward (``kernels=False``: the plain version), the backward through the
    plain recompute, as the JAX package's ``_down_core``."""
    return recompute_train(down_sample, down_sample_plain, p, x, (), kernels)


def up_sample_train(p, x, out_h: int, *, kernels: bool = True):
    """Differentiable :func:`up_sample`, as :func:`down_sample_train` (the
    JAX package's ``_up_core``)."""
    return recompute_train(up_sample, up_sample_plain, p, x, (out_h,),
                           kernels)

"""Windowed attention on the token grid: the counterpart of
``pangu_tpu/ops/window_attention.py`` (``_sdpa_pallas``, ``_sdpa_pallas_bwd``
and ``_sdpa``; ``_grid_attention_pallas``, ``_grid_attention_bwd_pallas`` and
``_grid_core`` with either backward; ``_block_fused_pallas`` with
``block_noroll_fused``; ``window_attention_grid``).

The input is a (B, Z, Hp, W, C) token grid already in a block's window
coordinates, latitude-pad rows already zeroed: window (zz, hh, l) is rows
(wz*zz.., wh*hh.., ww*l..) as they stand, its bias slice is table[zz * nlat
+ hh], and with region ids (a shifted block) tokens of different regions
attend with an extra -100.  The output is the attention branch, qkv and
output projections included, on the same grid.

  * ``grid_attention``: the forward (CUDA ``csrc/grid_attn.cu``);
  * ``grid_attention_bwd``: recompute and every gradient: ``dx`` in x's
    dtype, float32 ``dWqkv``, ``dbqkv``, ``dWp``, ``dbp`` and the table's
    ``dbias``, each summed over every window of the batch;
  * ``GridAttention``: the ``torch.autograd.Function`` of the two, which the
    rolled-coordinate training block (``ops/earth_block_fused``) recomputes
    through; its gradients come back in the dtypes of its inputs.  Its
    backward is ``bwd_impl="pallas"`` (``grid_attention_bwd``) or ``"xla"``:
    autograd of the reference composition (partition, qkv product, ``Sdpa``,
    proj product, reverse) recomputed from the saved inputs, as
    ``_grid_core``'s ``jax.vjp`` of its ``ref``;
  * ``sdpa`` / ``sdpa_bwd``: softmax(q scale k^T + bias) v per window and
    head on the transposed (hd, N) qkv layout, and its backward (CUDA
    ``csrc/sdpa.cu``); ``Sdpa`` their autograd Function;
  * ``block_noroll_fused``: the whole unshifted block on the lat-padded grid,
    pad rows as data (the block kernel, ``csrc/block_wm.cu``);
  * ``window_attention_grid``: the per-block path's attention, None where
    the qkv or proj site carries LoRA leaves;
  * ``window_attention_pallas``: the fused attention on partitioned
    (B, nlon, ntype, N, C) windows, the public drop-in for
    ``models/layers.py::earth_attention`` (the JAX package's
    ``window_attention_pallas``): region ids folded into a float32 bias
    outside the kernel, the kernel (CUDA ``csrc/window_attn.cu``; bf16 on
    the tensor cores, checked by ``window_operands``) forward
    and, through ``WindowAttention``, autograd of the reference composition
    (qkv product, ``Sdpa``, proj product) backward, as ``_fused_core``;
    ``earth_attention`` itself where qkv or proj carries LoRA leaves.

Each wrapper launches its kernel for a CUDA tensor (counting the launch in
``launches``) and runs its plain version for a CPU tensor.  The plain
versions round where the Pallas bodies do: qkv once after the bias,
probabilities before P.V, the attention output, and in the backward P in
float32 for dS but rounded for dV, dS summed unrounded into dbias and
rounded before dQ / dK, da, dqkv and dx rounded.  ``sdpa`` scales q in the
input dtype (q times the scale rounded to it, the product rounded), and its
backward takes dK from the unscaled q; the ``"xla"`` composition rounds each
product before adding its bias in the dtype, as XLA's dot.  The fused
window attention rounds as ``_make_fused_kernel``: q, k, v after their bias,
q times the scale in the dtype, float32 logits plus the bias, P rounded, o
rounded, the proj product summed in float32 with its bias and rounded once;
its backward's composition rounds as the ``"xla"`` one, so in bf16 the two
directions round differently, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import StageGeometry
from pangu_tpu_torch.models.layers import (_dot, dense, earth_attention,
                                          window_partition, window_reverse)
from pangu_tpu_torch.ops.block_tail import tail_math
from pangu_tpu_torch.ops.earth_block_bwd import _colsum, _wgrad
from pangu_tpu_torch.models.lora import has_lora
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, aligned16,
                                                block_operands,
                                                check_tensor_core_shape,
                                                params_in)

Window = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _heads(t, heads: int):
    """(..., N, C) -> (..., heads, N, hd)."""
    *lead, n, c = t.shape
    return t.reshape(*lead, n, heads, c // heads).transpose(-3, -2)


def _merge(t):
    """(..., heads, N, hd) -> (..., N, C)."""
    t = t.transpose(-3, -2)
    return t.reshape(*t.shape[:-2], -1)


def _full_bias(table, ids: Optional[torch.Tensor]):
    """The (ntype, heads, N, N) float32 bias: the table plus -100 between
    tokens of different regions."""
    b32 = table.float()
    if ids is not None:
        ids = ids.to(table.device)
        mask = torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        b32 = b32 + mask[:, None]
    return b32


def _recompute(x, wqkv, bqkv, table, window: Window, ids):
    """Partition, qkv and the float32 softmax: ``(xw, q, k, v, p32)``, q, k,
    v (B, nlon, ntype, heads, N, hd) in x's dtype."""
    dt = x.dtype
    c, heads = x.shape[-1], table.shape[1]
    xw = window_partition(x, window)
    qkv = dense({"kernel": wqkv.to(dt), "bias": bqkv.to(dt)}, xw)
    q, k, v = (_heads(qkv[..., i * c:(i + 1) * c], heads) for i in range(3))
    s = (q.float() @ k.float().transpose(-1, -2)) * (c // heads) ** -0.5
    s = s + _full_bias(table, ids)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return xw, q, k, v, e / e.sum(-1, keepdim=True)


def grid_attention_plain(x, wqkv, bqkv, wp, bp, table, window: Window,
                         ids: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the grid attention forward (any device)."""
    dt = x.dtype
    _, z, hp, w, _ = x.shape
    _, _, _, v, p32 = _recompute(x, wqkv, bqkv, table, window, ids)
    o = _merge((p32.to(dt).float() @ v.float()).to(dt))
    y = dense({"kernel": wp.to(dt), "bias": bp.to(dt)}, o)
    return window_reverse(y, window, z, hp, w)


def grid_attention_bwd_plain(x, g, wqkv, bqkv, wp, table, window: Window,
                             ids: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the grid attention backward (any device):
    ``(dx, dWqkv, dbqkv, dWp, dbp, dbias)``, dx in x's dtype, the rest
    float32."""
    dt = x.dtype
    _, z, hp, w, c = x.shape
    heads = table.shape[1]
    scale = (c // heads) ** -0.5
    xw, q, k, v, p32 = _recompute(x, wqkv, bqkv, table, window, ids)
    pr = p32.to(dt).float()
    af = _merge((pr @ v.float()).to(dt))
    gw = window_partition(g.to(dt), window)
    dwp, dbp = _wgrad(af, gw), _colsum(gw)
    da = (gw.float() @ wp.to(dt).float().T).to(dt)
    do = _heads(da, heads).float()
    dv = (pr.transpose(-1, -2) @ do).to(dt)
    dp = do @ v.float().transpose(-1, -2)
    ds32 = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    del dp, p32, pr
    dbias = ds32.sum(dim=(0, 1))                   # (ntype, heads, N, N)
    ds = ds32.to(dt).float()
    del ds32
    dq = ((ds @ k.float()) * scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ q.float()) * scale).to(dt)
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
    dwqkv, dbqkv = _wgrad(xw, dqkv), _colsum(dqkv)
    dx = (dqkv.float() @ wqkv.to(dt).float().T).to(dt)
    return window_reverse(dx, window, z, hp, w), dwqkv, dbqkv, dwp, dbp, dbias


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _checked(x, weights, table, window: Window, ids, what: str):
    """Raise on what the kernels do not take (in bf16, the tensor-core
    shapes); return x (16-byte aligned in bf16), the weights in x's dtype,
    the ids as int32 on x's device, and the window grid ``(b, nz, nlat,
    nlon, n, c, heads)``."""
    b, z, hp, w, c = x.shape
    wz, wh, ww = window
    nz, nlat, nlon, n = z // wz, hp // wh, w // ww, wz * wh * ww
    heads = table.shape[1]
    shapes = [(c, 3 * c), (3 * c,), (c, c), (c,)][:len(weights)]
    if (x.dtype not in DTYPE_CODE or not x.is_contiguous()
            or (nz * wz, nlat * wh, nlon * ww) != (z, hp, w) or c % heads
            or [tuple(t.shape) for t in weights] != shapes):
        raise ValueError(f"{what}: unsupported input {tuple(x.shape)} "
                         f"{x.dtype}, weights "
                         f"{[tuple(t.shape) for t in weights]}, "
                         f"window {window}")
    if (table.dtype not in DTYPE_CODE
            or table.shape != (nz * nlat, heads, n, n)):
        raise ValueError(f"{what}: bias table {tuple(table.shape)} "
                         f"{table.dtype}")
    weights = [t.to(x.dtype).contiguous() for t in weights]
    if x.dtype == torch.bfloat16:   # the tensor-core tiles, 16-byte rows
        check_tensor_core_shape((c,), n, what)
        x = aligned16(x)
        weights = [aligned16(t) for t in weights]
    for t in weights + [table]:
        if t.device != x.device:
            raise ValueError(f"{what}: parameter on {t.device}, input on "
                             f"{x.device}")
    if ids is not None:
        ids = ids.to(device=x.device, dtype=torch.int32).contiguous()
        if ids.shape != (nz * nlat, n):
            raise ValueError(f"{what}: region ids {tuple(ids.shape)}")
    return x, weights, ids, (b, nz, nlat, nlon, n, c, heads)


def _ptr(t):
    return None if t is None else t.data_ptr()


def grid_attention(x, wqkv, bqkv, wp, bp, table, window: Window,
                   ids: Optional[torch.Tensor] = None):
    """The grid attention forward: ``x`` (B, Z, Hp, W, C) in window
    coordinates, pad rows zeroed; ``wqkv`` (C, 3C), ``bqkv`` (3C), ``wp``
    (C, C), ``bp`` (C) (cast to x's dtype); ``table`` (ntype, heads, N, N)
    in its own dtype; ``ids`` (ntype, N) region ids or None.  The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return grid_attention_plain(x, wqkv, bqkv, wp, bp, table, window, ids)
    x, (wqkv, bqkv, wp, bp), ids, dims = _checked(
        x, [wqkv, bqkv, wp, bp], table, window, ids, "grid_attention")
    table = table.contiguous()
    lib = _build.library()
    c = x.shape[-1]
    ws = torch.empty(lib.pangu_grid_attn_ws(x.numel() // c, c, 0),
                     dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    tensors = (x, out, ws, wqkv, bqkv, wp, bp, table, ids)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_grid_attn(
            DTYPE_CODE[x.dtype], DTYPE_CODE[table.dtype],
            *(_ptr(t) for t in tensors), *dims, *window, stream)
    _build.check(code, "grid_attention")
    grid_attention.launches += 1
    return out


grid_attention.launches = 0


def grid_attention_bwd(x, g, wqkv, bqkv, wp, table, window: Window,
                       ids: Optional[torch.Tensor] = None):
    """Every gradient of :func:`grid_attention` given the cotangent ``g`` of
    its output (a grid like ``x``): ``(dx, dWqkv, dbqkv, dWp, dbp,
    dbias)``, dx in x's dtype, the rest float32.  The CUDA kernel unit for a
    CUDA tensor, the plain version for a CPU tensor."""
    if not x.is_cuda:
        return grid_attention_bwd_plain(x, g, wqkv, bqkv, wp, table, window,
                                        ids)
    x, (wqkv, bqkv, wp), ids, dims = _checked(
        x, [wqkv, bqkv, wp], table, window, ids, "grid_attention_bwd")
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"grid_attention_bwd: cotangent {tuple(g.shape)} on "
                         f"{g.device}, input {tuple(x.shape)} on {x.device}")
    g = g.to(x.dtype).contiguous()
    table = table.contiguous()
    lib = _build.library()
    dev, c = x.device, x.shape[-1]
    rows = x.numel() // c
    ws = torch.empty(lib.pangu_grid_attn_ws(rows, c, 1), dtype=x.dtype,
                     device=dev)
    part = torch.empty(lib.pangu_grid_attn_ws(rows, c, 2),
                       dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((c + 1, 3 * c), dtype=torch.float32, device=dev)
    dwp = torch.empty((c + 1, c), dtype=torch.float32, device=dev)
    dbias = torch.empty(table.shape, dtype=torch.float32, device=dev)
    tensors = (x, g, dx, ws, part, wqkv, bqkv, wp, table, ids, dwqkv, dwp,
               dbias)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_grid_attn_bwd(
            DTYPE_CODE[x.dtype], DTYPE_CODE[table.dtype],
            *(_ptr(t) for t in tensors), *dims, *window, stream)
    _build.check(code, "grid_attention_bwd")
    grid_attention_bwd.launches += 1
    # the last row of each weight gradient is its bias gradient
    return dx, dwqkv[:c], dwqkv[c], dwp[:c], dwp[c], dbias


grid_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _grid_ref(x, wqkv, bqkv, wp, bp, table, window: Window, ids,
              kernels: bool):
    """``_grid_core``'s reference composition on the grid ``x``: partition,
    qkv product, ``Sdpa`` on the folded float32 bias, proj product,
    reverse; each product rounded to x's dtype before its bias is added in
    it.  Differentiable in every input."""
    dt = x.dtype
    b, z, hp, w, c = x.shape
    heads = table.shape[1]
    win = window_partition(x, window)              # (B, nlon, ntype, N, C)
    nlon, ntype, n = win.shape[1:4]
    qkv = _dot(win, wqkv.to(dt)) + bqkv.to(dt)
    qkv = qkv.reshape(b * nlon, ntype, n, 3, heads, c // heads)
    qkv = qkv.permute(0, 1, 3, 4, 5, 2).contiguous()
    out = Sdpa.apply(kernels, qkv, _full_bias(table, ids))
    out = out.permute(0, 1, 4, 2, 3).reshape(b, nlon, ntype, n, c)
    y = _dot(out, wp.to(dt)) + bp.to(dt)
    return window_reverse(y, window, z, hp, w)


class GridAttention(torch.autograd.Function):
    """``GridAttention.apply(meta, x, wqkv, bqkv, wp, bp, table)``, meta =
    ``(window, ids, kernels[, bwd_impl])``: :func:`grid_attention` forward;
    backward :func:`grid_attention_bwd` (``bwd_impl="pallas"``, the
    default) or autograd of :func:`_grid_ref` recomputed from the saved
    inputs (``"xla"``: the ``sdpa`` kernel in the recompute, ``sdpa_bwd`` in
    its backward);
    ``kernels=False``: the plain versions on any device.  The gradients come
    back in the dtypes of the inputs, as ``_grid_core``'s backward casts
    them."""

    @staticmethod
    def forward(ctx, meta, x, wqkv, bqkv, wp, bp, table):
        window, ids, kernels = meta[:3]
        ctx.meta = (*meta[:3], meta[3] if len(meta) > 3 else "pallas")
        ctx.dtypes = [t.dtype for t in (x, wqkv, bqkv, wp, bp, table)]
        ctx.save_for_backward(x, wqkv, bqkv, wp, bp, table)
        fwd = grid_attention if kernels else grid_attention_plain
        return fwd(x, wqkv, bqkv, wp, bp, table, window, ids)

    @staticmethod
    def backward(ctx, g):
        window, ids, kernels, bwd_impl = ctx.meta
        x, wqkv, bqkv, wp, bp, table = ctx.saved_tensors
        if bwd_impl == "xla":
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(True)
                          for t in (x, wqkv, bqkv, wp, bp, table)]
                y = _grid_ref(*inputs, window, ids, kernels)
                grads = torch.autograd.grad(y, inputs, g)
        else:
            bwd = grid_attention_bwd if kernels else grid_attention_bwd_plain
            grads = bwd(x, g, wqkv, bqkv, wp, table, window, ids)
        return (None, *(d.to(dt) for d, dt in zip(grads, ctx.dtypes)))


def window_attention_grid(p, xg, geom: StageGeometry,
                          ids: Optional[torch.Tensor] = None, *,
                          bwd_impl: str = "pallas", kernels: bool = True):
    """The attention branch of one block on the padded (B, Z, Hp, W, C)
    grid ``xg`` in window coordinates (``p``: the block's ``attn`` params;
    ``ids``: region ids of a shifted block), differentiable through
    :class:`GridAttention` with the backward ``bwd_impl``; None where the
    qkv or proj site carries LoRA leaves (the caller runs the plain
    attention), as the JAX package's ``window_attention_grid``."""
    if "lora_a" in p["qkv"] or "lora_a" in p["proj"]:
        return None
    return GridAttention.apply(
        (geom.window, ids, kernels, bwd_impl), xg, p["qkv"]["kernel"],
        p["qkv"]["bias"], p["proj"]["kernel"], p["proj"]["bias"],
        p["bias_table"])


# ---------------------------------------------------------------------------
# The windowed sdpa on the transposed qkv layout
# ---------------------------------------------------------------------------

def _sdpa_probs(qkv, bias):
    """``(q_raw, qs, k, v, p32)``: q scaled in qkv's dtype (the scale
    rounded to it, the product rounded) and the float32 softmax of
    qs^T k + bias, (nwin, ntype, heads, N, N)."""
    dt = qkv.dtype
    hd = qkv.shape[-2]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qs = q * torch.tensor(hd ** -0.5, dtype=dt, device=qkv.device)
    s = qs.float().transpose(-1, -2) @ k.float() + bias.float()[None]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return q, qs, k, v, e / e.sum(-1, keepdim=True)


def sdpa_plain(qkv, bias):
    """Plain PyTorch version of :func:`sdpa` (any device)."""
    _, _, _, v, p32 = _sdpa_probs(qkv, bias)
    return (v.float() @ p32.to(qkv.dtype).float().transpose(-1, -2)).to(
        qkv.dtype)


def sdpa_bwd_plain(qkv, bias, g):
    """Plain PyTorch version of :func:`sdpa_bwd` (any device)."""
    dt = qkv.dtype
    scale = qkv.shape[-2] ** -0.5
    q, _, k, v, p32 = _sdpa_probs(qkv, bias)
    do = g.to(dt).float()
    dv = (do @ p32.to(dt).float()).to(dt)
    dp = do.transpose(-1, -2) @ v.float()
    ds32 = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    del dp, p32
    dbias = ds32.sum(0)
    ds = ds32.to(dt).float()
    del ds32
    dq = ((k.float() @ ds.transpose(-1, -2)) * scale).to(dt)
    dk = ((q.float() @ ds) * scale).to(dt)
    return torch.stack([dq, dk, dv], dim=2), dbias


def _sdpa_checked(qkv, bias, what: str):
    """The C entry's dims; raises ValueError on what the kernels do not
    take: besides layout, dtype and device, in bf16 (the tensor-core
    kernels) N above 256 or a head dim whose tiles do not fit the device's
    shared memory (above 144 at N = 144)."""
    nwin, ntype, three, heads, hd, n = qkv.shape
    if (three != 3 or qkv.dtype not in DTYPE_CODE or not qkv.is_contiguous()
            or bias.dtype != torch.float32 or not bias.is_contiguous()
            or bias.shape != (ntype, heads, n, n)
            or bias.device != qkv.device or nwin < 1):
        raise ValueError(f"{what}: unsupported qkv {tuple(qkv.shape)} "
                         f"{qkv.dtype}, bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if qkv.dtype == torch.bfloat16:
        with torch.cuda.device(qkv.device):
            smem = _build.library().pangu_sdpa_ws(int(what == "sdpa_bwd"),
                                                  hd, n, 0)
        if smem <= 0:
            raise ValueError(f"{what}: the bf16 kernel takes N up to 256 "
                             f"and head dims whose tiles fit the device's "
                             f"shared memory, got hd {hd}, N {n}")
    return nwin, ntype, heads, hd, n


def sdpa(qkv, bias):
    """softmax(q scale k^T + bias) v per window and head: ``qkv`` (nwin,
    ntype, 3, heads, hd, N) with q, k, v stored transposed (hd, N), in the
    model dtype; ``bias`` (ntype, heads, N, N) float32 with the mask folded
    in.  Returns (nwin, ntype, heads, hd, N) in qkv's dtype.  The CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not qkv.is_cuda:
        return sdpa_plain(qkv, bias)
    dims = _sdpa_checked(qkv, bias, "sdpa")
    out = torch.empty(qkv.shape[:2] + qkv.shape[3:], dtype=qkv.dtype,
                      device=qkv.device)
    with _build.launch_stream(qkv, bias, out) as stream:
        code = _build.library().pangu_sdpa(
            DTYPE_CODE[qkv.dtype], qkv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), *dims, stream)
    _build.check(code, "sdpa")
    sdpa.launches += 1
    return out


sdpa.launches = 0


def sdpa_bwd(qkv, bias, g):
    """The gradients of :func:`sdpa` given the cotangent ``g`` of its output:
    ``(dqkv, dbias)``, dqkv in qkv's layout and dtype, dbias float32 summed
    over the windows in a fixed order.  The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not qkv.is_cuda:
        return sdpa_bwd_plain(qkv, bias, g)
    dims = _sdpa_checked(qkv, bias, "sdpa_bwd")
    want = qkv.shape[:2] + qkv.shape[3:]
    if g.shape != want or g.device != qkv.device:
        raise ValueError(f"sdpa_bwd: cotangent {tuple(g.shape)} on "
                         f"{g.device}, want {tuple(want)} on {qkv.device}")
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=qkv.device)
    tensors = (qkv, bias, g, dqkv, dbias)
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_sdpa_bwd(
            DTYPE_CODE[qkv.dtype], *(t.data_ptr() for t in tensors), *dims,
            stream)
    _build.check(code, "sdpa_bwd")
    sdpa_bwd.launches += 1
    return dqkv, dbias


sdpa_bwd.launches = 0


class Sdpa(torch.autograd.Function):
    """``Sdpa.apply(kernels, qkv, bias)``: :func:`sdpa` forward,
    :func:`sdpa_bwd` backward (``kernels=False``: their plain versions on
    any device), the counterpart of the JAX package's ``_sdpa``."""

    @staticmethod
    def forward(ctx, kernels, qkv, bias):
        ctx.kernels = kernels
        ctx.save_for_backward(qkv, bias)
        return (sdpa if kernels else sdpa_plain)(qkv, bias)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        bwd = sdpa_bwd if ctx.kernels else sdpa_bwd_plain
        dqkv, dbias = bwd(qkv, bias, g)
        return None, dqkv, dbias


# ---------------------------------------------------------------------------
# The whole unshifted block on the padded grid
# ---------------------------------------------------------------------------

def block_noroll_plain(p, xg, geom: StageGeometry, gelu_tanh: bool):
    """Plain PyTorch version of :func:`block_noroll_fused` (any device): the
    grid attention and the tail, pad rows as data."""
    q = params_in(p, xg.dtype)
    at = q["attn"]
    a = grid_attention_plain(xg, at["qkv"]["kernel"], at["qkv"]["bias"],
                             at["proj"]["kernel"], at["proj"]["bias"],
                             at["bias_table"], geom.window)
    return tail_math(a, xg, q, gelu_tanh)


def block_noroll_fused(p, xg, geom: StageGeometry, gelu_tanh: bool):
    """The whole unshifted block (grid attention, then the tail) on the
    lat-padded (B, Z, Hp, W, C) grid ``xg``, its pad rows taken as data,
    as the JAX package's ``_block_fused_pallas``: the output is the same
    grid; its pad rows hold the block applied to the input's pad rows and
    the caller crops them.  None where any of the block's four dense sites
    carries LoRA leaves.  The CUDA block kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if has_lora(p):
        return None
    if not xg.is_cuda:
        return block_noroll_plain(p, xg, geom, gelu_tanh)
    xg, q, table, dims, ws = block_operands(p, xg, geom, 1, True,
                                            "block_noroll_fused")
    out = torch.empty_like(xg)
    tensors = (xg, out, ws, q["attn"]["qkv"]["kernel"],
               q["attn"]["qkv"]["bias"], q["attn"]["proj"]["kernel"],
               q["attn"]["proj"]["bias"], table, q["norm1"]["scale"],
               q["norm1"]["bias"], q["norm2"]["scale"], q["norm2"]["bias"],
               q["mlp"]["fc1"]["kernel"], q["mlp"]["fc1"]["bias"],
               q["mlp"]["fc2"]["kernel"], q["mlp"]["fc2"]["bias"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_block_noroll(
            DTYPE_CODE[xg.dtype], DTYPE_CODE[table.dtype],
            *(t.data_ptr() for t in tensors), *dims, int(gelu_tanh), stream)
    _build.check(code, "block_noroll_fused")
    block_noroll_fused.launches += 1
    return out


block_noroll_fused.launches = 0


# ---------------------------------------------------------------------------
# The fused window attention on partitioned windows
# ---------------------------------------------------------------------------

def window_attention_plain(x, wqkv, bqkv, wp, bp, bias):
    """Plain PyTorch version of the fused window attention (any device):
    ``x`` (..., ntype, N, C) windows, ``bias`` (ntype, heads, N, N)
    float32; rounding as ``_make_fused_kernel``."""
    dt = x.dtype
    c, heads = x.shape[-1], bias.shape[1]
    hd = c // heads
    qkv = dense({"kernel": wqkv.to(dt), "bias": bqkv.to(dt)}, x)
    q, k, v = (_heads(qkv[..., i * c:(i + 1) * c], heads) for i in range(3))
    q = q * torch.tensor(hd ** -0.5, dtype=dt, device=x.device)
    s = q.float() @ k.float().transpose(-1, -2) + bias.float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pr = (e / e.sum(-1, keepdim=True)).to(dt)
    del s, e
    o = _merge((pr.float() @ v.float()).to(dt))
    return dense({"kernel": wp.to(dt), "bias": bp.to(dt)}, o)


def window_operands(x, weights, bias):
    """What the fused window attention kernel takes, checked before a
    launch: ``(x, weights, heads)``, the weights ``[wqkv, bqkv, wp, bp]``
    in x's dtype.  Raises ValueError on an unsupported input or, in bf16
    (the tensor-core route, ``csrc/window_attn.cu``), on a C that is not a
    multiple of 8 or a window of more than 144 tokens
    (``check_tensor_core_shape``; any head dim, as the grid attention's);
    the bf16 input and weights are 16-byte aligned (copies where they are
    not).  float32 takes any window of at most 256 tokens."""
    *lead, ntype, n, c = x.shape
    heads = bias.shape[1] if bias.dim() == 4 else 0
    shapes = [(c, 3 * c), (3 * c,), (c, c), (c,)]
    if (x.dtype not in DTYPE_CODE or not x.is_contiguous() or not lead
            or heads < 1 or c % heads
            or [tuple(t.shape) for t in weights] != shapes
            or bias.dtype != torch.float32 or not bias.is_contiguous()
            or tuple(bias.shape) != (ntype, heads, n, n)):
        raise ValueError(f"window_attention_pallas: unsupported input "
                         f"{tuple(x.shape)} {x.dtype}, weights "
                         f"{[tuple(t.shape) for t in weights]}, bias "
                         f"{tuple(bias.shape)} {bias.dtype}")
    weights = [t.to(x.dtype).contiguous() for t in weights]
    if x.dtype == torch.bfloat16:   # the tensor-core tiles, 16-byte rows
        check_tensor_core_shape((c,), n, "window_attention_pallas")
        x = aligned16(x)
        weights = [aligned16(t) for t in weights]
    for t in weights + [bias]:
        if t.device != x.device:
            raise ValueError(f"window_attention_pallas: parameter on "
                             f"{t.device}, input on {x.device}")
    return x, weights, heads


def window_attention_fused(x, wqkv, bqkv, wp, bp, bias):
    """The fused window attention forward on ``x`` (..., ntype, N, C),
    contiguous, with the folded float32 ``bias`` (ntype, heads, N, N): the
    CUDA kernel for a CUDA tensor (counted in
    ``window_attention_pallas.launches``; in bf16 the tensor-core route,
    which takes C a multiple of 8 and N <= 144 and raises ValueError
    otherwise, checked by ``window_operands``), the plain version for a
    CPU tensor."""
    if not x.is_cuda:
        return window_attention_plain(x, wqkv, bqkv, wp, bp, bias)
    x, weights, heads = window_operands(x, [wqkv, bqkv, wp, bp], bias)
    *lead, ntype, n, c = x.shape
    lib = _build.library()
    ws = torch.empty(lib.pangu_window_attn_ws(x.numel() // c, c),
                     dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    tensors = (x, out, ws, *weights, bias)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_window_attn(
            DTYPE_CODE[x.dtype], *(_ptr(t) for t in tensors),
            x.numel() // (ntype * n * c), ntype, n, c, heads, stream)
    _build.check(code, "window_attention_pallas")
    window_attention_pallas.launches += 1
    return out


def _window_ref(x, wqkv, bqkv, wp, bp, bias, kernels: bool):
    """``_fused_core``'s reference composition on the windows ``x``
    (..., ntype, N, C): qkv product, ``Sdpa`` on the folded bias, proj
    product, each product rounded to x's dtype before its bias is added in
    it.  Differentiable in every input."""
    dt = x.dtype
    *lead, ntype, n, c = x.shape
    heads = bias.shape[1]
    qkv = _dot(x, wqkv.to(dt)) + bqkv.to(dt)
    qkv = qkv.reshape(-1, ntype, n, 3, heads, c // heads)
    qkv = qkv.permute(0, 1, 3, 4, 5, 2).contiguous()
    out = Sdpa.apply(kernels, qkv, bias)          # (nwin, ntype, heads, hd, N)
    out = out.permute(0, 1, 4, 2, 3).reshape(*lead, ntype, n, c)
    return _dot(out, wp.to(dt)) + bp.to(dt)


class WindowAttention(torch.autograd.Function):
    """``WindowAttention.apply(kernels, x, wqkv, bqkv, wp, bp, bias)``: the
    fused window attention forward (``kernels=False``: its plain version on
    any device); backward, autograd of :func:`_window_ref` recomputed from
    the saved inputs (the ``sdpa`` kernels in it on the card), as
    ``_fused_core``'s ``jax.vjp`` of its ``ref``.  The gradients come back
    in the dtypes of the inputs."""

    @staticmethod
    def forward(ctx, kernels, x, wqkv, bqkv, wp, bp, bias):
        ctx.kernels = kernels
        ctx.dtypes = [t.dtype for t in (x, wqkv, bqkv, wp, bp, bias)]
        ctx.save_for_backward(x, wqkv, bqkv, wp, bp, bias)
        fwd = window_attention_fused if kernels else window_attention_plain
        return fwd(x, wqkv, bqkv, wp, bp, bias)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            y = _window_ref(*inputs, ctx.kernels)
            grads = torch.autograd.grad(y, inputs, g)
        return (None, *(d.to(dt) for d, dt in zip(grads, ctx.dtypes)))


def window_attention_pallas(p, x, heads: int,
                            ids: Optional[torch.Tensor] = None, *,
                            kernels: bool = True):
    """Drop-in for :func:`~pangu_tpu_torch.models.layers.earth_attention`
    on partitioned windows ``x`` (B, nlon, ntype, N, C): ``p`` the block's
    ``attn`` params, ``ids`` the (ntype, N) region ids of a shifted block
    (-100 between regions) or None.  The mask is folded into the float32
    (ntype, heads, N, N) bias here, outside the kernel; differentiable
    through :class:`WindowAttention`.  Where qkv or proj carries LoRA leaves
    it is ``earth_attention`` itself, as in the JAX package.  On the card
    the bf16 kernel (tensor cores) takes C a multiple of 8 and windows of
    at most 144 tokens and raises ValueError otherwise; float32 takes
    windows of at most 256 tokens.  ``kernels=False`` runs the plain
    versions on any device."""
    if "lora_a" in p["qkv"] or "lora_a" in p["proj"]:
        return earth_attention(p, x, heads, ids)
    if p["bias_table"].shape[1] != heads:
        raise ValueError(f"window_attention_pallas: {heads} heads, bias "
                         f"table {tuple(p['bias_table'].shape)}")
    bias = _full_bias(p["bias_table"], ids).contiguous()
    return WindowAttention.apply(
        kernels, x.contiguous(), p["qkv"]["kernel"], p["qkv"]["bias"],
        p["proj"]["kernel"], p["proj"]["bias"], bias)


window_attention_pallas.launches = 0

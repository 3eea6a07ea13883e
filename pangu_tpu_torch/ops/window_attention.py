"""Windowed attention on the token grid: the counterpart of the grid part of
``pangu_tpu/ops/window_attention.py`` (``_grid_attention_pallas``,
``_grid_attention_bwd_pallas``, ``_grid_core`` with its ``pallas``
backward).

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
    through; its gradients come back in the dtypes of its inputs.

Each wrapper launches its kernel for a CUDA tensor (counting the launch in
``launches``) and runs its plain version for a CPU tensor.  The plain
versions round where the Pallas bodies do: qkv once after the bias,
probabilities before P.V, the attention output, and in the backward P in
float32 for dS but rounded for dV, dS summed unrounded into dbias and
rounded before dQ / dK, da, dqkv and dx rounded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.models.layers import (dense, window_partition,
                                          window_reverse)
from pangu_tpu_torch.ops.earth_block_bwd import _colsum, _wgrad
from pangu_tpu_torch.ops.earth_block_wm import DTYPE_CODE

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
    """Raise on what the kernels do not take; return the weights in x's
    dtype, the ids as int32 on x's device, and the window grid
    ``(b, nz, nlat, nlon, n, c, heads)``."""
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
    for t in weights + [table]:
        if t.device != x.device:
            raise ValueError(f"{what}: parameter on {t.device}, input on "
                             f"{x.device}")
    if ids is not None:
        ids = ids.to(device=x.device, dtype=torch.int32).contiguous()
        if ids.shape != (nz * nlat, n):
            raise ValueError(f"{what}: region ids {tuple(ids.shape)}")
    return weights, ids, (b, nz, nlat, nlon, n, c, heads)


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
    (wqkv, bqkv, wp, bp), ids, dims = _checked(
        x, [wqkv, bqkv, wp, bp], table, window, ids, "grid_attention")
    table = table.contiguous()
    lib = _build.library()
    c = x.shape[-1]
    ws = torch.empty(lib.pangu_grid_attn_ws(x.numel() // c, c, 0),
                     dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    code = lib.pangu_grid_attn(
        DTYPE_CODE[x.dtype], DTYPE_CODE[table.dtype], _ptr(x), _ptr(out),
        _ptr(ws), _ptr(wqkv), _ptr(bqkv), _ptr(wp), _ptr(bp), _ptr(table),
        _ptr(ids), *dims, *window,
        torch.cuda.current_stream(x.device).cuda_stream)
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
    (wqkv, bqkv, wp), ids, dims = _checked(
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
    code = lib.pangu_grid_attn_bwd(
        DTYPE_CODE[x.dtype], DTYPE_CODE[table.dtype], _ptr(x), _ptr(g),
        _ptr(dx), _ptr(ws), _ptr(part), _ptr(wqkv), _ptr(bqkv), _ptr(wp),
        _ptr(table), _ptr(ids), _ptr(dwqkv), _ptr(dwp), _ptr(dbias), *dims,
        *window, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "grid_attention_bwd")
    grid_attention_bwd.launches += 1
    # the last row of each weight gradient is its bias gradient
    return dx, dwqkv[:c], dwqkv[c], dwp[:c], dwp[c], dbias


grid_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class GridAttention(torch.autograd.Function):
    """``GridAttention.apply(meta, x, wqkv, bqkv, wp, bp, table)``, meta =
    ``(window, ids, kernels)``: :func:`grid_attention` forward,
    :func:`grid_attention_bwd` backward (``kernels=False``: their plain
    versions on any device).  The gradients come back in the dtypes of the
    inputs, as ``_grid_core``'s backward casts them."""

    @staticmethod
    def forward(ctx, meta, x, wqkv, bqkv, wp, bp, table):
        window, ids, kernels = meta
        ctx.meta = meta
        ctx.dtypes = [t.dtype for t in (x, wqkv, bqkv, wp, bp, table)]
        ctx.save_for_backward(x, wqkv, bqkv, wp, table)
        fwd = grid_attention if kernels else grid_attention_plain
        return fwd(x, wqkv, bqkv, wp, bp, table, window, ids)

    @staticmethod
    def backward(ctx, g):
        window, ids, kernels = ctx.meta
        x, wqkv, bqkv, wp, table = ctx.saved_tensors
        bwd = grid_attention_bwd if kernels else grid_attention_bwd_plain
        grads = bwd(x, g, wqkv, bqkv, wp, table, window, ids)
        return (None, *(d.to(dt) for d, dt in zip(grads, ctx.dtypes)))

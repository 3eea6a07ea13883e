"""Whole-block backward on window-major storage and the training stage chain:
the counterpart of ``pangu_tpu/ops/earth_block_bwd.py`` (``_block_bwd_call``
in wm -> wm layout, ``run_stage_train_wm`` on one device).

``block_bwd`` recomputes one block's forward from its saved input and
returns every gradient of it: the input cotangent ``dx`` in the block's OWN
window coordinates (latitude-pad rows zeroed), and float32 sums for the
dense kernels and biases, the LayerNorms and the bias table.  The output
cotangent ``g`` is read through ``delta_g``, the negated window shift of the
next block (whose backward wrote its dx in its own window coordinates), so
no roll of a cotangent is ever materialised.  Rounding follows the JAX
kernel body: the recomputed first branch stays float32 and ``x1`` is
rounded once; every cotangent that feeds a product is rounded to the
activation dtype; the bias-table gradient sums the unrounded float32 dS.

The canonical layouts (``x_layout`` / ``g_layout="canon"``, the JAX
kernel's stage end-points): x is the lat-padded (B, Z, Hp, W, C) grid, read
unshifted (a stage's first block), and dx is written to that grid, pad rows
zero; the cotangent g is that grid in the block's own window coordinates
(a stage's last block, whose output the stage rolls back once).

``run_stage_train_wm`` is ONE ``torch.autograd.Function`` per stage call.
Its forward runs the block kernels with their stochastic-depth scales and
saves only each block's input (the remat of ``jax.checkpoint``); its
backward walks the blocks in reverse through ``block_bwd``, one block at a
time, so at most one block's recompute lives in memory.  Its ends are
window-major storage or, with ``io_in`` / ``io_out="canon"``, the
canonical grid, read by the first block (``block_wm_canon`` with
``in_layout="canon"`` forward, ``block_bwd_canon`` with ``x_layout="canon"``
backward) and written by the last (``out_layout`` / ``g_layout="canon"``).
``kernels=False`` runs the plain versions in both directions, on any
device.

``block_bwd`` (wm -> wm) and ``block_bwd_canon`` (a canonical end) launch
the CUDA kernel unit (``csrc/block_bwd.cu``) on a CUDA tensor, each with its
own ``launches`` count, and run ``block_bwd_plain`` on a CPU tensor.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import StageGeometry
from pangu_tpu_torch.models.layers import dense, window_region_ids
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset,
                                                _lon_shift_wm, _z_shift_wm,
                                                block_wm, block_wm_canon,
                                                block_wm_canon_plain,
                                                block_wm_plain, check_drop,
                                                check_shard_read, drop_scales,
                                                from_window_major,
                                                pad_rows_zeroed, params_in,
                                                require_device,
                                                tensor_core_operands,
                                                to_window_major, wm_extent)
from pangu_tpu_torch.parallel.sharding import shard

LAYOUTS = ("wm", "canon")

# the leaves of one block's params, in the order the stage Function carries
BLOCK_LEAVES = (("attn", "qkv", "kernel"), ("attn", "qkv", "bias"),
                ("attn", "proj", "kernel"), ("attn", "proj", "bias"),
                ("attn", "bias_table"), ("norm1", "scale"), ("norm1", "bias"),
                ("norm2", "scale"), ("norm2", "bias"),
                ("mlp", "fc1", "kernel"), ("mlp", "fc1", "bias"),
                ("mlp", "fc2", "kernel"), ("mlp", "fc2", "bias"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(values):
    """BLOCK_LEAVES-ordered values -> a block's nested param dict."""
    out = {}
    for path, v in zip(BLOCK_LEAVES, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _window_coords(t, geom: StageGeometry, delta: Offset):
    """Storage -> window coordinates: position p reads storage p + delta."""
    grid = from_window_major(t, geom.window)
    if any(delta):
        grid = torch.roll(grid, shifts=tuple(-d for d in delta), dims=(1, 2, 3))
    return grid


def _ln_stats(x32, eps: float = 1e-5):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd, rstd


def _ln_bwd(dy32, xhat, rstd, scale32):
    """dx of y = xhat*scale + bias given dy, and the (dscale, dbias) sums."""
    dxhat = dy32 * scale32
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    rows = dy32.reshape(-1, dy32.shape[-1])
    return dx, (rows * xhat.reshape(rows.shape)).sum(0), rows.sum(0)


def gelu_and_grad(z32, tanh: bool):
    """GELU and its derivative in float32 (erf form, or the tanh form)."""
    if tanh:
        k = math.sqrt(2.0 / math.pi)
        t = torch.tanh(k * (z32 + 0.044715 * z32 ** 3))
        du = k * (1.0 + 3 * 0.044715 * z32 * z32)
        return 0.5 * z32 * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * z32 * (1.0 - t * t) * du
    phi = 0.5 * (1.0 + torch.erf(z32 * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * z32 * z32)
    return z32 * phi, phi + z32 * pdf


def _wgrad(x, dy):
    """sum over rows of x^T dy, float32: (..., K), (..., N) -> (K, N)."""
    return x.reshape(-1, x.shape[-1]).float().T @ dy.reshape(-1, dy.shape[-1]).float()


def _colsum(dy):
    return dy.reshape(-1, dy.shape[-1]).float().sum(0)


def _check_layouts(x_layout: str, g_layout: str, delta_x: Offset,
                   delta_g: Offset, what: str) -> None:
    """A canonical end is read unshifted: its delta must be zero."""
    if x_layout not in LAYOUTS or g_layout not in LAYOUTS:
        raise ValueError(f"{what}: layouts {x_layout!r}, {g_layout!r}")
    if x_layout == "canon" and any(delta_x):
        raise ValueError(f"{what}: a canonical x is read unshifted, not "
                         f"through {delta_x}")
    if g_layout == "canon" and any(delta_g):
        raise ValueError(f"{what}: a canonical cotangent is read unshifted, "
                         f"not through {delta_g}")


def block_bwd_plain(p, xs, g, geom: StageGeometry, delta_x: Offset,
                    delta_g: Offset, canon_add: int,
                    ids: Optional[torch.Tensor],
                    drop: Optional[torch.Tensor], gelu_tanh: bool,
                    x_layout: str = "wm", g_layout: str = "wm"):
    """Plain PyTorch version of the block backward (any device).  Returns
    ``(dx, grads)``: dx like ``xs`` (wm storage, or the grid with
    ``x_layout="canon"``) in the block's window coordinates, grads a block
    param tree of float32 sums."""
    _check_layouts(x_layout, g_layout, delta_x, delta_g, "block_bwd_plain")
    x_canon = x_layout == "canon"
    if x_canon:
        xs = to_window_major(xs, geom.window)
    if g_layout == "canon":
        g = to_window_major(g, geom.window)
    b, nz, nlat, nlon, n, c = xs.shape
    heads = geom.heads
    hd = c // heads
    dt = xs.dtype
    q = params_in(p, dt)
    s1, s2 = drop_scales(drop, 6)

    xg = to_window_major(pad_rows_zeroed(_window_coords(xs, geom, delta_x),
                                         geom, canon_add), geom.window)
    gf = to_window_major(_window_coords(g, geom, delta_g), geom.window).float()

    # ---- recompute the forward --------------------------------------------
    qkv = dense(q["attn"]["qkv"], xg).reshape(b, nz, nlat, nlon, n, 3, heads, hd)
    qh, kh, vh = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
    bias = q["attn"]["bias_table"].float().reshape(nz, nlat, heads, n, n)
    bias = bias[None, :, :, None]                    # type = zz * nlat + hh
    if ids is not None:
        r = ids.reshape(nz, nlat, n)
        mask = torch.where(r[..., :, None] != r[..., None, :], -100.0, 0.0)
        bias = bias + mask[None, :, :, None, None]
    scale = hd ** -0.5
    s = (qh.float() @ kh.float().transpose(-1, -2)) * scale + bias
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p32 = e / e.sum(-1, keepdim=True)
    pr = p32.to(dt)
    del s, e
    o = (pr.float() @ vh.float()).to(dt)
    af = o.transpose(-3, -2).reshape(b, nz, nlat, nlon, n, c)
    a = dense(q["attn"]["proj"], af)

    f = lambda t: t.float()  # noqa: E731
    ahat, ra = _ln_stats(a.float())
    br1 = ahat * f(q["norm1"]["scale"]) + f(q["norm1"]["bias"])
    if s1 is not None:
        br1 = br1 * s1
    x1 = (xg.float() + br1).to(dt)
    z = dense(q["mlp"]["fc1"], x1)
    h32, dgelu = gelu_and_grad(z.float(), gelu_tanh)
    h = h32.to(dt)
    y = dense(q["mlp"]["fc2"], h)

    # ---- backward: the tail --------------------------------------------------
    dbr2 = gf if s2 is None else gf * s2
    yhat, ry = _ln_stats(y.float())
    dy2, dn2s, dn2b = _ln_bwd(dbr2, yhat, ry, f(q["norm2"]["scale"]))
    dy2 = dy2.to(dt)
    dw2, db2 = _wgrad(h, dy2), _colsum(dy2)
    dz = ((dy2.float() @ f(q["mlp"]["fc2"]["kernel"]).T) * dgelu).to(dt)
    dw1, db1 = _wgrad(x1, dz), _colsum(dz)
    dx1 = gf + dz.float() @ f(q["mlp"]["fc1"]["kernel"]).T
    dbr1 = dx1 if s1 is None else dx1 * s1
    da, dn1s, dn1b = _ln_bwd(dbr1, ahat, ra, f(q["norm1"]["scale"]))
    da = da.to(dt)

    # ---- backward: proj and attention ---------------------------------------
    dwp, dbp = _wgrad(af, da), _colsum(da)
    datt = (da.float() @ f(q["attn"]["proj"]["kernel"]).T).to(dt)
    do = datt.reshape(b, nz, nlat, nlon, n, heads, hd).transpose(-3, -2)
    dv = (pr.float().transpose(-1, -2) @ do.float()).to(dt)
    dp = do.float() @ vh.float().transpose(-1, -2)
    ds32 = p32 * (dp - (dp * p32).sum(-1, keepdim=True))
    del dp
    dtable = ds32.sum(dim=(0, 3)).reshape(nz * nlat, heads, n, n)
    ds = ds32.to(dt)
    del ds32, p32
    dq = ((ds.float() @ kh.float()) * scale).to(dt)
    dk = ((ds.float().transpose(-1, -2) @ qh.float()) * scale).to(dt)
    dqkv = torch.stack([dq, dk, dv], dim=4)         # (.., 3, heads, n, hd)
    dqkv = dqkv.permute(0, 1, 2, 3, 6, 4, 5, 7).reshape(b, nz, nlat, nlon, n, 3 * c)

    # ---- backward: qkv and the residual --------------------------------------
    dwqkv, dbqkv = _wgrad(xg, dqkv), _colsum(dqkv)
    dx = (dx1 + dqkv.float() @ f(q["attn"]["qkv"]["kernel"]).T).to(dt)
    dx = pad_rows_zeroed(from_window_major(dx, geom.window), geom, canon_add)
    if not x_canon:
        dx = to_window_major(dx, geom.window)
    grads = {"attn": {"qkv": {"kernel": dwqkv, "bias": dbqkv},
                      "proj": {"kernel": dwp, "bias": dbp},
                      "bias_table": dtable},
             "norm1": {"scale": dn1s, "bias": dn1b},
             "norm2": {"scale": dn2s, "bias": dn2b},
             "mlp": {"fc1": {"kernel": dw1, "bias": db1},
                     "fc2": {"kernel": dw2, "bias": db2}}}
    return dx, grads


# ---------------------------------------------------------------------------
# The CUDA kernel unit
# ---------------------------------------------------------------------------

def _extent(x, layout: str, geom: StageGeometry):
    """The (Z, Hp, W) token extent of x in ``layout``."""
    return tuple(x.shape[1:4]) if layout == "canon" else wm_extent(x,
                                                                  geom.window)


def _check_shard(x, g, geom: StageGeometry, delta_x: Offset, delta_g: Offset,
                 x_layout: str, g_layout: str, what: str) -> None:
    """The whole grid or one (tp, sp) shard of it, read through shifts that
    stay on the shard (``check_shard_read``: the sharded stage chain
    resolves the z and lon components in storage first)."""
    check_shard_read(_extent(x, x_layout, geom), geom, delta_x, what)
    check_shard_read(_extent(g, g_layout, geom), geom, delta_g, what)


def _launch(p, xs, g, geom: StageGeometry, delta_x: Offset, delta_g: Offset,
            canon_add: int, ids, drop, gelu_tanh: bool, x_layout: str,
            g_layout: str):
    wz, wh, ww = geom.window
    n = wz * wh * ww
    z, hp, w = _extent(xs, x_layout, geom)      # the whole grid or a shard
    nz, nlat, nlon = z // wz, hp // wh, w // ww
    c = xs.shape[-1]
    b = xs.shape[0]
    grid = (b, z, hp, w, c)
    wm = (b, nz, nlat, nlon, n, c)
    want_x = grid if x_layout == "canon" else wm
    want_g = grid if g_layout == "canon" else wm
    if (tuple(xs.shape) != want_x or tuple(g.shape) != want_g
            or (nz * wz, nlat * wh, nlon * ww) != (z, hp, w)
            or xs.dtype not in DTYPE_CODE or c != geom.dim or c % geom.heads
            or g.dtype != xs.dtype
            or not xs.is_contiguous() or not g.is_contiguous()):
        raise ValueError(f"block_bwd: unsupported input {tuple(xs.shape)} "
                         f"{xs.dtype} ({x_layout}), cotangent "
                         f"{tuple(g.shape)} {g.dtype} ({g_layout}) for {geom}")
    q = params_in(p, xs.dtype)
    require_device(q, xs.device, "block_bwd")
    table = q["attn"]["bias_table"]
    ntype = nz * nlat
    if table.dtype not in DTYPE_CODE or table.shape != (ntype, geom.heads, n, n):
        raise ValueError(f"block_bwd: bias table {tuple(table.shape)} {table.dtype}")
    if ids is not None:
        ids = ids.to(device=xs.device, dtype=torch.int32).contiguous()
        if ids.shape != (ntype, n):
            raise ValueError(f"block_bwd: region ids {tuple(ids.shape)}")
    drop = check_drop(drop, b, xs.device, "block_bwd")
    hidden = q["mlp"]["fc1"]["kernel"].shape[-1]
    if xs.dtype == torch.bfloat16:
        tensor_core_operands(q, c, hidden, n, "block_bwd")
    rows = xs.numel() // c
    dev = xs.device
    lib = _build.library()
    # workspace sizes come from the library, which also lays them out
    ws_t = torch.empty(lib.pangu_block_bwd_ws(rows, c, hidden, 0),
                       dtype=xs.dtype, device=dev)
    ws_f = torch.empty(lib.pangu_block_bwd_ws(rows, c, hidden, 1),
                       dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(xs)
    dwqkv = torch.empty((c + 1, 3 * c), **f32)       # last row: the bias
    dwp = torch.empty((c + 1, c), **f32)
    dw1 = torch.empty((c + 1, hidden), **f32)
    dw2 = torch.empty((hidden + 1, c), **f32)
    dln = torch.empty((4, c), **f32)                  # dn1s, dn1b, dn2s, dn2b
    dtable = torch.empty((ntype, geom.heads, n, n), **f32)
    tensors = (xs, g, dx, ws_t, ws_f, q["attn"]["qkv"]["kernel"],
               q["attn"]["qkv"]["bias"], q["attn"]["proj"]["kernel"],
               q["attn"]["proj"]["bias"], table, ids, q["norm1"]["scale"],
               q["norm1"]["bias"], q["norm2"]["scale"],
               q["mlp"]["fc1"]["kernel"], q["mlp"]["fc1"]["bias"],
               q["mlp"]["fc2"]["kernel"], q["mlp"]["fc2"]["bias"], drop,
               dwqkv, dwp, dw1, dw2, dln, dtable)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_block_bwd(
            DTYPE_CODE[xs.dtype], DTYPE_CODE[table.dtype],
            *(None if t is None else t.data_ptr() for t in tensors),
            b, nz, nlat, nlon, n, c, geom.heads, hidden, wz, wh, ww,
            *delta_x, *delta_g, canon_add, geom.h, int(gelu_tanh),
            int(x_layout == "canon"), int(g_layout == "canon"), stream)
    _build.check(code, "block_bwd")
    grads = {"attn": {"qkv": {"kernel": dwqkv[:c], "bias": dwqkv[c]},
                      "proj": {"kernel": dwp[:c], "bias": dwp[c]},
                      "bias_table": dtable},
             "norm1": {"scale": dln[0], "bias": dln[1]},
             "norm2": {"scale": dln[2], "bias": dln[3]},
             "mlp": {"fc1": {"kernel": dw1[:c], "bias": dw1[c]},
                     "fc2": {"kernel": dw2[:hidden], "bias": dw2[hidden]}}}
    return dx, grads


def block_bwd(p, xs, g, geom: StageGeometry, delta_x: Offset, delta_g: Offset,
              canon_add: int, ids: Optional[torch.Tensor],
              drop: Optional[torch.Tensor], gelu_tanh: bool, *,
              x_layout: str = "wm", g_layout: str = "wm"):
    """Every gradient of one block on window-major storage: the CUDA kernel
    unit for a CUDA tensor, the plain version for a CPU tensor.

    ``xs``: the block's saved input storage; ``g``: the cotangent of its
    output, stored so that position t holds the cotangent of output token
    t - delta_g (``delta_g`` = minus the next block's ``delta``, (0, 0, 0)
    for a stage's last block); ``delta_x``, ``canon_add``, ``ids`` and
    ``drop`` as in ``block_wm``.  Returns ``(dx, grads)``: dx in the block's
    window coordinates, pad rows zero; grads float32 sums in a block param
    tree.  A canonical layout of either end is :func:`block_bwd_canon`'s
    (and counted there).

    On a rank's (tp, sp) shard, ``xs`` and ``g`` are the shard (its local
    extent), ``ids`` and the bias table its tp slice of rows, and the
    table's gradient comes out for that slice; a shift that would read
    across shards (a z component of ``delta_x`` / ``delta_g`` on a z
    shard, a lon component on a lon shard) raises ValueError."""
    _check_layouts(x_layout, g_layout, delta_x, delta_g, "block_bwd")
    if "canon" in (x_layout, g_layout):
        return block_bwd_canon(p, xs, g, geom, delta_x, delta_g, canon_add,
                               ids, drop, gelu_tanh, x_layout=x_layout,
                               g_layout=g_layout)
    _check_shard(xs, g, geom, delta_x, delta_g, x_layout, g_layout,
                 "block_bwd")
    if not xs.is_cuda:
        return block_bwd_plain(p, xs, g, geom, delta_x, delta_g, canon_add,
                               ids, drop, gelu_tanh)
    out = _launch(p, xs, g, geom, delta_x, delta_g, canon_add, ids, drop,
                  gelu_tanh, x_layout, g_layout)
    block_bwd.launches += 1
    return out


block_bwd.launches = 0


def block_bwd_canon(p, x, g, geom: StageGeometry, delta_x: Offset,
                    delta_g: Offset, canon_add: int,
                    ids: Optional[torch.Tensor], drop: Optional[torch.Tensor],
                    gelu_tanh: bool, *, x_layout: str = "wm",
                    g_layout: str = "wm"):
    """The backward of a stage end-point block: ``x_layout="canon"``, x is
    the lat-padded (B, Z, Hp, W, C) grid in canonical coordinates, read
    unshifted, and dx is written to that grid (pad rows zero);
    ``g_layout="canon"``, the cotangent is that grid in the block's own
    window coordinates.  At least one end is canonical; the other as in
    :func:`block_bwd`, on the whole grid or a shard as there.  The CUDA
    kernel unit for a CUDA tensor, the plain version for a CPU tensor."""
    if "canon" not in (x_layout, g_layout):
        raise ValueError("block_bwd_canon: neither end is canonical")
    _check_layouts(x_layout, g_layout, delta_x, delta_g, "block_bwd_canon")
    _check_shard(x, g, geom, delta_x, delta_g, x_layout, g_layout,
                 "block_bwd_canon")
    if not x.is_cuda:
        return block_bwd_plain(p, x, g, geom, delta_x, delta_g, canon_add,
                               ids, drop, gelu_tanh, x_layout, g_layout)
    out = _launch(p, x, g, geom, delta_x, delta_g, canon_add, ids, drop,
                  gelu_tanh, x_layout, g_layout)
    block_bwd_canon.launches += 1
    return out


block_bwd_canon.launches = 0


# ---------------------------------------------------------------------------
# The training stage chain
# ---------------------------------------------------------------------------

def _schedule(geom: StageGeometry, depth: int):
    """Per block: (delta, canon_add, shifted), and the stage's final offset,
    as ``run_stage_wm`` chains them from canonical entry storage."""
    wz, wh, ww = geom.window
    half = (wz // 2, wh // 2, ww // 2)
    off, out = (0, 0, 0), []
    for j in range(depth):
        shifted = j % 2 == 1
        target = half if shifted else (0, 0, 0)
        out.append((tuple(t - o for t, o in zip(target, off)), target[1],
                    shifted))
        off = target
    return out, off


def _ends(j: int, nb: int, io_in: str, io_out: str):
    """Block j's input and output layouts in a stage of nb blocks."""
    return ("canon" if io_in == "canon" and j == 0 else "wm",
            "canon" if io_out == "canon" and j == nb - 1 else "wm")


def _stage_ids(geom: StageGeometry, mesh, device):
    """The region ids of a shifted block, defined on the global grid; a z
    shard (tp > 1) takes its own ``ntype / tp`` rows."""
    ids = torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                            geom.window), device=device)
    if mesh is not None and mesh.shape["tp"] > 1:
        ids = shard(ids, ("tp", None), mesh)
    return ids


def _storage_shifts(delta: Offset, mesh):
    """A block's storage-level shift ``(dz, dw)`` under a mesh (the z
    component on a z shard, tp > 1; the lon one on a lon shard, sp > 1)
    and the delta its kernel keeps."""
    if mesh is None:
        return (0, 0), delta
    dz = delta[0] if mesh.shape["tp"] > 1 else 0
    dw = delta[2] if mesh.shape["sp"] > 1 else 0
    return (dz, dw), (delta[0] - dz, delta[1], delta[2] - dw)


class _StageTrain(torch.autograd.Function):
    """One stage call: forward through the block kernels saving each block's
    input, backward through ``block_bwd`` block by block in reverse.

    Under a mesh the halos before a block (``_z_shift_wm`` /
    ``_lon_shift_wm`` in storage, the kernel keeping the rest of its
    delta) run inside: the saved input is the shifted storage, and the
    backward takes the cotangent through the opposite shifts between block
    backwards (a global shift is a permutation: its transpose is the
    opposite shift), so the next block back still reads it through minus
    this block's kernel delta."""

    @staticmethod
    def forward(ctx, meta, x, *leaves):
        geom, drops, gelu_tanh, kernels, io_in, io_out, mesh = meta
        wz, _, ww = geom.window
        nb = len(leaves) // len(BLOCK_LEAVES)
        blocks = [_tree(leaves[j * len(BLOCK_LEAVES):(j + 1) * len(BLOCK_LEAVES)])
                  for j in range(nb)]
        sched, _ = _schedule(geom, nb)
        ids = _stage_ids(geom, mesh, x.device)
        inputs, plan = [], []
        for j, (bp, (delta, canon_add, shifted)) in enumerate(zip(blocks, sched)):
            (dz, dw), delta = _storage_shifts(delta, mesh)
            if dw:
                x = _lon_shift_wm(x, dw, ww, mesh)
            if dz:
                x = _z_shift_wm(x, dz, wz, mesh)
            inputs.append(x)
            plan.append(((dz, dw), delta))
            args = (bp, x, geom, delta, canon_add, ids if shifted else None,
                    gelu_tanh)
            drop = None if drops is None else drops[j]
            in_l, out_l = _ends(j, nb, io_in, io_out)
            if "canon" in (in_l, out_l):
                x = (block_wm_canon(*args, in_layout=in_l, out_layout=out_l,
                                    drop=drop) if kernels
                     else block_wm_canon_plain(*args, in_l, out_l, drop))
            else:
                x = (block_wm if kernels else block_wm_plain)(*args, drop)
        ctx.meta, ctx.plan = meta, plan
        ctx.save_for_backward(*inputs, *leaves)
        return x

    @staticmethod
    def backward(ctx, g):
        geom, drops, gelu_tanh, kernels, io_in, io_out, mesh = ctx.meta
        wz, _, ww = geom.window
        plan = ctx.plan
        saved = ctx.saved_tensors
        nl = len(BLOCK_LEAVES)
        nb = len(saved) // (nl + 1)
        inputs, leaves = saved[:nb], saved[nb:]
        sched, _ = _schedule(geom, nb)
        ids = _stage_ids(geom, mesh, g.device)
        g = g.contiguous()
        dleaves: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for j in reversed(range(nb)):
            _, canon_add, shifted = sched[j]
            (dz, dw), delta = plan[j]
            delta_g = (tuple(-d for d in plan[j + 1][1]) if j + 1 < nb
                       else (0, 0, 0))
            bl = leaves[j * nl:(j + 1) * nl]
            in_l, out_l = _ends(j, nb, io_in, io_out)
            args = (_tree(bl), inputs[j], g, geom, delta, delta_g, canon_add,
                    ids if shifted else None,
                    None if drops is None else drops[j], gelu_tanh)
            if kernels:
                g, grads = block_bwd(*args, x_layout=in_l, g_layout=out_l)
            else:
                g, grads = block_bwd_plain(*args, in_l, out_l)
            # the transposes of this block's storage shifts, last first
            if dz:
                g = _z_shift_wm(g, -dz, wz, mesh)
            if dw:
                g = _lon_shift_wm(g, -dw, ww, mesh)
            for i, (path, leaf) in enumerate(zip(BLOCK_LEAVES, bl)):
                dleaves[j * nl + i] = _get(grads, path).to(leaf.dtype)
        return (None, g, *dleaves)


def run_stage_train_wm(stage_params, x, geom: StageGeometry,
                       drops: Optional[list], *, gelu_tanh: bool = False,
                       kernels: bool = True, io_in: str = "wm",
                       io_out: str = "wm", mesh=None):
    """Training forward of one EarthSpecificLayer through the window-major
    block kernels, differentiable in ``x`` and every block parameter.
    ``drops``: one (B, 2) float32 tensor of branch scales per block, or None.

    ``io_in="wm"``: ``x`` is wm entry storage in canonical coordinates (the
    backward hands the input cotangent back in those coordinates);
    ``"canon"``: ``x`` is the canonical (B, Z, H, W, C) grid, padded here
    to Hp and read by the first block.  ``io_out="wm"``: returns the ROLLED
    storage and its offset ``(xs, off)``, as ``run_stage_wm(io_layout="wm")``
    does; ``"canon"``: the last block writes the grid in its own window
    coordinates, and one roll by ``off`` plus a crop to H returns the
    canonical grid (an odd depth ends unshifted, ``off`` zero).

    Under a ``mesh`` (``parallel.mesh.Mesh``; wm io only, a canonical end
    raises ValueError) ``x`` is this
    rank's (tp, sp) shard, ``drops`` its dp rows and the bias tables its tp
    slice, as ``run_stage_wm(mesh=)`` serves: the lon (sp > 1) and z
    (tp > 1) components of each block's shift run as storage-level halos
    before the block (and their transposes between block backwards), each
    rank takes its ``ntype / tp`` rows of the region ids, and the closing
    halos after the last block (differentiable, ``Mesh.ppermute``) hand
    back a lon- and z-canonical shard: ``off`` has those components 0."""
    if io_in not in LAYOUTS or io_out not in LAYOUTS:
        raise ValueError(f"run_stage_train_wm: io {io_in!r} -> {io_out!r}")
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None and (io_in, io_out) != ("wm", "wm"):
        raise ValueError(
            "run_stage_train_wm: a canonical-io training stage runs on one "
            "device; under a mesh the canonical route trains its stages "
            "through ops/earth_block_fused.py::run_stage_train")
    blocks = stage_params["blocks"]
    leaves = [_get(bp, path) for bp in blocks for path in BLOCK_LEAVES]
    if drops is not None:
        drops = [d.to(x.device) for d in drops]
    h = x.shape[2]
    if io_in == "canon":
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, geom.h_padded - h))
    else:
        h = geom.h
    meta = (geom, drops, gelu_tanh, kernels, io_in, io_out, mesh)
    _, off = _schedule(geom, len(blocks))
    y = _StageTrain.apply(meta, x.contiguous(), *leaves)
    if io_out == "wm":
        wz, _, ww = geom.window
        if mesh is not None and mesh.shape["sp"] > 1 and off[2]:
            y = _lon_shift_wm(y, -off[2], ww, mesh)
            off = (off[0], off[1], 0)
        if mesh is not None and mesh.shape["tp"] > 1 and off[0]:
            y = _z_shift_wm(y, -off[0], wz, mesh)
            off = (0, off[1], off[2])
        return y, off
    if any(off):
        y = torch.roll(y, shifts=off, dims=(1, 2, 3))
    return y[:, :, :h].contiguous()

"""Window-major whole-block kernels: the counterpart of
``pangu_tpu/ops/earth_block_wm.py`` (``to_window_major``,
``from_window_major``, ``_block_wm_call`` in wm -> wm layout and with a
canonical input or output, ``_block_wm_group_call``, ``_pick_gh`` and
``run_stage_wm`` with either ``io_layout``; under a (dp, sp, tp) mesh, with
``io_layout="wm"``, the storage-level halos ``_lon_shift_wm`` and
``_z_shift_wm``; with ``io_layout="canon"`` under a (dp, sp) view,
``run_stage_wm_sharded``).

The inter-block activation is stored as (B, nz, nlat, nlon, N, C), one row
per window token, windows contiguous, N ordered (z, lat, lon).  A block reads
storage through its shift ``delta = (dz, dh, dw)``: window token (rz, rh, rw)
of window (zz, hh, l) reads storage token (wz*zz + rz + dz, wh*hh + rh + dh,
ww*l + rw + dw), each modulo its extent, and writes its output in its own
window coordinates; the stage carries the resulting offset ``off`` (storage
position p holds canonical token p + off).  Latitude-pad rows are zeroed by
their canonical latitude (wh*hh + rh + canon_add) % hp before the block runs,
as the reference re-pads zeros every block.

Three wrappers launch the one CUDA block kernel (``csrc/block_wm.cu``) on a
CUDA tensor, each with its own ``launches`` count, and run their plain
version on a CPU tensor:

  * ``block_wm``: wm -> wm, one latitude window per attention program;
  * ``block_wm_group``: wm -> wm, ``gh`` latitude windows per attention
    program (the same function: on a CPU tensor it runs ``block_wm_plain``),
    with or without stochastic-depth scales (``drop``);
  * ``block_wm_canon``: a stage end-point block that reads the canonical
    (B, Z, Hp, W, C) grid (``in_layout="canon"``, unshifted) or writes it in
    its own window coordinates (``out_layout="canon"``), or both; with
    ``drop`` it is the end-point block of the canonical training stage
    (``ops/earth_block_bwd.py::run_stage_train_wm``).

On a rank's shard of a mesh each wrapper takes the shard's local extent (a
share of the z windows, tp, and of the longitude windows, sp) and raises
where the block's shift would read across shards (``check_shard_read``):
the sharded stage chain resolves those components in storage first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import StageGeometry, _pick_gh
from pangu_tpu_torch.models.layers import dense, window_region_ids
from pangu_tpu_torch.models.lora import has_lora
from pangu_tpu_torch.ops.block_tail import tail_math
from pangu_tpu_torch.parallel.sharding import grid_roll, shard

Offset = Tuple[int, int, int]

# dtype codes of the C entries
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Layout converters
# ---------------------------------------------------------------------------

def to_window_major(x, window):
    """(B, Z, Hp, W, C) -> (B, nz, nlat, nlon, N, C), N ordered (z, h, w)."""
    wz, wh, ww = window
    b, z, hp, w, c = x.shape
    nz, nlat, nlon = z // wz, hp // wh, w // ww
    x = x.reshape(b, nz, wz, nlat, wh, nlon, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, nz, nlat, nlon, wz * wh * ww, c)


def from_window_major(xs, window):
    """(B, nz, nlat, nlon, N, C) -> (B, Z, Hp, W, C)."""
    wz, wh, ww = window
    b, nz, nlat, nlon, n, c = xs.shape
    xs = xs.reshape(b, nz, nlat, nlon, wz, wh, ww, c)
    xs = xs.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return xs.reshape(b, nz * wz, nlat * wh, nlon * ww, c)


def wm_to_canonical(xs, off: Offset, geom: StageGeometry):
    """Rolled window-major storage -> canonical (B, Z, H, W, C) token grid:
    undo the offset (storage p holds canonical p + off) and crop the
    latitude padding.  The one place the port canonicalises wm storage."""
    t = from_window_major(xs, geom.window)
    if any(off):
        t = torch.roll(t, shifts=tuple(off), dims=(1, 2, 3))
    return t[:, :, :geom.h]


def pad_rows_zeroed(x, geom: StageGeometry, canon_add: int):
    """Zero the rows of a (B, Z, Hp, W, C) grid in window coordinates whose
    canonical latitude (row + canon_add) % hp is latitude padding."""
    hp = x.shape[2]
    lat = (torch.arange(hp, device=x.device) + canon_add) % hp
    keep = (lat < geom.h)[None, None, :, None, None]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def require_device(tree, device, what: str) -> None:
    """Raise unless every tensor in a (nested dict) param tree lies on
    ``device``: a kernel dereferences raw pointers."""
    for v in tree.values():
        if isinstance(v, dict):
            require_device(v, device, what)
        elif v.device != device:
            raise ValueError(f"{what}: parameter on {v.device}, input on {device}")


# ---------------------------------------------------------------------------
# One block, wm -> wm
# ---------------------------------------------------------------------------

def params_in(p, dt):
    """A param tree with every dense / LayerNorm leaf in the activation dtype
    (as the JAX kernels cast them); bias tables keep their own dtype."""
    return {k: (params_in(v, dt) if isinstance(v, dict) else
                v.contiguous() if k == "bias_table" else v.to(dt).contiguous())
            for k, v in p.items()}


def drop_scales(drop, ndim: int):
    """(B, 2) float32 branch scales -> the two (B, 1, ..., 1) scales that
    broadcast against an ndim-dimensional activation (or None, None)."""
    if drop is None:
        return None, None
    shape = (drop.shape[0],) + (1,) * (ndim - 1)
    return drop[:, 0].reshape(shape), drop[:, 1].reshape(shape)


def block_wm_plain(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
                   ids: Optional[torch.Tensor], gelu_tanh: bool,
                   drop: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the block kernel (any device).  ``drop``:
    optional (B, 2) float32 stochastic-depth scales of the attention and MLP
    branches of each sample."""
    b, nz, nlat, nlon, n, c = xs.shape
    heads = geom.heads
    hd = c // heads
    dt = xs.dtype
    p = params_in(p, dt)

    # storage -> this block's window coordinates, pad rows zeroed
    grid = from_window_major(xs, geom.window)
    grid = torch.roll(grid, shifts=tuple(-d for d in delta), dims=(1, 2, 3))
    xg = to_window_major(pad_rows_zeroed(grid, geom, canon_add), geom.window)

    qkv = dense(p["attn"]["qkv"], xg)
    qkv = qkv.reshape(b, nz, nlat, nlon, n, 3, heads, hd)
    q, k, v = (qkv[..., i, :, :].transpose(-3, -2) for i in range(3))
    bias = p["attn"]["bias_table"].float().reshape(nz, nlat, heads, n, n)
    bias = bias[None, :, :, None]                  # type = zz * nlat + hh
    if ids is not None:
        r = ids.reshape(nz, nlat, n)
        mask = torch.where(r[..., :, None] != r[..., None, :], -100.0, 0.0)
        bias = bias + mask[None, :, :, None, None]
    s = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5 + bias
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pr = (e / e.sum(-1, keepdim=True)).to(dt)
    o = (pr.float() @ v.float()).to(dt)            # (b, nz, nlat, nlon, heads, n, hd)
    o = o.transpose(-3, -2).reshape(b, nz, nlat, nlon, n, c)

    a = dense(p["attn"]["proj"], o)
    return tail_math(a, xg, p, gelu_tanh, *drop_scales(drop, a.dim()))


def aligned16(t):
    """``t`` itself where its data starts at a 16-byte boundary, else a
    copy: the bf16 tensor-core tiles copy their operands 16 bytes at a
    time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_tensor_core_shape(channels, n, what: str) -> None:
    """Raise ValueError on what the bf16 tensor-core kernels of the block,
    its backward and the grid attention (``csrc/mma_gemm.cuh``,
    ``csrc/wattn_mma.cuh``) do not take: a channel count (C, the MLP
    width) that is not a multiple of 8, or a window of more than 144
    tokens (``n`` None: no attention)."""
    if any(c % 8 for c in channels) or (n is not None and n > 144):
        raise ValueError(f"{what}: the bf16 kernels take channel counts that "
                         f"are multiples of 8 and windows of at most 144 "
                         f"tokens, got {tuple(channels)} and {n}")


def tensor_core_operands(q, c: int, hidden: int, n: int, what: str) -> None:
    """Raise where the bf16 tensor-core kernels of a block unit do not take
    its shapes (``check_tensor_core_shape``); make the four dense weights
    of the param tree ``q`` (in the activation dtype) 16-byte aligned."""
    check_tensor_core_shape((c, hidden), n, what)
    for sub, leaf in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                      ("mlp", "fc2")):
        q[sub][leaf]["kernel"] = aligned16(q[sub][leaf]["kernel"])


def check_drop(drop, b: int, device, what: str):
    """A (B, 2) float32 contiguous drop tensor on ``device``, or None."""
    if drop is None:
        return None
    if (drop.shape != (b, 2) or drop.dtype != torch.float32
            or drop.device != device):
        raise ValueError(f"{what}: drop {tuple(drop.shape)} {drop.dtype} on "
                         f"{drop.device}, want ({b}, 2) float32 on {device}")
    return drop.contiguous()


def wm_extent(xs, window):
    """The (Z, Hp, W) token extent of (B, nz, nlat, nlon, N, C) storage."""
    return tuple(n * k for n, k in zip(xs.shape[1:4], window))


def local_extent(extent, geom: StageGeometry, what: str):
    """Check that ``extent = (Z, Hp, W)``, the token extent of a tensor, is
    the stage's whole grid or one shard of it: the whole latitude, a whole
    share of the z planes (a tp shard) and of longitude (an sp shard).
    Returns ``(z_local, lon_local)``; raises ValueError on the rest."""
    z, hp, w = extent
    if (hp != geom.h_padded or z <= 0 or w <= 0 or geom.z % z
            or geom.w % w):
        raise ValueError(f"{what}: token extent {tuple(extent)} is no shard "
                         f"of {geom}")
    return z != geom.z, w != geom.w


def check_shard_read(extent, geom: StageGeometry, shift: Offset, what: str):
    """Raise ValueError where a launch on a shard would read across it: a
    z component of ``shift`` on a z-local extent (a tp shard) or a lon
    component on a lon-local extent (an sp shard).  The sharded stage
    chain resolves both in storage first (``_z_shift_wm``,
    ``_lon_shift_wm``)."""
    z_local, lon_local = local_extent(extent, geom, what)
    if (z_local and shift[0]) or (lon_local and shift[2]):
        raise ValueError(f"{what}: shift {tuple(shift)} on the shard "
                         f"{tuple(extent)} of {geom} reads across shards")


def block_operands(p, x, geom: StageGeometry, gh: int, in_canon: bool,
                   what: str):
    """Check what a block kernel takes and raise on the rest (in bf16, the
    tensor-core shapes, before anything is launched); return x (16-byte
    aligned in bf16), the params in x's dtype, the bias table, the launch
    dimensions ``(b, nz, nlat, nlon, n, c, heads, hidden, wz, wh, ww)`` and
    the workspace."""
    wz, wh, ww = geom.window
    n = wz * wh * ww
    if in_canon:
        b, z, hp, w, c = x.shape
        nz, nlat, nlon = z // wz, hp // wh, w // ww
        ok = (nz * wz, nlat * wh, nlon * ww) == (z, hp, w)
    else:
        b, nz, nlat, nlon, n_in, c = x.shape
        ok = n_in == n
    local_extent((nz * wz, nlat * wh, nlon * ww), geom, what)
    if (not ok or x.dtype not in DTYPE_CODE or not x.is_contiguous()
            or c % geom.heads or c != geom.dim or nlat % gh):
        raise ValueError(f"{what}: unsupported input {tuple(x.shape)} "
                         f"{x.dtype} for {geom}")
    if has_lora(p):
        raise ValueError(f"{what}: LoRA leaves on the block")
    q = params_in(p, x.dtype)
    require_device(q, x.device, what)
    table = q["attn"]["bias_table"]
    if table.dtype not in DTYPE_CODE or table.shape != (nz * nlat, geom.heads, n, n):
        raise ValueError(f"{what}: bias table {tuple(table.shape)} {table.dtype}")
    hidden = q["mlp"]["fc1"]["kernel"].shape[-1]
    if x.dtype == torch.bfloat16:   # the tensor-core tiles, 16-byte rows
        tensor_core_operands(q, c, hidden, n, what)
        x = aligned16(x)
    ws = torch.empty(x.numel() // c * (6 * c + hidden), dtype=x.dtype,
                     device=x.device)
    return x, q, table, (b, nz, nlat, nlon, n, c, geom.heads, hidden, wz, wh,
                         ww), ws


def launch_block(p, x, out, geom: StageGeometry, delta: Offset,
                 canon_add: int, ids: Optional[torch.Tensor], gelu_tanh: bool,
                 gh: int, in_canon: bool, out_canon: bool, what: str,
                 drop=None):
    """Launch the block kernel on ``x`` (wm storage, or with ``in_canon``
    the (B, Z, Hp, W, C) grid) into ``out``; raise on what it does not take.
    ``drop``: (B, 2) float32 branch scales or None (the served kernel)."""
    x, q, table, dims, ws = block_operands(p, x, geom, gh, in_canon, what)
    if ids is not None:
        ids = ids.to(device=x.device, dtype=torch.int32).contiguous()
        if ids.shape != (table.shape[0], dims[4]):
            raise ValueError(f"{what}: region ids {tuple(ids.shape)}")
    drop = check_drop(drop, dims[0], x.device, what)
    tensors = (x, out, ws, q["attn"]["qkv"]["kernel"], q["attn"]["qkv"]["bias"],
               q["attn"]["proj"]["kernel"], q["attn"]["proj"]["bias"], table,
               ids, q["norm1"]["scale"], q["norm1"]["bias"],
               q["norm2"]["scale"], q["norm2"]["bias"],
               q["mlp"]["fc1"]["kernel"], q["mlp"]["fc1"]["bias"],
               q["mlp"]["fc2"]["kernel"], q["mlp"]["fc2"]["bias"], drop)
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_block_wm(
            DTYPE_CODE[x.dtype], DTYPE_CODE[table.dtype],
            *(None if t is None else t.data_ptr() for t in tensors), *dims,
            *delta, canon_add, geom.h, int(gelu_tanh), gh, int(in_canon),
            int(out_canon), stream)
    _build.check(code, what)
    return out


def block_wm(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
             ids: Optional[torch.Tensor], gelu_tanh: bool,
             drop: Optional[torch.Tensor] = None):
    """One whole Earth-specific block on window-major storage: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor.

    ``delta``: shift from storage to window coordinates; ``canon_add``: the
    latitude component of this block's own offset (canonical latitude of
    window row rh of window hh is (wh*hh + rh + canon_add) % hp); ``ids``:
    (ntype, N) int32 region ids for a shifted block, else None; ``drop``:
    (B, 2) float32 stochastic-depth scales of the attention and MLP branches
    (training), else None (the served block)."""
    check_shard_read(wm_extent(xs, geom.window), geom, delta, "block_wm")
    if not xs.is_cuda:
        return block_wm_plain(p, xs, geom, delta, canon_add, ids, gelu_tanh,
                              drop)
    out = launch_block(p, xs, torch.empty_like(xs), geom, delta, canon_add,
                       ids, gelu_tanh, 1, False, False, "block_wm", drop)
    block_wm.launches += 1
    return out


block_wm.launches = 0


def block_wm_group(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
                   ids: Optional[torch.Tensor], gelu_tanh: bool, gh: int,
                   drop: Optional[torch.Tensor] = None):
    """``block_wm`` with ``gh`` latitude windows per attention program (gh
    must divide the stage's latitude window count): the same function, so a
    CPU tensor runs ``block_wm_plain``.  ``drop``: (B, 2) float32 branch
    scales or None, as in ``block_wm`` (the grouping touches only the
    attention; the scales act in the two LayerNorm-residual launches)."""
    check_shard_read(wm_extent(xs, geom.window), geom, delta,
                     "block_wm_group")
    if not xs.is_cuda:
        return block_wm_plain(p, xs, geom, delta, canon_add, ids, gelu_tanh,
                              drop)
    out = launch_block(p, xs, torch.empty_like(xs), geom, delta, canon_add,
                       ids, gelu_tanh, gh, False, False, "block_wm_group",
                       drop)
    block_wm_group.launches += 1
    return out


block_wm_group.launches = 0


def block_wm_canon_plain(p, x, geom: StageGeometry, delta: Offset,
                         canon_add: int, ids: Optional[torch.Tensor],
                         gelu_tanh: bool, in_layout: str, out_layout: str,
                         drop: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the end-point block: the relayouts composed
    with ``block_wm_plain`` (any device)."""
    xs = to_window_major(x, geom.window) if in_layout == "canon" else x
    y = block_wm_plain(p, xs, geom, delta, canon_add, ids, gelu_tanh, drop)
    return from_window_major(y, geom.window) if out_layout == "canon" else y


def block_wm_canon(p, x, geom: StageGeometry, delta: Offset, canon_add: int,
                   ids: Optional[torch.Tensor], gelu_tanh: bool, *,
                   in_layout: str = "wm", out_layout: str = "wm",
                   drop: Optional[torch.Tensor] = None):
    """A stage end-point block.  ``in_layout="canon"``: ``x`` is the
    (B, Z, Hp, W, C) grid in canonical coordinates, latitude-padded to Hp,
    and the block is unshifted; ``out_layout="canon"``: the output is that
    grid in the block's own window coordinates (the stage rolls back once).
    At least one end is canonical.  ``drop``: (B, 2) float32 branch scales
    or None, as in ``block_wm``.  The CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    in_canon, out_canon = in_layout == "canon", out_layout == "canon"
    if not (in_canon or out_canon) or {in_layout, out_layout} - {"wm", "canon"}:
        raise ValueError(f"block_wm_canon: layouts {in_layout!r} -> "
                         f"{out_layout!r}")
    if in_canon and tuple(delta) != (0, 0, 0):
        raise ValueError("block_wm_canon: canonical entry blocks are unshifted")
    wz, wh, ww = geom.window
    b, c = x.shape[0], x.shape[-1]
    z, hp, w = x.shape[1:4] if in_canon else wm_extent(x, geom.window)
    check_shard_read((z, hp, w), geom, delta, "block_wm_canon")
    if not x.is_cuda:
        return block_wm_canon_plain(p, x, geom, delta, canon_add, ids,
                                    gelu_tanh, in_layout, out_layout, drop)
    shape = ((b, z, hp, w, c) if out_canon else
             (b, z // wz, hp // wh, w // ww, wz * wh * ww, c))
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    launch_block(p, x, out, geom, delta, canon_add, ids, gelu_tanh, 1,
                 in_canon, out_canon, "block_wm_canon", drop)
    block_wm_canon.launches += 1
    return out


block_wm_canon.launches = 0


# ---------------------------------------------------------------------------
# A stage chain on wm storage
# ---------------------------------------------------------------------------

def _lon_shift_wm(xs, dw: int, ww: int, mesh=None):
    """Global longitude shift on window-major storage: canonical window
    token w' reads storage token w' + dw (the wm form of
    ``torch.roll(canonical, -dw, dims=W)``).  Rows whose in-window lon
    w_loc < ww - dw shift within their window; the rest spill to the lon
    NEIGHBOUR window, which under a longitude-sharded mesh (sp > 1) lives
    on the next rank: the neighbour rotate is then a one-window-column
    ``Mesh.ppermute`` halo instead of a local roll (which would wrap at the
    shard's edge)."""
    if dw == 0:
        return xs
    n = xs.shape[4]
    w_in_run = (torch.arange(n, device=xs.device) % ww).reshape(n, 1)
    sharded = mesh is not None and mesh.shape["sp"] > 1

    def lon_rotate(x, step: int):
        # storage window l reads window l + step (step in {-1, +1})
        if not sharded:
            return torch.roll(x, -step, dims=3)
        if step > 0:
            halo = mesh.ppermute(x[:, :, :, :1], "sp", 1)
            return torch.cat([x[:, :, :, 1:], halo], dim=3)
        halo = mesh.ppermute(x[:, :, :, -1:], "sp", -1)
        return torch.cat([halo, x[:, :, :, :-1]], dim=3)

    if dw > 0:
        xn = lon_rotate(xs, 1)
        return torch.where(w_in_run < ww - dw, torch.roll(xs, -dw, dims=4),
                           torch.roll(xn, ww - dw, dims=4))
    xp = lon_rotate(xs, -1)
    return torch.where(w_in_run >= -dw, torch.roll(xs, -dw, dims=4),
                       torch.roll(xp, -(ww + dw), dims=4))


def _z_shift_wm(xs, dz: int, wz: int, mesh=None):
    """Global Z shift on window-major storage: canonical window z-row rz
    reads storage z token wz*zz + rz + dz (the wm form of
    ``torch.roll(canonical, -dz, dims=Z)``; the wrap is masked by the region
    ids).  N is (z, lat, lon)-major, so the two z-halves of every window
    move as whole N/2 chunks: for dz = +1 the new first half is the
    window's own second half and the new second half the NEXT z-window's
    first half, which under a z-window-sharded mesh (tp > 1) lives on the
    next rank: a one-z-row ``Mesh.ppermute`` halo."""
    if dz == 0:
        return xs
    if wz != 2 or dz not in (-1, 1):
        raise ValueError(f"_z_shift_wm takes wz 2 and dz +-1, not {wz}, {dz}")
    half = xs.shape[4] // 2
    lo, hi = xs[:, :, :, :, :half], xs[:, :, :, :, half:]
    sharded = mesh is not None and mesh.shape["tp"] > 1

    def z_rotate(x, step: int):
        # storage z-window zz reads window zz + step (step in {-1, +1})
        if not sharded:
            return torch.roll(x, -step, dims=1)
        if step > 0:
            halo = mesh.ppermute(x[:, :1], "tp", 1)
            return torch.cat([x[:, 1:], halo], dim=1)
        halo = mesh.ppermute(x[:, -1:], "tp", -1)
        return torch.cat([halo, x[:, :-1]], dim=1)

    if dz > 0:
        return torch.cat([hi, z_rotate(lo, 1)], dim=4)
    return torch.cat([z_rotate(hi, -1), lo], dim=4)


def run_stage_wm(stage_params, x, geom: StageGeometry, *,
                 gelu_tanh: bool = False, kernels: bool = True,
                 io_layout: str = "wm", lat_group: int = 1, mesh=None):
    """Run one EarthSpecificLayer in window-major whole-block kernels.

    ``io_layout="wm"``: ``x`` is wm entry storage in canonical coordinates
    (as written by the embed or ``ops/updown_wm``); returns the ROLLED
    storage and its offset ``(xs, off)`` for the consumer to fold into its
    reads.  ``io_layout="canon"``: ``x`` is the canonical (B, Z, H, W, C)
    grid; the first block reads it (zero lat padding added here) and the
    last writes it in its own window coordinates, and one roll by ``off``
    plus a crop to H returns the canonical grid.

    Blocks alternate unshifted / shifted by half a window; each writes in
    its own window coordinates, and the next reads through ``delta = target
    - off``.  Interior wm -> wm blocks take ``gh = _pick_gh(nlat,
    lat_group)`` latitude windows per attention program when gh > 1.
    ``kernels=False`` runs the plain versions on any device (the reference
    the card's kernels are held against).

    Under a ``mesh`` (``parallel.mesh.Mesh``) with sp > 1, ``x`` is this
    rank's longitude shard: the lon component of each block's shift runs
    as a storage-level ``_lon_shift_wm`` (a one-window-column halo) before
    the block, and the block keeps the z / lat stitch.  With tp > 1 it is
    also the rank's z-window shard: the z component runs as
    ``_z_shift_wm`` (a one-z-row halo), and each rank takes its own
    ``ntype / tp`` rows of the region ids (the bias tables come sliced
    alike, ``parallel.sharding.shard_params``).  The returned ``off`` then
    has lon and z components 0: the stage hands its consumer a lon- and
    z-canonical shard, which it reads without crossing shards.
    ``io_layout="canon"`` (the JAX package's ``run_stage_wm_sharded``)
    shards longitude only: the first block reads the canonical shard
    unshifted, and the closing roll is z and latitude locally, then a
    canonical longitude halo (``parallel.sharding.grid_roll``)."""
    if io_layout not in ("wm", "canon"):
        raise ValueError(f"io_layout must be 'wm' or 'canon', not {io_layout!r}")
    wz, wh, ww = geom.window
    wm_io = io_layout == "wm"
    sp_sharded = mesh is not None and mesh.shape["sp"] > 1
    tp_sharded = mesh is not None and mesh.shape["tp"] > 1
    if tp_sharded and not wm_io:
        raise ValueError("a canonical-io stage shards longitude only: run "
                         "it under a view with tp collapsed")
    if not wm_io:
        h = x.shape[2]
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, geom.h_padded - h))
    half = (wz // 2, wh // 2, ww // 2)
    off = (0, 0, 0)
    ids = None
    gh = _pick_gh(geom.h_padded // wh, lat_group)
    blocks = stage_params["blocks"]
    for j, bp in enumerate(blocks):
        shifted = j % 2 == 1
        target = half if shifted else (0, 0, 0)
        delta = tuple(t - o for t, o in zip(target, off))
        if shifted and ids is None:
            # defined on the global grid; a z shard takes its own rows
            ids = torch.as_tensor(
                window_region_ids(geom.z, geom.h_padded, geom.window),
                device=x.device)
            if tp_sharded:
                ids = shard(ids, ("tp", None), mesh)
        if sp_sharded and delta[2]:
            x = _lon_shift_wm(x, delta[2], ww, mesh)
            delta = (delta[0], delta[1], 0)
        if tp_sharded and delta[0]:
            x = _z_shift_wm(x, delta[0], wz, mesh)
            delta = (0, delta[1], delta[2])
        args = (bp, x, geom, delta, target[1], ids if shifted else None,
                gelu_tanh)
        in_l = "wm" if (wm_io or j > 0) else "canon"
        out_l = "wm" if (wm_io or j < len(blocks) - 1) else "canon"
        if in_l == "canon" or out_l == "canon":
            x = (block_wm_canon(*args, in_layout=in_l, out_layout=out_l)
                 if kernels else block_wm_canon_plain(*args, in_l, out_l))
        elif not kernels:
            x = block_wm_plain(*args)
        elif gh > 1:
            x = block_wm_group(*args, gh)
        else:
            x = block_wm(*args)
        off = target
    if wm_io:
        if sp_sharded and off[2]:
            x = _lon_shift_wm(x, -off[2], ww, mesh)
            off = (off[0], off[1], 0)
        if tp_sharded and off[0]:
            x = _z_shift_wm(x, -off[0], wz, mesh)
            off = (0, off[1], off[2])
        return x, off
    return grid_roll(x, off, mesh)[:, :, :h].contiguous()

"""Whole blocks on the rolled-coordinate token grid: the counterpart of
``pangu_tpu/ops/earth_block_fused.py`` (``_block_v2_call``,
``_block_v2_train_core``, ``run_stage_fused`` and ``run_stage_train`` on one
device, ``stage_supports_fused``), the trunk of ``block_layout="v2"``.

A stage keeps the (B, Z, Hp, W, C) grid, latitude-padded to Hp, between its
blocks.  Block j reads the grid through its shift ``delta = target - off``
(window token p reads grid row p + delta, each coordinate modulo its extent),
zeroes the rows whose canonical latitude (row + canon_add) % Hp is padding,
and writes its output in its own window coordinates, so the stage carries
the offset ``off`` of its last block and rolls back once at its end.  The
JAX kernel's BlockSpec chunk stitches and in-VMEM rotate are the modular
gather of the port's block kernel (``csrc/block_wm.cu`` with a grid input
and output).

  * ``block_v2``: one whole block (attention and the tail), the CUDA block
    kernel on a CUDA tensor (with its own ``launches`` count), its plain
    version on a CPU tensor; ``drop`` carries the training block's
    per-sample stochastic-depth scales;
  * ``run_stage_fused``: a served stage, canonical (B, Z, H, W, C) in and
    out, any depth;
  * ``run_stage_train``: the training stage, one ``torch.autograd.Function``
    per block (JAX's per-block ``custom_vjp``): forward ``block_v2`` with the
    block's scales, saving only the block's input; backward the recompute of
    the block through ``GridAttention`` (``ops/window_attention``: the grid
    attention kernel forward; backward its backward kernel, or with
    ``grid_bwd="xla"`` the sdpa kernels through the reference composition)
    and the plain tail by autograd, as the JAX package takes ``jax.vjp`` of
    its reference composition (XLA tail, Pallas attention);
  * ``stage_supports_fused``: False for a stage with LoRA leaves on a
    block, which ``models/pangu.py`` runs block by block instead.

Under a (dp, sp) view of a mesh (``run_stage_fused`` / ``run_stage_train``
with ``mesh=``, the JAX package's ``run_stage_fused_sharded`` /
``run_stage_train_sharded``) the grid is this rank's longitude shard of
whole windows: the longitude component of each block's shift runs as a
canonical-storage halo (``parallel.sharding.lon_shift``, a
``Mesh.ppermute`` whose backward is the opposite rotate) before the block,
which keeps the z and latitude components; the closing roll is z and
latitude locally, then a longitude halo.  ``block_v2`` takes the shard's
local extent and raises where its shift would read across shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from pangu_tpu_torch.config import StageGeometry
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops.block_tail import tail_math
from pangu_tpu_torch.ops.earth_block_bwd import (BLOCK_LEAVES, _get, _schedule,
                                                 _tree)
from pangu_tpu_torch.models.lora import has_lora
from pangu_tpu_torch.ops.earth_block_wm import (Offset, check_shard_read,
                                                drop_scales, launch_block,
                                                pad_rows_zeroed, params_in)
from pangu_tpu_torch.ops.window_attention import (GridAttention,
                                                  grid_attention_plain)
from pangu_tpu_torch.parallel.sharding import grid_roll, lon_shift, lon_view


def _block_ref(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
               ids: Optional[torch.Tensor], gelu_tanh: bool, drop, attend):
    """Roll into window coordinates, zero the pad rows, attention through
    ``attend(x, q, ids)``, then the tail (``_block_v2_train_core.ref``)."""
    x = xs
    if any(delta):
        x = torch.roll(x, shifts=tuple(-d for d in delta), dims=(1, 2, 3))
    x = pad_rows_zeroed(x, geom, canon_add)
    q = params_in(p, x.dtype)
    a = attend(x, q, ids)
    return tail_math(a, x, q, gelu_tanh, *drop_scales(drop, x.dim()))


def _attention_args(q):
    at = q["attn"]
    return (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
            at["proj"]["bias"], at["bias_table"])


def block_v2_plain(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
                   ids: Optional[torch.Tensor], gelu_tanh: bool,
                   drop: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the v2 block (any device)."""
    def attend(x, q, ids):
        return grid_attention_plain(x, *_attention_args(q), geom.window, ids)

    return _block_ref(p, xs, geom, delta, canon_add, ids, gelu_tanh, drop,
                      attend)


def block_v2(p, xs, geom: StageGeometry, delta: Offset, canon_add: int,
             ids: Optional[torch.Tensor], gelu_tanh: bool,
             drop: Optional[torch.Tensor] = None):
    """One whole Earth-specific block on the (B, Z, Hp, W, C) grid ``xs``,
    read through ``delta``, written in the block's window coordinates.
    ``canon_add``: the latitude offset from window to canonical coordinates
    (pad rows are those whose canonical latitude is >= the real count);
    ``ids``: (ntype, N) region ids of a shifted block, else None; ``drop``:
    (B, 2) float32 branch scales (training) or None.  The CUDA block kernel
    for a CUDA tensor, the plain version for a CPU tensor.  On a longitude
    shard of the grid a shift with a longitude component raises (it would
    read across shards)."""
    check_shard_read(xs.shape[1:4], geom, delta, "block_v2")
    if not xs.is_cuda:
        return block_v2_plain(p, xs, geom, delta, canon_add, ids, gelu_tanh,
                              drop)
    out = launch_block(p, xs, torch.empty_like(xs), geom, delta, canon_add,
                       ids, gelu_tanh, 1, True, True, "block_v2", drop)
    block_v2.launches += 1
    return out


block_v2.launches = 0


def stage_supports_fused(stage_params) -> bool:
    """False where a block carries LoRA leaves: the whole-block kernels take
    plain dense layers only, and the caller runs the stage block by block
    (``models/pangu.py::run_stage_blocks``)."""
    return not any(has_lora(bp) for bp in stage_params["blocks"])


def _fused_only(stage_params, what: str) -> None:
    if not stage_supports_fused(stage_params):
        raise ValueError(f"{what}: LoRA leaves on a block; such a stage runs "
                         "block by block (models/pangu.py::run_stage_blocks)")


def _region_ids(geom: StageGeometry, device):
    return torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                             geom.window), device=device)


def _padded(x, geom: StageGeometry):
    pad = geom.h_padded - x.shape[2]
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))


def _lon_halo(xs, delta: Offset, mesh):
    """Under a lon-sharded ``mesh``, the longitude component of ``delta`` as
    a storage halo; returns the grid and the delta the block keeps."""
    if mesh is None or not delta[2]:
        return xs, delta
    return lon_shift(xs, delta[2], mesh), (delta[0], delta[1], 0)


def _canonical(xs, off: Offset, h: int, mesh=None):
    """The stage's last block output -> the canonical grid: roll back by the
    offset (on a lon shard: z and latitude locally, then a longitude halo)
    and crop the latitude padding."""
    return grid_roll(xs, off, mesh)[:, :, :h].contiguous()


def run_stage_fused(stage_params, x, geom: StageGeometry, *,
                    gelu_tanh: bool = False, kernels: bool = True,
                    mesh=None):
    """One served EarthSpecificLayer on the canonical (B, Z, H, W, C) grid
    through ``block_v2``: pad, the block chain in rolled coordinates, one
    roll back and a crop.  ``kernels=False`` runs the plain version.
    ``mesh``: a (dp, sp) view whose sp shard ``x`` is (longitude halos
    before the blocks, as the module says)."""
    _fused_only(stage_params, "run_stage_fused")
    mesh = lon_view(mesh)
    sched, off = _schedule(geom, len(stage_params["blocks"]))
    ids = _region_ids(geom, x.device)
    block = block_v2 if kernels else block_v2_plain
    xs = _padded(x, geom)
    for bp, (delta, canon_add, shifted) in zip(stage_params["blocks"], sched):
        xs, delta = _lon_halo(xs, delta, mesh)
        xs = block(bp, xs.contiguous(), geom, delta, canon_add,
                   ids if shifted else None, gelu_tanh)
    return _canonical(xs, off, x.shape[2], mesh)


class _BlockTrain(torch.autograd.Function):
    """One block: ``block_v2`` forward saving only its input; backward the
    recompute through ``GridAttention`` (its backward by ``grid_bwd``) and
    the plain tail, differentiated with ``torch.autograd.grad``
    (recompute-in-backward, as ``jax.checkpoint``)."""

    @staticmethod
    def forward(ctx, meta, xs, *leaves):
        geom, delta, canon_add, ids, drop, gelu_tanh, kernels, _ = meta
        ctx.meta = meta
        ctx.save_for_backward(xs, *leaves)
        block = block_v2 if kernels else block_v2_plain
        return block(_tree(leaves), xs, geom, delta, canon_add, ids,
                     gelu_tanh, drop)

    @staticmethod
    def backward(ctx, g):
        geom, delta, canon_add, ids, drop, gelu_tanh, kernels, grid_bwd = \
            ctx.meta

        def attend(x, q, ids):
            return GridAttention.apply((geom.window, ids, kernels, grid_bwd),
                                       x, *_attention_args(q))

        with torch.enable_grad():
            xs, *leaves = (t.detach().requires_grad_(True)
                           for t in ctx.saved_tensors)
            y = _block_ref(_tree(leaves), xs, geom, delta, canon_add, ids,
                           gelu_tanh, drop, attend)
            grads = torch.autograd.grad(y, [xs, *leaves], g)
        return (None, *grads)


def run_stage_train(stage_params, x, geom: StageGeometry,
                    drops: Optional[list], *, gelu_tanh: bool = False,
                    kernels: bool = True, grid_bwd: str = "pallas",
                    mesh=None):
    """Training forward of one EarthSpecificLayer on the canonical grid,
    differentiable in ``x`` and every block parameter: the served stage's
    chain with one autograd Function per block.  ``drops``: one (B, 2)
    float32 tensor of branch scales per block, or None; ``grid_bwd``: the
    grid attention's backward in the recompute ("pallas" | "xla").
    ``mesh``: a (dp, sp) view whose shard ``x`` is, ``drops`` its dp rows;
    the longitude halos sit between the block Functions, differentiable."""
    _fused_only(stage_params, "run_stage_train")
    mesh = lon_view(mesh)
    blocks = stage_params["blocks"]
    sched, off = _schedule(geom, len(blocks))
    ids = _region_ids(geom, x.device)
    xs = _padded(x, geom)
    for j, (bp, (delta, canon_add, shifted)) in enumerate(zip(blocks, sched)):
        xs, delta = _lon_halo(xs, delta, mesh)
        drop = None if drops is None else drops[j].to(x.device)
        meta = (geom, delta, canon_add, ids if shifted else None, drop,
                gelu_tanh, kernels, grid_bwd)
        xs = _BlockTrain.apply(meta, xs.contiguous(),
                               *(_get(bp, path) for path in BLOCK_LEAVES))
    return _canonical(xs, off, x.shape[2], mesh)

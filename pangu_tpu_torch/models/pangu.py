"""Top-level Pangu-Weather model of the port: parameter init and the served
forward.  The counterpart of ``pangu_tpu/models/pangu.py`` (``init_params``,
``forward_core_wm``, the window-major branches of ``forward`` with and
without the edge kernels, the canonical-layout ``forward_core`` /
``_run_stage`` that ``forward(taps=...)`` runs, ``param_count``).

embed -> enc(2 blocks @192) -> skip -> downsample -> enc(6 @384) ->
dec(6 @384) -> upsample -> dec(2 @192) -> [skip | dec] -> recover, with the
trunk in window-major storage: stage chains keep wm storage between blocks,
DownSample / UpSample read the rolled storage directly.  Without the edge
kernels the canonical token grid exists after the embed and before the
recovery; with ``cfg.edge_kernels`` the embed writes wm storage and the
recovery reads the rolled pair, so it never exists.

Under a (dp, sp, tp) mesh of ``torch.distributed`` ranks
(``parallel.sharding.use_mesh``) a call takes one of two routes
(:func:`serving_mesh`).  The window-major route, where the tree and config
run that trunk and the gate takes the mesh (:func:`wm_core_mesh`), runs it
per shard: patch embed of the rank's dp slice, its (tp, sp) share of the
tokens (:func:`embed_shard`), the stage chains with their lon / z halos,
then the pair gathered, patch recovery and the batch gathered
(:func:`recover_shard`); trained, :func:`forward_core_wm_train` with the
mesh.  Everything else (v2, odd depths, unmerged LoRA, ``attn_impl="xla"``,
``train_fused=False``, taps, a mesh the gate refuses) takes the
canonical-layout route, the JAX package's ``forward_core`` under a mesh:
the canonical trunk (:func:`forward_core` with ``mesh=``) on the rank's
(dp, sp) shard of the canonical grid, under one view of the mesh with tp
collapsed, sp collapsed where it does not divide every stage's longitude
windows (``parallel.sharding.canon_view``).  On both routes dp is
collapsed where it does not divide the batch.  Trained, the stochastic-
depth scales are drawn at the global batch and cut to the rank's dp rows,
and the gradient is summed over the view the forward ran under by
``parallel.sharding.reduce_grads`` (``engine/train.py``).

``forward(..., taps=dict)`` runs the canonical-layout trunk instead, as the
JAX package does when it collects golden activations: each stage reads and
writes the canonical (B, Z, H, W, C) grid (end-point blocks in canon
layout), with the canonical DownSample / UpSample kernels between them, and
every stage boundary lands in ``taps``.

``forward(..., deterministic=False)`` is the training forward, differentiable
in every parameter: ``forward_core_wm_train`` (one autograd Function per
stage call, the block kernels with per-sample stochastic-depth scales
forward, the block backward kernel backward) between the differentiable edge
(``embed_wm_train`` / ``recovery_wm_train`` with ``cfg.edge_kernels``, else
patch embed and patch recovery by autograd).

With ``cfg.block_layout="v2"`` every forward, served and trained, runs patch
embed, the canonical-layout trunk (:func:`forward_core`) and patch recovery:
each stage is a chain of rolled-coordinate grid blocks
(``ops/earth_block_fused``) with the canonical DownSample / UpSample kernels
between them, stages 1 and 2 one chain where stage 1's depth is even.

``cfg.attn_impl="xla"`` (the JAX package's default) runs that canonical
path with the plain layers only: ``L.earth_block`` block by block and
``L.down_sample`` / ``L.up_sample``, no kernel on any device.  Odd stage
depths under ``block_layout="wm"`` take the canonical path too (a stage
ends unshifted after an odd depth, so skip and decoder would not share an
offset): served, each stage is ``run_stage_wm(io_layout="canon")``;
trained, ``run_stage_train_wm(io_in="canon", io_out="canon")``, whose
first and last blocks read and write the canonical grid.

LoRA and the per-block path, as the JAX package routes them: under
``cfg.lora_fused`` ``forward`` first merges LoRA factors into the kernels
where that is exact (served, or trained without element-mode dropout;
feature-mode masks folded in), so the fused trunks run.  Unmerged LoRA
leaves anywhere on the trunk (:func:`wm_core_supported` fails), or training
with ``cfg.train_fused=False``, take the same canonical path as ``v2``: each
stage runs fused where ``stage_supports_fused`` holds (and training is
fused), else block by block (:func:`run_stage_blocks`, ``L.earth_block``);
DownSample / UpSample run their kernels unless their dense sites carry LoRA
leaves (then ``L.down_sample`` / ``L.up_sample``).
"""

from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.data.constants import to_device
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.models.lora import (has_lora, has_lora_dropout,
                                         merge_lora, strip_lora)
from pangu_tpu_torch.ops.earth_block_bwd import run_stage_train_wm
from pangu_tpu_torch.ops.earth_block_fused import (run_stage_fused,
                                                   run_stage_train,
                                                   stage_supports_fused)
from pangu_tpu_torch.ops.embed_wm import (embed_wm, embed_wm_plain,
                                          embed_wm_train)
from pangu_tpu_torch.ops.recovery_wm import (recovery_wm, recovery_wm_plain,
                                             recovery_wm_train)
from pangu_tpu_torch.ops.earth_block_wm import (run_stage_wm, to_window_major,
                                                wm_to_canonical)
from pangu_tpu_torch.ops.updown import (down_sample, down_sample_plain,
                                        down_sample_train, up_sample,
                                        up_sample_plain, up_sample_train)
from pangu_tpu_torch.ops.updown_wm import (down_sample_wm,
                                           down_sample_wm_plain,
                                           down_sample_wm_train, up_sample_wm,
                                           up_sample_wm_plain,
                                           up_sample_wm_train)
from pangu_tpu_torch.parallel import sharding


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device: _device.DeviceLike = "cuda"):
    """The full parameter tree, with the JAX package's shapes and key paths:
    trunc-normal (std 0.02, cut at 2 std) dense kernels and bias tables, zero
    biases, unit LayerNorm.  Values are drawn on the generator's device, in
    ``cfg.param_dtype``, then moved to ``device``."""
    dev = _device.resolve(device)
    dtype = _device.dtype_of(cfg.param_dtype)

    def trunc(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)
        return t.to(dev, dtype)

    def dense(d_in, d_out, bias=True):
        p = {"kernel": trunc(d_in, d_out)}
        if bias:
            p["bias"] = torch.zeros(d_out, dtype=dtype, device=dev)
        return p

    def norm(dim):
        return {"scale": torch.ones(dim, dtype=dtype, device=dev),
                "bias": torch.zeros(dim, dtype=dtype, device=dev)}

    params = {
        "patch_embed": {
            "upper": dense(cfg.upper_patch_features, cfg.dims[0]),
            "surface": dense(cfg.surface_patch_features, cfg.dims[0]),
        },
        "stages": [],
    }
    for i in range(4):
        g = cfg.stage(i)
        n = g.window_tokens
        params["stages"].append({"blocks": [{
            "norm1": norm(g.dim),
            "norm2": norm(g.dim),
            "attn": {
                "qkv": dense(g.dim, 3 * g.dim),
                "proj": dense(g.dim, g.dim),
                "bias_table": trunc(g.num_window_types, g.heads, n, n),
            },
            "mlp": {
                "fc1": dense(g.dim, cfg.mlp_ratio * g.dim),
                "fc2": dense(cfg.mlp_ratio * g.dim, g.dim),
            },
        } for _ in range(g.depth)]})

    c0 = cfg.dims[0]
    params["downsample"] = {"norm": norm(4 * c0),
                            "reduce": dense(4 * c0, 2 * c0, bias=False)}
    params["upsample"] = {"expand": dense(cfg.dims[2], 4 * cfg.dims[3], bias=False),
                          "norm": norm(cfg.dims[3]),
                          "mix": dense(cfg.dims[3], cfg.dims[3], bias=False)}
    pz, ph, pw = cfg.patch
    params["patch_recovery"] = {
        "upper": dense(2 * cfg.dims[3], cfg.upper_vars * pz * ph * pw),
        "surface": dense(2 * cfg.dims[3], cfg.surface_vars * ph * pw),
    }
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def summarize(params, cfg: ModelConfig) -> str:
    """Parameter counts by top-level group and stage, with the model's
    geometry (the JAX package's ``summarize``)."""
    lines = [f"PanguModel ({cfg.lat}x{cfg.lon}, {cfg.levels} levels, "
             f"dims {cfg.dims}, depths {cfg.depths})"]
    groups = {}
    for key, sub in params.items():
        if key == "stages":
            for i, st in enumerate(sub):
                groups[f"stage[{i}]"] = param_count(st)
        else:
            groups[key] = param_count(sub)
    total = sum(groups.values())
    for key, n in groups.items():
        lines.append(f"  {key:<16} {n:>12,} params "
                     f"({100 * n / max(total, 1):.1f}%)")
    lines.append(f"  total            {total:>12,} params")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def wm_core_supported(params, cfg: ModelConfig) -> bool:
    """True where the all-window-major trunk applies: ``attn_impl="pallas"``,
    ``block_layout="wm"``, even stage depths (so every stage ends at the
    same half-window offset) and no LoRA leaves on any block, ``reduce``,
    ``expand`` or ``mix`` (the JAX package's gate on one device)."""
    return (cfg.attn_impl == "pallas" and cfg.block_layout == "wm"
            and not any(d % 2 for d in cfg.depths)
            and all(stage_supports_fused(sp) for sp in params["stages"])
            and not any("lora_a" in p for p in (
                params["downsample"]["reduce"], params["upsample"]["expand"],
                params["upsample"]["mix"])))


def _require_wm_core(params, cfg: ModelConfig) -> None:
    if not wm_core_supported(params, cfg):
        raise ValueError("the window-major trunk takes attn_impl='pallas', "
                         "block_layout='wm', even depths and no LoRA leaves "
                         "on the trunk; forward routes other trees through "
                         "forward_core")


def forward_core_wm(params, xs, cfg: ModelConfig, *, mesh=None,
                    kernels: bool = True):
    """The encoder/decoder trunk entirely in window-major storage.  ``xs``:
    stage-0 wm entry storage in canonical coordinates (B, nz, nlat, nlon, N,
    C).  Returns ``(skip_wm, dec_wm, off)``, the pre-recovery pair, each
    still rolled by ``off``.  ``kernels=False`` runs every kernel's plain
    version instead, on any device.

    Under a ``mesh`` (gated by :func:`wm_core_mesh`) ``xs`` is this rank's
    (tp, sp) shard and ``params`` carry its tp slice of the bias tables: the
    stage chains resolve the lon (sp > 1) and z (tp > 1) components of the
    shifts through halo exchanges, so ``off`` has those components 0 and
    DownSample / UpSample read their shard alone."""
    _require_wm_core(params, cfg)
    g0, g1, g2, g3 = (cfg.stage(i) for i in range(4))
    down = down_sample_wm if kernels else down_sample_wm_plain
    up = up_sample_wm if kernels else up_sample_wm_plain
    kw = dict(gelu_tanh=cfg.gelu_tanh, kernels=kernels,
              lat_group=cfg.lat_group, mesh=mesh)

    skip, off0 = run_stage_wm(params["stages"][0], xs, g0, **kw)
    x = down(params["downsample"], skip, g0, g1, off0)
    combined = {"blocks": (list(params["stages"][1]["blocks"])
                           + list(params["stages"][2]["blocks"]))}
    x, off12 = run_stage_wm(combined, x, g1, **kw)
    x = up(params["upsample"], x, g2, g3, off12)
    dec, off3 = run_stage_wm(params["stages"][3], x, g3, **kw)
    if off0 != off3:
        raise AssertionError("even depths keep skip and decoder in step")
    return skip, dec, off3


# ---------------------------------------------------------------------------
# Serving under a (dp, sp, tp) mesh
# ---------------------------------------------------------------------------

def wm_core_mesh(cfg: ModelConfig, mesh):
    """``mesh`` where the all-window-major trunk can run per (dp, sp, tp)
    shard: sp divides every stage's longitude windows and, when tp > 1, tp
    divides every stage's z windows (the tp axis shards z windows, and with
    them the z-type-major bias tables).  None without a mesh, for a mesh
    of one rank, or where the gate refuses the mesh."""
    if mesh is None or mesh.size == 1:
        return None
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    wz, _, ww = cfg.window
    if any((cfg.stage(i).w // ww) % sp for i in range(4)):
        return None
    if tp > 1 and any(cfg.stage(i).z % wz or (cfg.stage(i).z // wz) % tp
                      for i in range(4)):
        return None
    return mesh


def _merges(params, cfg: ModelConfig, train: bool) -> bool:
    """True where ``forward`` merges the LoRA factors into the kernels
    first: ``attn_impl="pallas"`` under ``cfg.lora_fused``, served, or
    trained without element-mode dropout (which has no merged form)."""
    return (cfg.attn_impl == "pallas" and cfg.lora_fused and has_lora(params)
            and (not train or not has_lora_dropout(params)))


def _runs_wm_core(params, cfg: ModelConfig, train: bool) -> bool:
    """True where ``forward`` runs the window-major trunk: the tree, once
    merged where it merges, passes :func:`wm_core_supported`, and a
    training call trains fused."""
    tree = strip_lora(params) if _merges(params, cfg, train) else params
    return (wm_core_supported(tree, cfg)
            and (not train or cfg.train_fused))


def lon_windows(cfg: ModelConfig):
    """Each stage's longitude window count."""
    return [cfg.stage(i).w // cfg.window[2] for i in range(4)]


# forward's default ``routed``: the route is taken by forward itself
DECIDE = "decide"


def serving_mesh(params, cfg: ModelConfig, batch: int, *,
                 train: bool = False, canonical: bool = False):
    """How a call of a ``batch``-sample batch is served (``train``: trained)
    under the active mesh (``parallel.sharding.use_mesh``): ``(route,
    view)``, or None where it runs as on one device (no mesh, or a view of
    one rank, whose ranks each compute the whole call).

    ``"wm"``: the window-major trunk per (dp, sp, tp) shard, under the
    mesh, or with dp collapsed where dp does not divide the batch
    (``parallel.sharding.serving_view``); taken where the tree and config
    run that trunk (:func:`wm_core_supported` after the merge; trained:
    ``cfg.train_fused``) and the gate takes the view (:func:`wm_core_mesh`).

    ``"canon"``: the canonical-layout trunk per (dp, sp) shard
    (:func:`forward_core` with the view), everywhere else, and where the
    caller asks for the canonical grid (``canonical``: taps, a trajectory,
    the hierarchy): under ``parallel.sharding.canon_view`` (tp collapsed,
    sp where it does not divide every stage's longitude windows, dp where
    it does not divide the batch).  Its collapsed axes replicate the work,
    so the gradient is summed over the view alone
    (``parallel.sharding.reduce_grads``)."""
    mesh = sharding.active_mesh()
    if mesh is None or mesh.size == 1:
        return None
    view = sharding.serving_view(mesh, batch)
    if (not canonical and _runs_wm_core(params, cfg, train)
            and wm_core_mesh(cfg, view) is not None):
        return "wm", view
    view = sharding.canon_view(mesh, lon_windows(cfg), batch)
    return None if view.size == 1 else ("canon", view)


def mesh_params(params, cfg: ModelConfig, mesh, *, copy: bool = True):
    """``params`` with this rank's tp slice of the bias tables: sliced here
    where they are whole (``parallel.sharding.shard_params``: a copy, or
    with ``copy=False`` a view the gradient reaches the whole table
    through), as they are where already sliced."""
    t = params["stages"][0]["blocks"][0]["attn"]["bias_table"]
    whole = cfg.stage(0).num_window_types
    if t.shape[0] == whole:
        return sharding.shard_params(params, mesh, copy=copy)
    if t.shape[0] * mesh.shape["tp"] == whole:
        return params
    raise ValueError(f"bias table of {t.shape[0]} types for {whole} over tp "
                     f"{mesh.shape['tp']}")


def embed_shard(params, upper, surface, constants, cfg: ModelConfig, mesh):
    """Physical fields (the whole batch, compute dtype, on the rank's
    device) -> this rank's stage-0 wm entry storage: patch embed of its dp
    slice of the batch, then its (tp, sp) share of the tokens (z and
    longitude are patch-local, so the slice of the embed is exact).
    Differentiable: the embed's gradient comes from this rank's tokens."""
    g = cfg.stage(0)
    x = embed_canon_shard(params, upper, surface, constants, cfg, mesh,
                          sharding.TOKEN_SPEC)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, g.h_padded - x.shape[2]))
    return to_window_major(x, g.window).contiguous()


def recover_shard(params, skip, dec, off, cfg: ModelConfig, mesh):
    """This rank's rolled stage-3 exit pair -> the normalised (upper,
    surface) fields of the whole batch on every rank: each shard
    canonicalised by its own ``off`` (z 0 under tp > 1, lon 0 under
    sp > 1; the local components still applied), gathered over tp and sp,
    patch recovery, then the batch gathered over dp.  Differentiable: the
    gathers' backward hands each rank the cotangent of its own shard."""
    g = cfg.stage(0)
    return recover_canon_shard(
        params, tuple(wm_to_canonical(t, off, g) for t in (skip, dec)), cfg,
        mesh, sharding.TOKEN_SPEC)


def embed_canon_shard(params, upper, surface, constants, cfg: ModelConfig,
                      mesh, spec=sharding.CANON_TOKEN_SPEC):
    """Physical fields (the whole batch) -> this rank's shard of the
    canonical route under the view ``mesh``: patch embed of its dp slice,
    then its share of the tokens under ``spec`` (the longitude shard;
    :func:`embed_shard` passes the window-major route's spec).
    Differentiable."""
    u, s = (sharding.shard(t, sharding.BATCH_SPEC, mesh)
            for t in (upper, surface))
    x = L.patch_embed(params["patch_embed"], u, s, constants, cfg)
    return sharding.shard(x, spec, mesh)


def gather_canon(x, mesh):
    """This rank's shard of a canonical (B, Z, H, W, C) grid -> the whole
    grid of the whole batch on every rank (gathered over sp, then dp)."""
    x = sharding.unshard(x, sharding.CANON_TOKEN_SPEC, mesh)
    return sharding.unshard(x, sharding.BATCH_SPEC, mesh)


def recover_canon_shard(params, pair, cfg: ModelConfig, mesh,
                        spec=sharding.CANON_TOKEN_SPEC):
    """This rank's shard (under ``spec``) of the canonical pre-recovery
    pair -> the normalised (upper, surface) fields of the whole batch on
    every rank: the pair gathered, patch recovery, the batch gathered over
    dp.  Differentiable."""
    pair = tuple(sharding.unshard(t, spec, mesh) for t in pair)
    out = L.patch_recovery(params["patch_recovery"], pair, cfg)
    return tuple(sharding.unshard(t, sharding.BATCH_SPEC, mesh) for t in out)


def _require_whole_tables(params, cfg: ModelConfig) -> None:
    t = params["stages"][0]["blocks"][0]["attn"]["bias_table"]
    if t.shape[0] != cfg.stage(0).num_window_types:
        raise ValueError(f"the canonical route takes whole bias tables, not "
                         f"{t.shape[0]} of {cfg.stage(0).num_window_types} "
                         "types (a tp slice)")


def _stage_drops(n_blocks: int, rates, offset: int, gen, B: int):
    """Per-block (B, 2) float32 stochastic-depth branch scales (timm
    DropPath): for block j at rate r, each sample's scale is 0 with
    probability r and 1/(1 - r) otherwise, drawn from ``gen`` (on its
    device); ones at rate 0 or without a generator."""
    dev = gen.device if gen is not None else torch.device("cpu")
    drops = []
    for j in range(n_blocks):
        rate = rates[offset + j]
        cols = []
        for _ in range(2):
            if gen is None or rate == 0.0:
                cols.append(torch.ones(B, device=dev))
            else:
                keep = 1.0 - rate
                m = torch.bernoulli(torch.full((B,), keep, device=dev),
                                    generator=gen)
                cols.append(m / keep)
        drops.append(torch.stack(cols, dim=1))
    return drops


def draw_drops(cfg: ModelConfig, gen, batch: int):
    """Four per-stage lists of (B, 2) branch scales, stage by stage from one
    generator (``cfg.drop_path_rates()``; ones without a generator): both
    training trunks draw them so, and compute the same loss from one
    seed."""
    rates = cfg.drop_path_rates()
    return [_stage_drops(cfg.depths[i], rates, sum(cfg.depths[:i]), gen,
                         batch) for i in range(4)]


def forward_core_wm_train(params, xs, cfg: ModelConfig, *, gen=None,
                          drops=None, kernels: bool = True, mesh=None):
    """The training trunk in window-major storage, differentiable in ``xs``
    and every trunk parameter: each stage call is one autograd Function
    (block kernels forward, the block backward kernel backward), DownSample
    and UpSample their kernels forward and autograd through the plain
    recompute backward.  ``drops``: four per-stage lists of (B, 2) branch
    scales, or None to draw them from ``gen`` (``cfg.drop_path_rates()``;
    ones without a generator).  Returns ``(skip_wm, dec_wm, off)`` as
    :func:`forward_core_wm` does.

    Under a ``mesh`` ``xs`` is this rank's (tp, sp) shard, ``drops`` its
    dp rows and ``params`` carry its tp slice of the bias tables, as
    :func:`forward_core_wm` serves: the stage chains' halos are
    differentiable, and ``off`` has its lon and z components 0."""
    _require_wm_core(params, cfg)
    g0, g1, g2, g3 = (cfg.stage(i) for i in range(4))
    if drops is None:
        drops = draw_drops(cfg, gen, xs.shape[0])
    kw = dict(gelu_tanh=cfg.gelu_tanh, kernels=kernels, mesh=mesh)

    skip, off0 = run_stage_train_wm(params["stages"][0], xs, g0, drops[0], **kw)
    x = down_sample_wm_train(params["downsample"], skip, g0, g1, off0,
                             kernels=kernels)
    combined = {"blocks": (list(params["stages"][1]["blocks"])
                           + list(params["stages"][2]["blocks"]))}
    x, off12 = run_stage_train_wm(combined, x, g1,
                                  list(drops[1]) + list(drops[2]), **kw)
    x = up_sample_wm_train(params["upsample"], x, g2, g3, off12,
                           kernels=kernels)
    dec, off3 = run_stage_train_wm(params["stages"][3], x, g3, drops[3], **kw)
    if off0 != off3:
        raise AssertionError("even depths keep skip and decoder in step")
    return skip, dec, off3


def run_stage(stage_params, x, cfg: ModelConfig, stage_idx: int, *,
              kernels: bool = True, mesh=None):
    """One served EarthSpecificLayer on the canonical (B, Z, H, W, C) grid,
    as the JAX package's ``_run_stage`` runs it for inference: by
    ``cfg.block_layout``, ``run_stage_wm(io_layout="canon")`` ("wm") or
    ``run_stage_fused`` ("v2"); block by block (:func:`run_stage_blocks`)
    where a block carries LoRA leaves or under ``attn_impl="xla"``.
    ``mesh``: the canonical route's (dp, sp) view, whose shard ``x`` is."""
    if cfg.attn_impl != "pallas" or not stage_supports_fused(stage_params):
        return run_stage_blocks(stage_params, x, cfg, stage_idx,
                                kernels=kernels, mesh=mesh)
    geom = cfg.stage(stage_idx)
    if cfg.block_layout == "v2":
        return run_stage_fused(stage_params, x, geom,
                               gelu_tanh=cfg.gelu_tanh, kernels=kernels,
                               mesh=mesh)
    return run_stage_wm(stage_params, x, geom, gelu_tanh=cfg.gelu_tanh,
                        kernels=kernels, io_layout="canon",
                        lat_group=cfg.lat_group, mesh=mesh)


def _lora_seed(bp, gen):
    """The seed of one block's LoRA dropout generators, drawn from ``gen``;
    None without a generator or a dropout-rate leaf in the block."""
    if gen is None or not (has_lora_dropout(bp)
                           or has_lora_dropout(bp, "lora_drop_feat")):
        return None
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))


def run_stage_blocks(stage_params, x, cfg: ModelConfig, stage_idx: int, *,
                     deterministic: bool = True, drops=None, gen=None,
                     kernels: bool = True, mesh=None):
    """One EarthSpecificLayer block by block on the canonical grid, the JAX
    package's ``_run_stage`` fallback loop: ``L.earth_block`` per block
    (with ``cfg.attn_impl``), unshifted and shifted in turn.  Training
    (``deterministic=False``):
    ``drops`` the blocks' (B, 2) branch scales; each block's LoRA dropout
    seed is drawn from ``gen`` before the block runs, so under
    ``cfg.remat`` the block, recomputed in the backward
    (``torch.utils.checkpoint``), draws the same masks; the grid attention's
    backward is ``cfg.grid_bwd``.  ``mesh``: the canonical route's (dp, sp)
    view, whose shard ``x`` is (``L.earth_block``'s halos and LoRA mask
    cuts)."""
    geom = cfg.stage(stage_idx)
    train = not deterministic
    for j, bp in enumerate(stage_params["blocks"]):
        block = functools.partial(
            L.earth_block, bp, geom=geom, roll=j % 2 == 1,
            drop=None if drops is None else drops[j].to(x.device),
            lora_seed=_lora_seed(bp, gen) if train else None,
            deterministic=deterministic, gelu_tanh=cfg.gelu_tanh,
            kernels=kernels, grid_bwd=cfg.grid_bwd,
            attn_impl=cfg.attn_impl, mesh=mesh)
        if train and cfg.remat:
            x = torch.utils.checkpoint.checkpoint(
                block, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x)
    return x


def forward_core(params, x, cfg: ModelConfig, *, taps=None,
                 kernels: bool = True, deterministic: bool = True, gen=None,
                 drops=None, mesh=None):
    """The encoder/decoder trunk on the canonical embedded grid (B, Z, H, W,
    C): stages, DownSample and UpSample.  Returns the pre-recovery pair
    ``(skip, dec)``, each canonical (B, Z, H, W, C).  ``taps``: a dict that
    receives ``stage0``, ``downsample``, ``stage1``, ``stage2``, ``upsample``
    and ``stage3``; without it stages 1 and 2 run as one chain where stage
    1's depth is even and both run fused (the block parity then runs on),
    as the JAX package merges them.

    Under ``cfg.attn_impl="pallas"`` each stage runs fused where
    ``stage_supports_fused`` holds (served: by layout, :func:`run_stage`;
    trained with ``cfg.train_fused``: one autograd Function per block under
    ``v2`` (``run_stage_train``), the window-major stage Function with
    canonical ends under ``wm`` (``run_stage_train_wm(io_in="canon",
    io_out="canon")``)), else block by block (:func:`run_stage_blocks`).
    DownSample and UpSample run their kernels (trained: the kernel forward
    and the plain recompute backward) unless their dense sites carry LoRA
    leaves.  Under ``"xla"`` every stage runs block by block and DownSample
    / UpSample are ``L.down_sample`` / ``L.up_sample``: no kernel.

    ``deterministic=False``: the training trunk, differentiable in ``x`` and
    every trunk parameter.  ``drops``: four per-stage lists of (B, 2) branch
    scales, or None to draw them from ``gen`` (:func:`draw_drops`); ``gen``
    also draws the LoRA dropout of unmerged adapters.

    ``mesh``: the canonical route's (dp, sp) view (:func:`serving_mesh`),
    as the JAX package runs ``forward_core`` under a mesh: ``x`` is this
    rank's shard (its dp rows, its longitude windows), ``drops`` its dp
    rows; each stage runs on the shard with longitude halos (served fused:
    ``run_stage_fused`` / ``run_stage_wm(io_layout="canon")`` with the
    view; trained fused: ``run_stage_train`` with the view, whatever the
    layout, as the JAX package's ``run_stage_train_sharded``; else block by
    block), DownSample and UpSample on the shard, stages 1 and 2 never
    merged; the pair comes back sharded, and each tap whole (gathered)."""
    train = not deterministic
    if train and taps is not None:
        raise ValueError("taps are collected by the served trunk only")
    if train and drops is None:
        drops = draw_drops(cfg, gen, x.shape[0])
    if not train:
        drops, gen = [None] * 4, None
    stages = params["stages"]

    pallas = cfg.attn_impl == "pallas"

    def fused_ok(sp):
        return (pallas and stage_supports_fused(sp)
                and (not train or cfg.train_fused))

    def tap(name, val):
        if taps is not None:
            taps[name] = val if mesh is None else gather_canon(val, mesh)
        return val

    def stage(sp, xx, i, dr):
        if not train:
            return run_stage(sp, xx, cfg, i, kernels=kernels, mesh=mesh)
        if not fused_ok(sp):
            return run_stage_blocks(sp, xx, cfg, i, deterministic=False,
                                    drops=dr, gen=gen, kernels=kernels,
                                    mesh=mesh)
        geom = cfg.stage(i)
        if cfg.block_layout == "v2" or mesh is not None:
            return run_stage_train(sp, xx, geom, dr, gelu_tanh=cfg.gelu_tanh,
                                   kernels=kernels, grid_bwd=cfg.grid_bwd,
                                   mesh=mesh)
        return run_stage_train_wm(sp, xx, geom, dr, gelu_tanh=cfg.gelu_tanh,
                                  kernels=kernels, io_in="canon",
                                  io_out="canon")

    def down(p, xx):
        if not pallas or "lora_a" in p["reduce"]:
            return L.down_sample(p, xx, gen, mesh)
        if train:
            return down_sample_train(p, xx, kernels=kernels)
        return (down_sample if kernels else down_sample_plain)(p, xx)

    def up(p, xx):
        if not pallas or "lora_a" in p["expand"] or "lora_a" in p["mix"]:
            return L.up_sample(p, xx, cfg.h_tokens, gen, mesh)
        if train:
            return up_sample_train(p, xx, cfg.h_tokens, kernels=kernels)
        return (up_sample if kernels else up_sample_plain)(p, xx,
                                                           cfg.h_tokens)

    x = tap("stage0", stage(stages[0], x, 0, drops[0]))
    skip = x
    x = tap("downsample", down(params["downsample"], x))
    if (taps is None and mesh is None and cfg.depths[1] % 2 == 0
            and fused_ok(stages[1]) and fused_ok(stages[2])):
        combined = {"blocks": (list(stages[1]["blocks"])
                               + list(stages[2]["blocks"]))}
        x = stage(combined, x, 1,
                  None if drops[1] is None else list(drops[1]) + list(drops[2]))
    else:
        x = tap("stage1", stage(stages[1], x, 1, drops[1]))
        x = tap("stage2", stage(stages[2], x, 2, drops[2]))
    x = tap("upsample", up(params["upsample"], x))
    x = tap("stage3", stage(stages[3], x, 3, drops[3]))
    return skip, x


def embed_tokens(params, upper, surface, constants, cfg: ModelConfig, *,
                 kernels: bool = True):
    """Physical fields (compute dtype, on the params' device; ``constants``
    tensors there too) -> stage-0 wm entry storage in canonical coordinates:
    ``embed_wm`` with ``cfg.edge_kernels``, else patch embed, lat pad and the
    wm relayout."""
    if cfg.edge_kernels:
        embed = embed_wm if kernels else embed_wm_plain
        return embed(params["patch_embed"], upper, surface, constants, cfg)
    g = cfg.stage(0)
    x = L.patch_embed(params["patch_embed"], upper, surface, constants, cfg)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, g.h_padded - x.shape[2]))
    return to_window_major(x, g.window)


def recover_fields(params, skip, dec, off, cfg: ModelConfig, *,
                   kernels: bool = True):
    """The rolled stage-3 exit pair -> the normalised (upper, surface)
    fields: ``recovery_wm`` with ``cfg.edge_kernels``, else canonicalise
    and patch recovery."""
    if cfg.edge_kernels:
        recover = recovery_wm if kernels else recovery_wm_plain
        return recover(params["patch_recovery"], skip, dec, off, cfg)
    g = cfg.stage(0)
    return L.patch_recovery(params["patch_recovery"],
                            (wm_to_canonical(skip, off, g),
                             wm_to_canonical(dec, off, g)), cfg)


def forward(params, upper, surface, constants, cfg: ModelConfig, *,
            device: _device.DeviceLike = "cuda", kernels: bool = True,
            taps=None, deterministic: bool = True, gen=None, drops=None,
            routed=DECIDE):
    """Full forward step: upper (B, 5, levels, lat, lon) and surface
    (B, 4, lat, lon) in physical units in, the *normalised* prediction
    (upper, surface) out.  Inputs and constants are moved to ``device``; the
    params must already be there.  With ``cfg.edge_kernels``: embed_wm ->
    trunk -> recovery_wm.

    ``taps``: a dict that receives the canonical activations ``embed``,
    ``stage0``, ``downsample``, ``stage1``, ``stage2``, ``upsample`` and
    ``stage3`` (tensors on ``device``); the step then runs patch embed, the
    canonical-layout trunk (:func:`forward_core`) and patch recovery, as
    the JAX package does when it is given taps.  ``cfg.block_layout="v2"``,
    odd stage depths, ``attn_impl="xla"``, unmerged LoRA leaves on the trunk
    and training with ``cfg.train_fused=False`` run that path too.

    ``cfg.attn_impl="xla"`` runs the canonical path with the plain layers
    only (the JAX package's XLA model): no kernel on any device.

    LoRA: under ``cfg.lora_fused`` and ``attn_impl="pallas"`` the factors
    are merged into the kernels first
    (:func:`~pangu_tpu_torch.models.lora.merge_lora`, differentiable) when
    serving, or when training without element-mode dropout (a feature-mode
    mask drawn from ``gen``).

    ``deterministic=False``: the training forward, differentiable in the
    params, with stochastic-depth scales ``drops`` (four per-stage lists of
    (B, 2) tensors) or drawn from the ``torch.Generator`` ``gen`` (see
    :func:`draw_drops`) before anything else draws from it, so every path
    sees one drop stream.

    Under an active mesh of more than one rank
    (``parallel.sharding.use_mesh``), every rank passes the whole batch and
    gets the whole prediction back, by the route and view of
    :func:`serving_mesh`.  ``"wm"``: its dp slice is embedded (patch
    embed), its (tp, sp) share of the tokens runs the sharded window-major
    trunk (:func:`forward_core_wm` with the view) with its tp slice of the
    bias tables (sliced here where ``params`` hold them whole), the pair is
    gathered, recovered (patch recovery) and gathered over dp, as the JAX
    package serves a global array; trained (``deterministic=False``), the
    trunk is :func:`forward_core_wm_train` with the view, and the tables'
    slices are views of the whole tables.  ``"canon"`` (v2, odd depths,
    unmerged LoRA, ``attn_impl="xla"``, ``train_fused=False``, taps, a
    mesh the window-major gate refuses): its dp slice is embedded and cut
    to its longitude shard (:func:`embed_canon_shard`), the canonical trunk
    runs on the shard (:func:`forward_core` with the view, whole tables),
    the pair is gathered and recovered (:func:`recover_canon_shard`), taps
    are gathered whole.  Trained, the drop scales are drawn at the global
    batch on every rank from the one seeded ``gen`` and cut to the rank's
    dp rows, so every sample keeps its one-device scales (LoRA masks
    likewise, ``models/layers.py``); the gradient is this rank's share
    until ``parallel.sharding.reduce_grads`` sums it over the view.  The
    edge kernels serve one device only.  ``routed``: :func:`serving_mesh`'s
    answer for this call where the caller took it (``engine/train.py::
    loss_and_grads`` sums the gradient over that view), else taken here."""
    dev = _device.resolve(device)
    leaf = params["patch_embed"]["upper"]["kernel"]
    if leaf.device != dev:
        raise ValueError(f"params are on {leaf.device}, forward runs on {dev}")
    consts = to_device(constants, dev)
    cdt = _device.dtype_of(cfg.compute_dtype)
    train = not deterministic
    if train and taps is not None:
        raise ValueError("taps are collected by the served forward only")
    if routed is DECIDE:
        routed = serving_mesh(params, cfg, upper.shape[0], train=train,
                              canonical=taps is not None)
    if train and drops is None:
        drops = draw_drops(cfg, gen, upper.shape[0])
    if _merges(params, cfg, train):
        feature = train and has_lora_dropout(params, "lora_drop_feat")
        params = merge_lora(params, gen if feature else None)
    u, s = upper.to(dev, cdt), surface.to(dev, cdt)
    if routed is not None:
        route, view = routed
        dr = None if drops is None else [
            [sharding.shard(d, sharding.BATCH_SPEC, view) for d in st]
            for st in drops]
        if route == "canon":
            _require_whole_tables(params, cfg)
            x = embed_canon_shard(params, u, s, consts, cfg, view)
            if taps is not None:
                taps["embed"] = gather_canon(x, view)
            pair = forward_core(params, x, cfg, taps=taps, kernels=kernels,
                                deterministic=deterministic, gen=gen,
                                drops=dr, mesh=view)
            return recover_canon_shard(params, pair, cfg, view)
        p = mesh_params(params, cfg, view, copy=not train)
        xs = embed_shard(p, u, s, consts, cfg, view)
        if train:
            skip, dec, off = forward_core_wm_train(p, xs, cfg, drops=dr,
                                                   kernels=kernels, mesh=view)
        else:
            skip, dec, off = forward_core_wm(p, xs, cfg, mesh=view,
                                             kernels=kernels)
        return recover_shard(p, skip, dec, off, cfg, view)
    if (taps is not None or not wm_core_supported(params, cfg)
            or (train and not cfg.train_fused)):
        x = L.patch_embed(params["patch_embed"], u, s, consts, cfg)
        if taps is not None:
            taps["embed"] = x
        pair = forward_core(params, x, cfg, taps=taps, kernels=kernels,
                            deterministic=deterministic, gen=gen, drops=drops)
        return L.patch_recovery(params["patch_recovery"], pair, cfg)
    if train:
        if cfg.edge_kernels:
            xs = embed_wm_train(params["patch_embed"], u, s, consts, cfg,
                                kernels=kernels)
        else:
            xs = embed_tokens(params, u, s, consts, cfg, kernels=kernels)
        skip, dec, off = forward_core_wm_train(params, xs, cfg, drops=drops,
                                               kernels=kernels)
        if cfg.edge_kernels:
            return recovery_wm_train(params["patch_recovery"], skip, dec, off,
                                     cfg, kernels=kernels)
        return recover_fields(params, skip, dec, off, cfg, kernels=kernels)
    xs = embed_tokens(params, u, s, consts, cfg, kernels=kernels)
    skip, dec, off = forward_core_wm(params, xs, cfg, kernels=kernels)
    return recover_fields(params, skip, dec, off, cfg, kernels=kernels)

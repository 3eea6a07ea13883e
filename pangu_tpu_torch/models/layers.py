"""Plain tensor layers of the port: the counterpart of
``pangu_tpu/models/layers.py``.

Activations live in channels-last ``(B, Z, H, W, C)`` token grids and dense
kernels use the ``(in, out)`` layout, as in the JAX package, so converted
parameters load without transposition.  Patch embed and patch recovery are
plain matrix products here (the JAX package leaves them to XLA outside any
kernel); a stride-equals-kernel convolution is a reshape plus a matmul, which
also keeps float32 off cuDNN's TF32 default.

The per-block path (the JAX package's ``_run_stage`` fallback loop, taken for
stages whose blocks carry LoRA leaves, for training with
``train_fused=False`` and for every block under ``attn_impl="xla"``):
``linear`` (the JAX ``dense`` with LoRA leaves, unmerged, and their
dropout), ``drop_path``, ``mlp``, ``earth_attention``, ``earth_block`` (which
dispatches to the no-roll block kernel, the grid attention and the block
tail kernel where the JAX package runs its Pallas kernels) and
``down_sample`` / ``up_sample`` (for LoRA leaves at ``reduce`` / ``expand``
/ ``mix``, and under ``attn_impl="xla"``).  They round where XLA rounds the JAX
layers: each product to the activation dtype before its bias is added in
it, the LoRA term rounded and scaled in the dtype.  LoRA dropout masks come
from an explicit ``torch.Generator``; a block's generators are made from
one seed, so a recomputed block draws the same masks.

On a rank's shard of the canonical-layout route (``mesh=``: a (dp, sp)
view, ``parallel.sharding.canon_view``) ``earth_block`` keeps the z and
latitude parts of its shift local and runs the longitude part as a halo
(``parallel.sharding.grid_roll``) before the block and after it, and an
element-mode LoRA mask is drawn at the one-device shape and layout, on
every rank from the same generator, and cut to this rank's part
(``cut``: the spec of the site's input and the view), so each sample and
token keeps its one-device mask.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.models.lora import has_lora
from pangu_tpu_torch.parallel.sharding import (GRID_SPEC, WINDOWS_SPEC,
                                               global_shape, grid_roll,
                                               lon_view, shard)


def dense(p, x):
    """y = x @ kernel (+ bias), kernel (in, out): the sum is taken in float32
    and rounded once to the dtype of x (where the CUDA kernels round it)."""
    y = x.float() @ p["kernel"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the trailing channel dim with float32 statistics
    (torch nn.LayerNorm's default eps), result in the dtype of x."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Patch embedding
# ---------------------------------------------------------------------------

def _patches(x, patch):
    """(B, V, D, H, W) with (D, H, W) multiples of ``patch`` ->
    (B, D/pz, H/ph, W/pw, V*pz*ph*pw), features ordered (v, z_off, h_off,
    w_off): the im2col of a convolution whose stride equals its kernel."""
    b, v, d, h, w = x.shape
    pz, ph, pw = patch
    x = x.reshape(b, v, d // pz, pz, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, d // pz, h // ph, w // pw, v * pz * ph * pw)


def _dot(x, w):
    """x @ w with the product summed in float32 and rounded once to the
    dtype of x (a matrix product of the compute dtype, as XLA runs it)."""
    return (x.float() @ w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# The per-block path
# ---------------------------------------------------------------------------

def _lora_input(p, x, gen, cut=None):
    """The LoRA branch input: ``x``, or, with a generator and a dropout-rate
    leaf, ``x`` under its dropout mask, kept values divided by the keep
    probability in x's dtype (``lora_drop``: a mask per token and feature;
    ``lora_drop_feat``: one per input feature, shared by every token).
    ``cut``: ``(spec, view)`` where ``x`` is this rank's part of the
    one-device input under ``spec``: the per-token mask is drawn whole and
    cut alike."""
    if gen is None:
        return x
    if "lora_drop" in p:
        rate, shape = p["lora_drop"], x.shape
        if cut is not None:
            shape = global_shape(shape, *cut)
    elif "lora_drop_feat" in p:
        rate, shape, cut = p["lora_drop_feat"], x.shape[-1:], None
    else:
        return x
    keep = 1.0 - rate
    if "lora_drop" in p:        # one byte a value: drawn whole under a cut
        mask = torch.empty(shape, dtype=torch.bool, device=x.device)
        mask.bernoulli_(float(keep.detach()), generator=gen)
    else:
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
    if cut is not None:         # a copy: the whole draw is freed
        mask = shard(mask, *cut).contiguous()
    return torch.where(mask, x / keep.to(x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def linear(p, x, gen=None, cut=None):
    """The JAX package's ``dense`` as its per-block path runs it: x @ kernel
    rounded to x's dtype; with LoRA leaves the unmerged low-rank term
    ((drop(x) @ A) @ B, each product rounded) times ``lora_scale`` in the
    dtype is added; then the bias in the dtype.  ``gen``: the generator of
    this site's LoRA dropout mask (training), or None (no dropout); ``cut``:
    see :func:`_lora_input`."""
    dt = x.dtype
    y = _dot(x, p["kernel"].to(dt))
    if "lora_a" in p:
        lo = _dot(_dot(_lora_input(p, x, gen, cut), p["lora_a"].to(dt)),
                  p["lora_b"].to(dt))
        y = y + lo * p["lora_scale"].to(dt)
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


def _lora_gens(seed, n: int, device):
    """``n`` generators for the LoRA dropout of n dense sites, seeded
    ``seed``, ``seed + 1``, ...; n Nones without a seed."""
    if seed is None:
        return (None,) * n
    return tuple(torch.Generator(device=device).manual_seed(seed + i)
                 for i in range(n))


def drop_path(x, scale):
    """Stochastic depth on a residual branch: ``x`` times the per-sample
    ``scale`` ((B,) float32, 0 or 1/keep, as ``models/pangu.py::draw_drops``
    gives them to every trunk), cast to x's dtype; None is the identity."""
    if scale is None:
        return x
    return x * scale.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))


def mlp(p, x, gelu_tanh: bool, gens=(None, None), cut=None):
    """Linear(C, 4C) -> GELU (erf, or tanh) -> Linear(4C, C)."""
    from pangu_tpu_torch.ops.block_tail import gelu
    return linear(p["fc2"], gelu(linear(p["fc1"], x, gens[0], cut),
                                 gelu_tanh), gens[1], cut)


def earth_attention(p, x, heads: int, ids=None, gens=(None, None),
                    cut=None):
    """Windowed attention with the earth-specific bias on partitioned windows
    ``x`` (B, nlon, ntype, N, C): q scaled in x's dtype, float32 logits plus
    the bias table (and -100 between tokens of different regions where
    ``ids``, the (ntype, N) region ids of a shifted block, are given),
    float32 softmax rounded to the dtype, P.V rounded, the proj product."""
    B, nlon, ntype, N, C = x.shape
    hd = C // heads
    dt = x.dtype
    qkv = linear(p["qkv"], x, gens[0], cut)
    qkv = qkv.reshape(B, nlon, ntype, N, 3, heads, hd).permute(
        4, 0, 1, 2, 5, 3, 6)                    # (3, B, nlon, ntype, heads, N, hd)
    q = qkv[0] * torch.tensor(hd ** -0.5, dtype=dt, device=x.device)
    s = q.float() @ qkv[1].float().transpose(-1, -2) + p["bias_table"].float()
    if ids is not None:
        ids = ids.to(x.device)
        s = s + torch.where(ids[:, None, :] != ids[:, :, None], -100.0,
                            0.0)[:, None]
    attn = torch.softmax(s, dim=-1).to(dt)
    out = (attn.float() @ qkv[2].float()).to(dt)
    out = out.permute(0, 1, 2, 4, 3, 5).reshape(B, nlon, ntype, N, C)
    return linear(p["proj"], out, gens[1], cut)


def earth_block(p, x, geom, roll: bool, *, drop=None, lora_seed=None,
                deterministic: bool = True, gelu_tanh: bool = False,
                kernels: bool = True, grid_bwd: str = "pallas",
                attn_impl: str = "pallas", mesh=None):
    """One Earth-specific block on the canonical (B, Z, H, W, C) grid, the
    JAX package's ``earth_block`` on one device: pad the latitude (and, with
    ``roll``, shift by half a window, region ids masking the wrapped
    windows), then, under ``attn_impl="xla"``, :func:`earth_attention` on
    the partitioned windows and the plain tail (no kernel on any device);
    under ``"pallas"``

      * an unshifted served block without LoRA leaves: the whole no-roll
        block kernel (``block_noroll_fused``), cropped;
      * otherwise the attention: the grid attention (``window_attention_
        grid``, its backward by ``grid_bwd``) unless qkv or proj carries LoRA
        leaves, else :func:`earth_attention`; shifted back and cropped;
      * the tail: served and without LoRA at fc1 / fc2 the block tail kernel
        (``fused_block_tail``), else x1 = x + drop_path(LN1(a)), out = x1 +
        drop_path(LN2(mlp(x1))) with the per-sample scales ``drop`` ((B, 2)
        float32 or None).

    ``lora_seed``: the seed of this block's LoRA dropout generators (one per
    dense site), or None for no dropout.  ``kernels=False`` runs every
    kernel's plain version instead, on any device.  ``mesh``: a (dp, sp)
    view whose shard ``x`` is (the module's halos and mask cuts)."""
    from pangu_tpu_torch.ops.block_tail import (fused_block_tail,
                                                fused_block_tail_plain)
    from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                      block_noroll_plain,
                                                      window_attention_grid)
    B, Z, H, W, C = x.shape
    wz, wh, ww = geom.window
    half = (wz // 2, wh // 2, ww // 2)
    hp = geom.h_padded
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, hp - H))
    ids = None
    halo = lon_view(mesh)       # None at sp 1: the lon roll stays local
    if roll:
        xp = grid_roll(xp, tuple(-h for h in half), halo)
        ids = torch.as_tensor(window_region_ids(Z, hp, geom.window),
                              device=x.device)
    pallas = attn_impl == "pallas"
    if pallas and not roll and deterministic and not has_lora(p):
        block = block_noroll_fused if kernels else block_noroll_plain
        return block(p, xp, geom, gelu_tanh)[:, :, :H].contiguous()
    gens = _lora_gens(lora_seed, 4, x.device)   # qkv, proj, fc1, fc2
    cuts = (None, None) if mesh is None else ((WINDOWS_SPEC, mesh),
                                              (GRID_SPEC, mesh))
    a = (window_attention_grid(p["attn"], xp, geom, ids, bwd_impl=grid_bwd,
                               kernels=kernels) if pallas else None)
    if a is None:
        win = earth_attention(p["attn"], window_partition(xp, geom.window),
                              geom.heads, ids, gens[:2], cuts[0])
        a = window_reverse(win, geom.window, Z, hp, W)
    if roll:
        a = grid_roll(a, half, halo)
    a = a[:, :, :H]
    if (pallas and deterministic and "lora_a" not in p["mlp"]["fc1"]
            and "lora_a" not in p["mlp"]["fc2"]):
        tail = fused_block_tail if kernels else fused_block_tail_plain
        return tail(p, a, x, gelu_tanh)
    s1, s2 = (None, None) if drop is None else (drop[:, 0], drop[:, 1])
    x = x + drop_path(layer_norm(p["norm1"], a), s1)
    return x + drop_path(layer_norm(p["norm2"],
                                    mlp(p["mlp"], x, gelu_tanh, gens[2:],
                                        cuts[1])), s2)


def _grid_cut(mesh):
    return None if mesh is None else (GRID_SPEC, mesh)


def down_sample(p, x, gen=None, mesh=None):
    """DownSample as the JAX package's XLA layer (LoRA leaves at ``reduce``
    unmerged): a zero latitude row where H is odd, 2x2 space-to-depth in
    (h_off, w_off, C) order, LayerNorm(4C), Linear(4C -> 2C, no bias).
    ``mesh``: a (dp, sp) view whose lon shard ``x`` is (an even number of
    columns: the space-to-depth stays local); the mask is cut from the
    one-device draw."""
    B, Z, H, W, C = x.shape
    h2, w2 = -(-H // 2), W // 2
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 2 * h2 - H))
    x = x.reshape(B, Z, h2, 2, w2, 2, C).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(B, Z, h2, w2, 4 * C)
    return linear(p["reduce"], layer_norm(p["norm"], x), gen,
                  _grid_cut(mesh))


def up_sample(p, x, out_h: int, gen=None, mesh=None):
    """UpSample as the JAX package's XLA layer (LoRA leaves at ``expand`` /
    ``mix`` unmerged): Linear(2C -> 4C', no bias), 2x2 depth-to-space, crop
    to ``out_h`` latitude rows, LayerNorm(C'), Linear(C' -> C', no bias).
    ``mesh``: as :func:`down_sample` (depth-to-space is column-local)."""
    B, Z, H, W, _ = x.shape
    x = linear(p["expand"], x, gen, _grid_cut(mesh))
    c = x.shape[-1] // 4
    x = x.reshape(B, Z, H, W, 2, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
    x = x.reshape(B, Z, 2 * H, 2 * W, c)[:, :, :out_h]
    return linear(p["mix"], layer_norm(p["norm"], x), gen, _grid_cut(mesh))


def patch_embed(p, upper, surface, constants, cfg: ModelConfig):
    """Embed the raw ERA5 state into the (B, Z, H, W, C) token grid.

    upper (B, 5, levels, lat, lon) and surface (B, 4, lat, lon) in physical
    units, in the compute dtype; ``constants`` as built by
    ``data.constants`` (float32 tensors, with the ``const_h_patches`` and
    ``surface_mask_patches`` views).  Normalisation happens here, inside the
    model.  Values round where the JAX package's ``patch_embed`` rounds them:
    the statistics are cast to the dtype of ``upper`` and the fields are
    normalised in it; each projection term (the variables, the const_h or
    mask term) is a product summed in float32 and rounded once; the terms
    and the bias are added in the dtype.  The surface plane is token plane 0
    and the upper planes follow."""
    pz, ph, pw = cfg.patch
    V, S = cfg.upper_vars, cfg.surface_vars
    dt = upper.dtype
    F = torch.nn.functional

    # ---- upper-air branch: variables, then the const_h channel -----------
    up = ((upper - constants["upper_mean"].to(dt)[None])
          / constants["upper_std"].to(dt)[None])
    up = F.pad(up, (0, 0, 0, cfg.lat_padded - cfg.lat,
                    0, cfg.levels_padded - cfg.levels))
    wu = p["upper"]["kernel"].to(dt)               # ((V+1)*pz*ph*pw, C)
    k = pz * ph * pw
    xu = (_dot(_patches(up, cfg.patch), wu[:V * k])
          + _dot(constants["const_h_patches"].to(dt), wu[V * k:])
          + p["upper"]["bias"].to(dt))             # (B, ZP, HT, WT, C)

    # ---- surface branch: variables, then the constant masks --------------
    sf = ((surface.to(dt) - constants["surface_mean"].to(dt)[None])
          / constants["surface_std"].to(dt)[None])
    sf = F.pad(sf, (0, 0, 0, cfg.lat_padded - cfg.lat))
    ws = p["surface"]["kernel"].to(dt)             # ((S+M)*ph*pw, C)
    k = ph * pw
    xs = (_dot(_patches(sf[:, :, None], (1, ph, pw))[:, 0], ws[:S * k])
          + _dot(constants["surface_mask_patches"].to(dt), ws[S * k:])
          + p["surface"]["bias"].to(dt))           # (B, HT, WT, C)

    return torch.cat([xs[:, None], xu], dim=1)


# ---------------------------------------------------------------------------
# Window partition / reverse
# ---------------------------------------------------------------------------

def window_partition(x, window: Tuple[int, int, int]):
    """(B, Z, Hp, W, C) -> (B, nlon, ntype, wz*wh*ww, C): longitude windows
    outermost, window type = zz * nlat + hh, token index ((z_off * wh) +
    h_off) * ww + w_off (the reference partition's order)."""
    B, Z, Hp, W, C = x.shape
    wz, wh, ww = window
    x = x.reshape(B, Z // wz, wz, Hp // wh, wh, W // ww, ww, C)
    x = x.permute(0, 5, 1, 3, 2, 4, 6, 7)
    return x.reshape(B, W // ww, (Z // wz) * (Hp // wh), wz * wh * ww, C)


def window_reverse(x, window: Tuple[int, int, int], z: int, hp: int, w: int):
    """Inverse of :func:`window_partition`."""
    B, C = x.shape[0], x.shape[-1]
    wz, wh, ww = window
    x = x.reshape(B, w // ww, z // wz, hp // wh, wz, wh, ww, C)
    x = x.permute(0, 2, 4, 3, 5, 1, 6, 7)
    return x.reshape(B, z, hp, w, C)


# ---------------------------------------------------------------------------
# Shifted-window region ids
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def window_region_ids(z: int, hp: int,
                      window: Tuple[int, int, int]) -> np.ndarray:
    """Region id of every window token, (ntype, N) int32.

    Built with the reference's exact region-assignment order, including its
    overlapping h-slice writes (the later slice wins), which the pretrained
    weights were trained against.  Two tokens may attend iff their region ids
    match.  Longitude needs no region split (the roll wraps periodically), so
    ids repeat across the longitude window dimension."""
    wz, wh, ww = window
    img = np.zeros((z, hp, 1), dtype=np.int32)
    cnt = 0
    z_slices = (slice(0, -wz), slice(-wz, -wz // 2), slice(-wz // 2, None))
    h_slices = (slice(0, -wh), slice(wh, -wh // 2), slice(-wh // 2, None))
    for zs in z_slices:
        for hs in h_slices:
            img[zs, hs, :] = cnt
            cnt += 1
    img = img[:, :, 0].reshape(z // wz, wz, hp // wh, wh)
    img = img.transpose(0, 2, 1, 3).reshape(-1, wz * wh)
    return np.repeat(img[:, :, None], ww, axis=2).reshape(-1, wz * wh * ww)


# ---------------------------------------------------------------------------
# Patch recovery
# ---------------------------------------------------------------------------

def dense_split_rows(pd, parts):
    """``dense`` over a feature-concatenated input given as separate
    ``parts``, without materialising the concat: y = a @ K[:Ca] + b @ K[Ca:]
    + bias.  As in the JAX package: each part's product is summed in float32
    and rounded to the parts' dtype, then the products and the bias are
    added in that dtype."""
    dt = parts[0].dtype
    off, y = 0, None
    for part in parts:
        c = part.shape[-1]
        t = _dot(part, pd["kernel"][off:off + c].to(dt))
        y = t if y is None else y + t
        off += c
    if "bias" in pd:
        y = y + pd["bias"].to(dt)
    return y


def recover_upper(p, parts, cfg: ModelConfig):
    """The upper branch of :func:`patch_recovery`: token planes 1.. of the
    (skip, decoder) grids -> normalised (B, 5, levels, lat, lon)."""
    B = parts[0].shape[0]
    pz, ph, pw = cfg.patch
    ZP, HT, WT = cfg.upper_planes, cfg.h_tokens, cfg.w_tokens
    up = dense_split_rows(p, tuple(q[:, 1:] for q in parts))
    up = up.reshape(B, ZP, HT, WT, cfg.upper_vars, pz, ph, pw)
    up = up.permute(0, 4, 1, 5, 2, 6, 3, 7)
    up = up.reshape(B, cfg.upper_vars, ZP * pz, HT * ph, WT * pw)
    return up[:, :, :cfg.levels, :cfg.lat, :]


def recover_surface(p, parts, cfg: ModelConfig):
    """The surface branch of :func:`patch_recovery`: token plane 0 of the
    (skip, decoder) grids -> normalised (B, 4, lat, lon)."""
    B = parts[0].shape[0]
    _, ph, pw = cfg.patch
    HT, WT = cfg.h_tokens, cfg.w_tokens
    sf = dense_split_rows(p, tuple(q[:, 0] for q in parts))
    sf = sf.reshape(B, HT, WT, cfg.surface_vars, ph, pw)
    sf = sf.permute(0, 3, 1, 4, 2, 5)
    sf = sf.reshape(B, cfg.surface_vars, HT * ph, WT * pw)
    return sf[:, :, :cfg.lat, :]


def patch_recovery(p, parts, cfg: ModelConfig):
    """(skip, decoder) token grids, each (B, Z, H, W, C) -> normalised
    output fields (upper (B, 5, levels, lat, lon), surface (B, 4, lat, lon)).
    Output features are ordered (var, z_off, h_off, w_off), the pretrained
    Conv1d out-channel layout."""
    return (recover_upper(p["upper"], parts, cfg),
            recover_surface(p["surface"], parts, cfg))

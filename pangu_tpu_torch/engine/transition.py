"""Token-space transition between chained steps: the counterpart of
``pangu_tpu/engine/transition.py`` (``build_transition``,
``apply_transition``).

Between two 24 h steps the reference recovers the fields, de-normalises,
crops, re-normalises, zero-pads and embeds them again.  The de-norm and
re-norm cancel and the embed reads exactly the patches the recovery wrote, so
the round trip is one per-token affine map on the pre-recovery pair:

    next[b, z, h, w, :] = [skip | dec][b, z, h, w, :] @ M_type(z, h)
                          + bias_field[z, h, w, :]

with six composed (2C, C) matrices (surface / upper body / top plane, each
interior or last real lat row; recovery features that the reference crops
are zeroed before composing) and a bias field that carries the embed of
const_h and the surface masks, both linear biases and the recovery bias
pushed through the embed weights.  The weight products are formed in
float32 and cast to the compute dtype.

The constant part of the bias field is the port's im2col views of const_h
and the surface masks (``data.constants``) times the embed rows the
composition dropped: matrix products, so no convolution (and no TF32) enters
it on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig


def build_transition(params, constants, cfg: ModelConfig,
                     embed_params=None) -> Dict[str, torch.Tensor]:
    """The composed operator: ``M_s``, ``M_sh``, ``M_u``, ``M_uh``,
    ``M_uz``, ``M_uzh`` (2C, C) and ``bias_field`` (Z, HT, WT, C), in the
    compute dtype, on the params' device.  ``constants``: tensors on that
    device.  ``embed_params``: the next model in a chain (default
    ``params``)."""
    if embed_params is None:
        embed_params = params
    pz, ph, pw = cfg.patch
    nu = cfg.upper_vars * pz * ph * pw      # recovery upper features per token
    ns = cfg.surface_vars * ph * pw         # recovery surface features per token
    ZP, HT = cfg.upper_planes, cfg.h_tokens

    rec, emb = params["patch_recovery"], embed_params["patch_embed"]
    wru, bru = rec["upper"]["kernel"].float(), rec["upper"]["bias"].float()
    wrs, brs = rec["surface"]["kernel"].float(), rec["surface"]["bias"].float()
    weu, beu = emb["upper"]["kernel"].float(), emb["upper"]["bias"].float()
    wes, bes = emb["surface"]["kernel"].float(), emb["surface"]["bias"].float()
    eu, es = weu[:nu], wes[:ns]             # embed rows of the real variables

    # feature masks of the crop + re-pad edges; features (var, z_off, h_off,
    # w_off) on both sides
    idx = torch.arange(nu, device=wru.device)
    keep_z = (idx // (ph * pw)) % pz < cfg.levels - pz * (ZP - 1)
    keep_h = (idx // pw) % ph < cfg.lat - ph * (HT - 1)
    idx_s = torch.arange(ns, device=wru.device)
    keep_hs = (idx_s // pw) % ph < cfg.lat - ph * (HT - 1)

    def comp(wr, br, e, keep):
        m = keep.float()
        return (wr * m) @ e, (br * m) @ e

    every_u = torch.ones_like(keep_z)
    M_u, b_u = comp(wru, bru, eu, every_u)
    M_uz, b_uz = comp(wru, bru, eu, keep_z)
    M_uh, b_uh = comp(wru, bru, eu, keep_h)
    M_uzh, b_uzh = comp(wru, bru, eu, keep_z & keep_h)
    M_s, b_s = comp(wrs, brs, es, torch.ones_like(keep_hs))
    M_sh, b_sh = comp(wrs, brs, es, keep_hs)

    # constant channels times the embed rows the composition dropped
    Bu = constants["const_h_patches"].float() @ weu[nu:]       # (ZP, HT, WT, C)
    Bs = constants["surface_mask_patches"].float() @ wes[ns:]  # (HT, WT, C)

    bu = Bu + beu + b_u
    bu[:, HT - 1] += b_uh - b_u
    bu[ZP - 1] += b_uz - b_u
    bu[ZP - 1, HT - 1] += b_uzh - b_uz - b_uh + b_u
    bs = Bs + bes + b_s
    bs[HT - 1] += b_sh - b_s
    bias_field = torch.cat([bs[None], bu], dim=0)

    dt = _device.dtype_of(cfg.compute_dtype)
    return {k: v.to(dt) for k, v in (
        ("M_u", M_u), ("M_uz", M_uz), ("M_uh", M_uh), ("M_uzh", M_uzh),
        ("M_s", M_s), ("M_sh", M_sh), ("bias_field", bias_field))}


def apply_transition(tp, x_cat, *, z0: int = 0, z_global: int = None):
    """Pre-recovery features -> the next step's (B, Z, H, W, C) token grid.
    ``x_cat``: the (skip, decoder) pair of canonical (B, Z, H, W, C) grids,
    or their (B, Z, H, W, 2C) concatenation.  Rounding: the float32 sum of
    the split-row product rounded once to the input dtype, then the bias
    field added in that dtype (the port's transition kernel rounds so).

    On a z shard of the grid (``tp["bias_field"]`` the shard's planes too)
    ``z0`` is the global index of its first plane and ``z_global`` the
    global plane count: a plane is typed surface where its global index is
    0 and top where it is ``z_global - 1``.  The default is the whole
    grid.  A token's map depends on its z plane and latitude row alone
    (the crop row ``H - 1`` included; the canonical grid has no pad
    rows), so on a longitude shard (the canonical route under a mesh,
    ``engine/rollout.py``) it runs as it does on the whole grid, given the
    shard's longitude columns of ``tp["bias_field"]``."""
    parts = x_cat if isinstance(x_cat, tuple) else (x_cat,)
    H, Z = parts[0].shape[2], parts[0].shape[1]
    if z_global is None:
        z_global = Z
    s_end = 1 if z0 == 0 else 0                    # local surface planes
    t_start = Z - 1 if z0 + Z == z_global else Z   # local top plane
    dt = parts[0].dtype

    def mm(sl, m):
        off, y = 0, None
        for part in parts:
            c = part.shape[-1]
            t = sl(part).float() @ m[off:off + c].float()
            y = t if y is None else y + t
            off += c
        return y.to(dt)

    def typed(planes, m, m_edge):
        return torch.cat([mm(lambda p: p[:, planes, :H - 1], tp[m]),
                          mm(lambda p: p[:, planes, H - 1:], tp[m_edge])], dim=2)

    x = torch.cat([typed(slice(a, b), m, m_edge) for a, b, m, m_edge in (
        (0, s_end, "M_s", "M_sh"), (s_end, t_start, "M_u", "M_uh"),
        (t_start, Z, "M_uz", "M_uzh")) if b > a], dim=1)
    return x + tp["bias_field"][None].to(dt)

"""Plain tensor layers of the port: the counterpart of
``pangu_tpu/models/layers.py``, limited to what the port's paths need.

Activations live in channels-last ``(B, Z, H, W, C)`` token grids and dense
kernels use the ``(in, out)`` layout, as in the JAX package, so converted
parameters load without transposition.  Patch embed and patch recovery are
plain matrix products here (the JAX package leaves them to XLA outside any
kernel); a stride-equals-kernel convolution is a reshape plus a matmul, which
also keeps float32 off cuDNN's TF32 default.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pangu_tpu_torch.config import ModelConfig


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

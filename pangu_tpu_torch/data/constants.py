"""Auxiliary constants: normalisation statistics, constant masks, const_h.

The counterpart of ``pangu_tpu/data/constants.py`` (``load_constants``,
``get_constants``, ``synthetic_constants``, ``derive_patch_constants``,
``norm_data`` / ``denorm_data``), with the same canonical conventions:

  * level axis index 0 == 1000 hPa;
  * upper stats are stored (vars, levels, 1, 1), surface stats (vars, 1, 1);
  * surface constant masks are stored pre-padded (masks, lat_padded, lon);
  * const_h is (levels, lat, lon).

The reference's ``aux_data`` files load as they are: ``upper_mean.npy`` /
``upper_std.npy`` are (13, 1, 1, 5) in *file* level order and are flipped
and transposed into the canonical order here.

The arrays are built with numpy (host side, from a seed) and turned into
tensors on a device with :func:`to_device`.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pangu_tpu_torch.config import ModelConfig


def _as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def load_constants(aux_path: str, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Load the reference aux_data directory into canonical arrays."""
    j = lambda n: os.path.join(aux_path, n)  # noqa: E731

    surface_mean = _as_f32(np.load(j("surface_mean.npy"))).reshape(
        cfg.surface_vars, 1, 1)
    surface_std = _as_f32(np.load(j("surface_std.npy"))).reshape(
        cfg.surface_vars, 1, 1)

    # file layout (levels, 1, 1, vars), file level order -> canonical
    # (vars, levels, 1, 1) with index 0 == 1000 hPa
    um = _as_f32(np.load(j("upper_mean.npy")))[::-1]
    us = _as_f32(np.load(j("upper_std.npy")))[::-1]
    upper_mean = um.transpose(3, 0, 1, 2)
    upper_std = us.transpose(3, 0, 1, 2)

    masks = _as_f32(np.load(j("constantMaks3.npy")))
    masks = masks.reshape(cfg.const_masks, *masks.shape[-2:])
    if masks.shape[-2] == cfg.lat:   # unpadded variant: pad like the model
        masks = np.pad(masks, ((0, 0), (0, cfg.lat_padded - cfg.lat), (0, 0)))
    if masks.shape != (cfg.const_masks, cfg.lat_padded, cfg.lon):
        raise ValueError(f"constantMaks3.npy: shape {masks.shape}, expected "
                         f"{(cfg.const_masks, cfg.lat_padded, cfg.lon)}")

    const_h = _as_f32(np.load(j("Constant_17_output_0.npy")))
    const_h = const_h.reshape(cfg.levels, cfg.lat, cfg.lon)

    return derive_patch_constants({
        "surface_mean": surface_mean, "surface_std": surface_std,
        "upper_mean": upper_mean, "upper_std": upper_std,
        "surface_masks": masks, "const_h": const_h,
    }, cfg)


def derive_patch_constants(constants: Dict[str, np.ndarray],
                           cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Add host-side im2col'd views of the constant channels:

      const_h_patches        (ZP, HT, WT, pz*ph*pw)
      surface_mask_patches   (HT, WT, const_masks*ph*pw)

    Row order matches the patch embed's in-feature order
    ((channel,) z_off, h_off, w_off)."""
    pz, ph, pw = cfg.patch
    out = dict(constants)

    ch = constants["const_h"]
    ch = np.pad(ch, ((0, cfg.levels_padded - cfg.levels),
                     (0, cfg.lat_padded - cfg.lat), (0, 0)))
    ch = ch.reshape(cfg.upper_planes, pz, cfg.h_tokens, ph,
                    cfg.w_tokens, pw)
    out["const_h_patches"] = _as_f32(
        ch.transpose(0, 2, 4, 1, 3, 5).reshape(
            cfg.upper_planes, cfg.h_tokens, cfg.w_tokens, pz * ph * pw))

    m = constants["surface_masks"]           # (M, lat_padded, lon)
    m = m.reshape(cfg.const_masks, cfg.h_tokens, ph, cfg.w_tokens, pw)
    out["surface_mask_patches"] = _as_f32(
        m.transpose(1, 3, 0, 2, 4).reshape(
            cfg.h_tokens, cfg.w_tokens, cfg.const_masks * ph * pw))
    return out


def synthetic_constants(cfg: ModelConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic fake constants with realistic scales (the same draws, in
    the same order, as the JAX package's ``synthetic_constants``)."""
    r = np.random.default_rng(seed)
    return derive_patch_constants({
        "surface_mean": _as_f32(r.normal(0, 1, (cfg.surface_vars, 1, 1))),
        "surface_std": _as_f32(r.uniform(0.5, 2.0, (cfg.surface_vars, 1, 1))),
        "upper_mean": _as_f32(r.normal(0, 1, (cfg.upper_vars, cfg.levels, 1, 1))),
        "upper_std": _as_f32(r.uniform(0.5, 2.0,
                                       (cfg.upper_vars, cfg.levels, 1, 1))),
        "surface_masks": _as_f32(r.normal(0, 1,
                                          (cfg.const_masks, cfg.lat_padded,
                                           cfg.lon))),
        "const_h": _as_f32(r.normal(0, 1, (cfg.levels, cfg.lat, cfg.lon))),
    }, cfg)


def get_constants(aux_path: Optional[str],
                  cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """File-backed constants when ``aux_path`` is a directory, synthetic
    otherwise."""
    if aux_path and os.path.isdir(aux_path):
        return load_constants(aux_path, cfg)
    return synthetic_constants(cfg)


def to_device(constants: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> float32 tensors on ``device`` (no copy for
    a tensor that is already there)."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in constants.items()}


# ---------------------------------------------------------------------------
# Normalisation of targets / de-normalisation of outputs
# ---------------------------------------------------------------------------

def norm_data(upper, surface, constants):
    upper = (upper - constants["upper_mean"][None]) / constants["upper_std"][None]
    surface = ((surface - constants["surface_mean"][None])
               / constants["surface_std"][None])
    return upper, surface


def denorm_data(upper, surface, constants):
    upper = upper * constants["upper_std"][None] + constants["upper_mean"][None]
    surface = (surface * constants["surface_std"][None]
               + constants["surface_mean"][None])
    return upper, surface

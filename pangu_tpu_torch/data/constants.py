"""Auxiliary constants: normalisation statistics, constant masks, const_h.

The counterpart of ``pangu_tpu/data/constants.py`` (``synthetic_constants``,
``derive_patch_constants``, ``norm_data`` / ``denorm_data``), with the same
canonical conventions:

  * level axis index 0 == 1000 hPa;
  * upper stats are stored (vars, levels, 1, 1), surface stats (vars, 1, 1);
  * surface constant masks are stored pre-padded (masks, lat_padded, lon);
  * const_h is (levels, lat, lon).

The arrays are built with numpy (host side, from a seed) and turned into
tensors on a device with :func:`to_device`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from pangu_tpu_torch.config import ModelConfig


def _as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


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

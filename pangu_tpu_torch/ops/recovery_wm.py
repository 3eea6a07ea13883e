"""Patch recovery straight from the rolled window-major skip/decoder pair:
the counterpart of ``pangu_tpu/ops/recovery_wm.py`` (``recovery_wm``, its
upper and surface kernels).

``skip_wm`` / ``dec_wm``: (B, nz, nlat, nlon, N, C) stage-3 exit storage
holding canonical token t + off at position t.  Output: the normalised
fields (B, 5, levels, lat, lon) and (B, 4, lat, lon), cropped, equal to
``patch_recovery((canonical skip, canonical dec))``.  The upper branch reads
token planes 1.., the surface branch plane 0.

``recovery_wm_upper`` / ``recovery_wm_surface`` launch one CUDA kernel each
(``csrc/recovery_wm.cu``) on a CUDA tensor, with a launch counter each, and
run their plain versions on a CPU tensor; ``recovery_wm`` runs both.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import ModelConfig, recovery_supported
from pangu_tpu_torch.models.layers import recover_surface, recover_upper
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset, params_in,
                                                wm_to_canonical)


def _canonical_pair(skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    g = cfg.stage(3)
    return wm_to_canonical(skip_wm, off, g), wm_to_canonical(dec_wm, off, g)


def recovery_wm_upper_plain(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    """Plain PyTorch version of the upper kernel (any device)."""
    return recover_upper(params_in(p["upper"], skip_wm.dtype),
                         _canonical_pair(skip_wm, dec_wm, off, cfg), cfg)


def recovery_wm_surface_plain(p, skip_wm, dec_wm, off: Offset,
                              cfg: ModelConfig):
    """Plain PyTorch version of the surface kernel (any device)."""
    return recover_surface(params_in(p["surface"], skip_wm.dtype),
                           _canonical_pair(skip_wm, dec_wm, off, cfg), cfg)


def recovery_wm_plain(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    """Plain PyTorch version of both kernels (any device)."""
    return (recovery_wm_upper_plain(p, skip_wm, dec_wm, off, cfg),
            recovery_wm_surface_plain(p, skip_wm, dec_wm, off, cfg))


def _launch(surface: bool, p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    g = cfg.stage(3)
    wz, wh, ww = g.window
    b, nz, nlat, nlon, n, c = skip_wm.shape
    want = (b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, g.dim)
    if (not recovery_supported(cfg) or skip_wm.dtype not in DTYPE_CODE
            or skip_wm.shape != want or dec_wm.shape != want
            or dec_wm.dtype != skip_wm.dtype or not skip_wm.is_contiguous()
            or not dec_wm.is_contiguous()):
        raise ValueError(f"recovery_wm: unsupported input {tuple(skip_wm.shape)}"
                         f" {tuple(dec_wm.shape)} {skip_wm.dtype} for {cfg}")
    q = params_in(p["surface" if surface else "upper"], skip_wm.dtype)
    for t in q.values():
        if t.device != skip_wm.device:
            raise ValueError(f"recovery_wm: parameter on {t.device}, input on "
                             f"{skip_wm.device}")
    pz, ph, pw = cfg.patch
    if surface:
        v, feat = cfg.surface_vars, cfg.surface_vars * ph * pw
        shape = (b, v, cfg.lat, cfg.lon)
    else:
        v, feat = cfg.upper_vars, cfg.upper_vars * pz * ph * pw
        shape = (b, v, cfg.levels, cfg.lat, cfg.lon)
    if q["kernel"].shape != (2 * c, feat):
        raise ValueError(f"recovery_wm: kernel {tuple(q['kernel'].shape)}")
    out = torch.empty(shape, dtype=skip_wm.dtype, device=skip_wm.device)
    code = _build.library().pangu_recovery_wm(
        DTYPE_CODE[skip_wm.dtype], int(surface), skip_wm.data_ptr(),
        dec_wm.data_ptr(), q["kernel"].data_ptr(), q["bias"].data_ptr(),
        out.data_ptr(), b, nz, nlat, nlon, n, c, wz, wh, ww, cfg.h_tokens, v,
        cfg.levels, cfg.lat, cfg.lon, *off,
        torch.cuda.current_stream(skip_wm.device).cuda_stream)
    _build.check(code, "recovery_wm")
    return out


def recovery_wm_upper(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    """Normalised upper field (B, 5, levels, lat, lon): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if not skip_wm.is_cuda:
        return recovery_wm_upper_plain(p, skip_wm, dec_wm, off, cfg)
    out = _launch(False, p, skip_wm, dec_wm, off, cfg)
    recovery_wm_upper.launches += 1
    return out


def recovery_wm_surface(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    """Normalised surface field (B, 4, lat, lon): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if not skip_wm.is_cuda:
        return recovery_wm_surface_plain(p, skip_wm, dec_wm, off, cfg)
    out = _launch(True, p, skip_wm, dec_wm, off, cfg)
    recovery_wm_surface.launches += 1
    return out


recovery_wm_upper.launches = 0
recovery_wm_surface.launches = 0


def recovery_wm(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    """Rolled stage-3 exit pair -> normalised (upper, surface) fields."""
    return (recovery_wm_upper(p, skip_wm, dec_wm, off, cfg),
            recovery_wm_surface(p, skip_wm, dec_wm, off, cfg))

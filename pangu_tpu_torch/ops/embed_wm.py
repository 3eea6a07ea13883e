"""Patch embedding straight into stage-0 window-major storage: the
counterpart of ``pangu_tpu/ops/embed_wm.py`` (``embed_wm``).

Raw (B, 5, levels, lat, lon) + (B, 4, lat, lon) physical fields -> the
stage-0 window-major entry storage (B, nz, nlat, nlon, N, C) in canonical
coordinates, latitude-pad token rows exact zeros, token plane 0 the surface.

The prepass stays PyTorch, as the JAX package leaves it to XLA: the upper
field normalised in the compute dtype, and the surface token plane (a small
im2col and matrix product) rounded where ``patch_embed`` rounds it.  The
kernel (``csrc/embed_wm.cu``) does the rest: the (var, z_off, h_off, w_off) patch
gather of the 5 upper variables plus const_h, the 192 -> C projection
(float32 sum plus bias, rounded once) and the write into wm storage.

``embed_wm`` launches the kernel on a CUDA tensor and runs ``embed_wm_plain``
on a CPU tensor; ``embed_wm.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build, _device
from pangu_tpu_torch.config import ModelConfig, embed_supported
from pangu_tpu_torch.models.layers import _dot, _patches
from pangu_tpu_torch.ops.earth_block_wm import DTYPE_CODE, to_window_major

F = torch.nn.functional


def _prepass(p, upper, surface, constants, cfg: ModelConfig):
    """(normalised upper, surface token plane (B, HT, WT, C)), both in the
    compute dtype."""
    dt = _device.dtype_of(cfg.compute_dtype)
    _, ph, pw = cfg.patch
    S = cfg.surface_vars
    un = ((upper.to(dt) - constants["upper_mean"].to(dt)[None])
          / constants["upper_std"].to(dt)[None])
    sf = ((surface.to(dt) - constants["surface_mean"].to(dt)[None])
          / constants["surface_std"].to(dt)[None])
    sf = F.pad(sf, (0, 0, 0, cfg.lat_padded - cfg.lat))
    ws = p["surface"]["kernel"].to(dt)
    k = ph * pw
    st = (_dot(_patches(sf[:, :, None], (1, ph, pw))[:, 0], ws[:S * k])
          + _dot(constants["surface_mask_patches"].to(dt), ws[S * k:])
          + p["surface"]["bias"].to(dt))
    return un.contiguous(), st.contiguous()


def embed_wm_plain(p, upper, surface, constants, cfg: ModelConfig):
    """Plain PyTorch version of the embed kernel (any device)."""
    dt = _device.dtype_of(cfg.compute_dtype)
    un, st = _prepass(p, upper, surface, constants, cfg)
    ch = constants["const_h"].to(dt)
    x6 = torch.cat([un, ch[None, None].expand(un.shape[0], 1, *ch.shape)], 1)
    x6 = F.pad(x6, (0, 0, 0, cfg.lat_padded - cfg.lat,
                    0, cfg.levels_padded - cfg.levels))
    xu = (_patches(x6, cfg.patch).float() @ p["upper"]["kernel"].to(dt).float()
          + p["upper"]["bias"].to(dt).float()).to(dt)    # (B, ZP, HT, WT, C)
    g = cfg.stage(0)
    x = torch.cat([st[:, None], xu], dim=1)
    x = F.pad(x, (0, 0, 0, 0, 0, g.h_padded - cfg.h_tokens))
    return to_window_major(x, g.window)


def embed_wm(p, upper, surface, constants, cfg: ModelConfig):
    """upper (B, 5, levels, lat, lon), surface (B, 4, lat, lon) in physical
    units; ``constants`` as tensors on their device.  Returns the stage-0 wm
    entry storage in the compute dtype: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not upper.is_cuda:
        return embed_wm_plain(p, upper, surface, constants, cfg)
    dt = _device.dtype_of(cfg.compute_dtype)
    g = cfg.stage(0)
    wz, wh, ww = g.window
    b = upper.shape[0]
    if (not embed_supported(cfg) or dt not in DTYPE_CODE
            or upper.shape != (b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)
            or surface.shape != (b, cfg.surface_vars, cfg.lat, cfg.lon)):
        raise ValueError(f"embed_wm: unsupported input {tuple(upper.shape)} "
                         f"{tuple(surface.shape)} {dt} for {cfg}")
    for name, t in list(constants.items()) + list(p["upper"].items()):
        if t.device != upper.device:
            raise ValueError(f"embed_wm: {name} on {t.device}, input on "
                             f"{upper.device}")
    un, st = _prepass(p, upper, surface, constants, cfg)
    ch = constants["const_h"].to(dt).contiguous()
    w = p["upper"]["kernel"].to(dt).contiguous()
    bias = p["upper"]["bias"].to(dt).contiguous()
    c = w.shape[1]
    out = torch.empty((b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww,
                       c), dtype=dt, device=upper.device)
    code = _build.library().pangu_embed_wm(
        DTYPE_CODE[dt], un.data_ptr(), ch.data_ptr(), st.data_ptr(),
        w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, *out.shape[1:], wz, wh, ww, cfg.upper_vars, cfg.levels, cfg.lat,
        cfg.lon, cfg.h_tokens,
        torch.cuda.current_stream(upper.device).cuda_stream)
    _build.check(code, "embed_wm")
    embed_wm.launches += 1
    return out


embed_wm.launches = 0

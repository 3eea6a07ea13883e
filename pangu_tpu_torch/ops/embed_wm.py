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
(float32 sum plus bias, rounded once) and the write into wm storage; in
bf16 on the tensor cores (``csrc/edge_mma.cuh``), whose operands
``embed_operands`` checks and aligns before a launch.

``embed_wm`` launches the kernel on a CUDA tensor and runs ``embed_wm_plain``
on a CPU tensor; ``embed_wm.launches`` counts the kernel's launches.

Training: ``embed_wm_train`` is the differentiable embed, an autograd
Function around the same forward.  Its backward takes the upper weight and
bias gradients from ``embed_dw_upper`` (the kernel ``csrc/embed_dw.cu``,
counterpart of ``pangu_tpu/ops/embed_wm.py::embed_dw_upper``, with its own
``launches`` count; in bf16 a relayout of the field's patches into the
cotangent's row order and one tensor-core product) and computes the rest --
the surface head's gradients and, where asked for, the fields' cotangents
-- as plain tensor math, as the JAX package computes them in XLA.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build, _device
from pangu_tpu_torch.config import ModelConfig, embed_supported
from pangu_tpu_torch.models.layers import _dot, _patches
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, aligned16,
                                                check_tensor_core_shape,
                                                from_window_major,
                                                to_window_major)

F = torch.nn.functional


def _normalised_upper(upper, constants, dt):
    """The upper field normalised in dtype ``dt`` (the prepass's rounding)."""
    return ((upper.to(dt) - constants["upper_mean"].to(dt)[None])
            / constants["upper_std"].to(dt)[None]).contiguous()


def _surface_cols(surface, constants, cfg: ModelConfig, dt):
    """The surface branch's patch rows in dtype ``dt``: the normalised
    variables (B, HT, WT, S*ph*pw) and the constant masks (HT, WT,
    M*ph*pw), both ordered (channel, h_off, w_off)."""
    _, ph, pw = cfg.patch
    sf = ((surface.to(dt) - constants["surface_mean"].to(dt)[None])
          / constants["surface_std"].to(dt)[None])
    sf = F.pad(sf, (0, 0, 0, cfg.lat_padded - cfg.lat))
    return (_patches(sf[:, :, None], (1, ph, pw))[:, 0],
            constants["surface_mask_patches"].to(dt))


def _prepass(p, upper, surface, constants, cfg: ModelConfig):
    """(normalised upper, surface token plane (B, HT, WT, C)), both in the
    compute dtype."""
    dt = _device.dtype_of(cfg.compute_dtype)
    _, ph, pw = cfg.patch
    k = cfg.surface_vars * ph * pw
    sv, mp = _surface_cols(surface, constants, cfg, dt)
    ws = p["surface"]["kernel"].to(dt)
    st = _dot(sv, ws[:k]) + _dot(mp, ws[k:]) + p["surface"]["bias"].to(dt)
    return _normalised_upper(upper, constants, dt), st.contiguous()


def _upper_cols(un, constants, cfg: ModelConfig):
    """The upper branch's patch rows (B, ZP, HT, WT, (V+1)*pz*ph*pw) of the
    normalised field plus const_h, features in ONNX order (v, zo, ho, wo)."""
    ch = constants["const_h"].to(un.dtype)
    x6 = torch.cat([un, ch[None, None].expand(un.shape[0], 1, *ch.shape)], 1)
    x6 = F.pad(x6, (0, 0, 0, cfg.lat_padded - cfg.lat,
                    0, cfg.levels_padded - cfg.levels))
    return _patches(x6, cfg.patch)


def embed_wm_plain(p, upper, surface, constants, cfg: ModelConfig):
    """Plain PyTorch version of the embed kernel (any device)."""
    dt = _device.dtype_of(cfg.compute_dtype)
    un, st = _prepass(p, upper, surface, constants, cfg)
    xu = (_upper_cols(un, constants, cfg).float()
          @ p["upper"]["kernel"].to(dt).float()
          + p["upper"]["bias"].to(dt).float()).to(dt)    # (B, ZP, HT, WT, C)
    g = cfg.stage(0)
    x = torch.cat([st[:, None], xu], dim=1)
    x = F.pad(x, (0, 0, 0, 0, 0, g.h_padded - cfg.h_tokens))
    return to_window_major(x, g.window)


def embed_operands(p, upper, surface, constants, cfg: ModelConfig):
    """What the kernel takes, checked before a launch: ``(un, ch, st, w,
    bias)`` in the compute dtype, the prepass done (the normalised upper
    field, const_h, the surface token plane, the upper weight and bias).
    Raises ValueError on an unsupported input or, in bf16 (the tensor-core
    route), on a C that is not a multiple of 8 or a longitude count that is
    not a multiple of 4; the bf16 operands are 16-byte aligned (copies
    where they are not)."""
    dt = _device.dtype_of(cfg.compute_dtype)
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
    w = p["upper"]["kernel"].to(dt).contiguous()
    if dt == torch.bfloat16:
        check_tensor_core_shape((w.shape[1],), None, "embed_wm")
        if cfg.lon % cfg.patch[2]:
            raise ValueError(f"embed_wm: the bf16 kernel takes a longitude "
                             f"count that is a multiple of {cfg.patch[2]}, "
                             f"got {cfg.lon}")
    un, st = _prepass(p, upper, surface, constants, cfg)
    ops = (un, constants["const_h"].to(dt).contiguous(), st, w,
           p["upper"]["bias"].to(dt).contiguous())
    if dt == torch.bfloat16:
        ops = tuple(aligned16(t) for t in ops)
    return ops


def embed_wm(p, upper, surface, constants, cfg: ModelConfig):
    """upper (B, 5, levels, lat, lon), surface (B, 4, lat, lon) in physical
    units; ``constants`` as tensors on their device.  Returns the stage-0 wm
    entry storage in the compute dtype: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not upper.is_cuda:
        return embed_wm_plain(p, upper, surface, constants, cfg)
    g = cfg.stage(0)
    wz, wh, ww = g.window
    b = upper.shape[0]
    un, ch, st, w, bias = embed_operands(p, upper, surface, constants, cfg)
    out = torch.empty((b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww,
                       w.shape[1]), dtype=w.dtype, device=upper.device)
    tensors = (un, ch, st, w, bias, out)
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_embed_wm(
            DTYPE_CODE[w.dtype], *(t.data_ptr() for t in tensors),
            b, *out.shape[1:], wz, wh, ww, cfg.upper_vars, cfg.levels,
            cfg.lat, cfg.lon, cfg.h_tokens, stream)
    _build.check(code, "embed_wm")
    embed_wm.launches += 1
    return out


embed_wm.launches = 0


# ---------------------------------------------------------------------------
# Training: the upper weight gradient kernel and the differentiable embed
# ---------------------------------------------------------------------------

def embed_dw_upper_plain(dxs, upper, constants, cfg: ModelConfig):
    """Plain PyTorch version of the upper weight-gradient kernel (any
    device): (dK ((V+1)*pz*ph*pw, C), db (C,)), float32."""
    g = cfg.stage(0)
    cols = _upper_cols(_normalised_upper(upper, constants, dxs.dtype),
                       constants, cfg)
    dtok = from_window_major(dxs, g.window)[:, 1:, :cfg.h_tokens]
    cols = cols.reshape(-1, cols.shape[-1]).float()
    dtok = dtok.reshape(-1, dtok.shape[-1]).float()
    return cols.T @ dtok, dtok.sum(0)


def embed_dw_operands(dxs, upper, constants, cfg: ModelConfig):
    """What the weight-gradient kernel takes, checked before a launch:
    ``(dxs, un, ch)`` in the dtype of ``dxs`` (the cotangent, the upper
    field normalised as the forward's prepass normalises it, const_h).
    Raises ValueError on an unsupported input or, in bf16 (the tensor-core
    route), on a C that is not a multiple of 8 or a longitude count that is
    not a multiple of 4; the bf16 operands are 16-byte aligned (copies
    where they are not)."""
    g = cfg.stage(0)
    wz, wh, ww = g.window
    b = upper.shape[0]
    c = cfg.dims[0]
    dt = dxs.dtype
    want = (b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, c)
    if (not embed_supported(cfg) or dt not in DTYPE_CODE
            or dxs.shape != want or not dxs.is_contiguous()
            or upper.shape != (b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)):
        raise ValueError(f"embed_dw_upper: unsupported input {tuple(dxs.shape)}"
                         f" {dt}, field {tuple(upper.shape)} for {cfg}")
    for name, t in [("upper", upper)] + list(constants.items()):
        if t.device != dxs.device:
            raise ValueError(f"embed_dw_upper: {name} on {t.device}, "
                             f"cotangent on {dxs.device}")
    if dt == torch.bfloat16:
        check_tensor_core_shape((c,), None, "embed_dw_upper")
        if cfg.lon % cfg.patch[2]:
            raise ValueError(f"embed_dw_upper: the bf16 kernel takes a "
                             f"longitude count that is a multiple of "
                             f"{cfg.patch[2]}, got {cfg.lon}")
    ops = (dxs, _normalised_upper(upper, constants, dt),
           constants["const_h"].to(dt).contiguous())
    if dt == torch.bfloat16:
        ops = tuple(aligned16(t) for t in ops)
    return ops


def embed_dw_upper(dxs, upper, constants, cfg: ModelConfig):
    """Upper embed weight and bias gradients straight from the wm cotangent
    ``dxs`` of the entry storage and the physical upper field: (dK in the
    ONNX row order of ``p["upper"]["kernel"]``, db), float32.  The field is
    normalised again in the dtype of ``dxs``, as the forward's prepass
    normalised it.  The CUDA kernel for a CUDA tensor (in bf16 a relayout
    and one tensor-core product, whose operands ``embed_dw_operands``
    checks and aligns), the plain version for a CPU tensor."""
    if not dxs.is_cuda:
        return embed_dw_upper_plain(dxs, upper, constants, cfg)
    dxs, un, ch = embed_dw_operands(dxs, upper, constants, cfg)
    g = cfg.stage(0)
    wz, wh, ww = g.window
    b, c = dxs.shape[0], dxs.shape[-1]
    lib = _build.library()
    dims = (b, *dxs.shape[1:5], wz, wh, ww, c, cfg.h_tokens, cfg.upper_vars)
    part = torch.empty(lib.pangu_embed_dw_ws(*dims), dtype=torch.float32,
                       device=dxs.device)
    k = cfg.upper_patch_features
    out = torch.empty((k + 1, c), dtype=torch.float32, device=dxs.device)
    tensors = (dxs, un, ch, part, out)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_embed_dw(
            DTYPE_CODE[dxs.dtype], *(t.data_ptr() for t in tensors), *dims,
            cfg.levels, cfg.lat, cfg.lon, stream)
    _build.check(code, "embed_dw_upper")
    embed_dw_upper.launches += 1
    return out[:k], out[k]


embed_dw_upper.launches = 0


def _unpatch(cols, cfg: ModelConfig, nvar: int, patch, depth: int):
    """Inverse im2col of non-overlapping patches: (B, D', HT, WT,
    nvar*pz*ph*pw) -> (B, nvar, depth, lat, lon), cropped."""
    b, dz, ht, wt, _ = cols.shape
    pz, ph, pw = patch
    x = cols.reshape(b, dz, ht, wt, nvar, pz, ph, pw)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7)
    x = x.reshape(b, nvar, dz * pz, ht * ph, wt * pw)
    return x[:, :, :depth, :cfg.lat]


class _EmbedTrain(torch.autograd.Function):
    """The embed forward (kernel or plain); backward: upper dW / db from
    ``embed_dw_upper``, the rest plain tensor math."""

    @staticmethod
    def forward(ctx, meta, upper, surface, ku, bu, ks, bs):
        cfg, constants, kernels = meta
        p = {"upper": {"kernel": ku, "bias": bu},
             "surface": {"kernel": ks, "bias": bs}}
        out = (embed_wm if kernels else embed_wm_plain)(p, upper, surface,
                                                        constants, cfg)
        ctx.meta = meta
        ctx.dtypes = (bu.dtype, bs.dtype)
        ctx.save_for_backward(upper, surface, ku, ks)
        return out

    @staticmethod
    def backward(ctx, dxs):
        cfg, constants, kernels = ctx.meta
        upper, surface, ku, ks = ctx.saved_tensors
        dxs = dxs.contiguous()
        dt = dxs.dtype
        dw = embed_dw_upper if kernels else embed_dw_upper_plain
        dk_u, db_u = dw(dxs, upper, constants, cfg)

        g = cfg.stage(0)
        c = dxs.shape[-1]
        _, ph, pw = cfg.patch
        dtok = from_window_major(dxs, g.window)[:, :, :cfg.h_tokens]
        ds_tok = dtok[:, 0]                                  # (B, HT, WT, C)
        sv, mp = _surface_cols(surface, constants, cfg, dt)
        ds_sum = ds_tok.float().sum(0)                       # masks: shared
        dk_s = torch.cat([
            sv.reshape(-1, sv.shape[-1]).float().T @ ds_tok.reshape(-1, c).float(),
            mp.reshape(-1, mp.shape[-1]).float().T @ ds_sum.reshape(-1, c)])
        db_s = ds_sum.sum((0, 1))

        d_upper = d_surface = None
        if ctx.needs_input_grad[1]:
            fv = cfg.upper_vars * cfg.patch[0] * ph * pw
            dcols = (dtok[:, 1:].float() @ ku[:fv].to(dt).float().T).to(dt)
            d_upper = (_unpatch(dcols, cfg, cfg.upper_vars, cfg.patch,
                                cfg.levels)
                       / constants["upper_std"].to(dt)[None]).to(upper.dtype)
        if ctx.needs_input_grad[2]:
            fv = cfg.surface_vars * ph * pw
            dcols = (ds_tok.float() @ ks[:fv].to(dt).float().T).to(dt)
            d_surface = (_unpatch(dcols[:, None], cfg, cfg.surface_vars,
                                  (1, ph, pw), 1)[:, :, 0]
                         / constants["surface_std"].to(dt)[None]
                         ).to(surface.dtype)
        bu_dt, bs_dt = ctx.dtypes
        return (None, d_upper, d_surface, dk_u.to(ku.dtype), db_u.to(bu_dt),
                dk_s.to(ks.dtype), db_s.to(bs_dt))


def embed_wm_train(p, upper, surface, constants, cfg: ModelConfig, *,
                   kernels: bool = True):
    """Differentiable :func:`embed_wm` (in the patch-embed parameters and,
    where they require it, the fields): the embed kernel forward and the
    ``embed_dw_upper`` backward; ``kernels=False`` runs both plain versions
    on any device.  ``constants`` are data and get no gradient."""
    return _EmbedTrain.apply((cfg, constants, kernels), upper, surface,
                             p["upper"]["kernel"], p["upper"]["bias"],
                             p["surface"]["kernel"], p["surface"]["bias"])

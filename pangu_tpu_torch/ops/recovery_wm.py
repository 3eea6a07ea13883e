"""Patch recovery straight from the rolled window-major skip/decoder pair:
the counterpart of ``pangu_tpu/ops/recovery_wm.py`` (``recovery_wm``, its
upper and surface kernels).

``skip_wm`` / ``dec_wm``: (B, nz, nlat, nlon, N, C) stage-3 exit storage
holding canonical token t + off at position t.  Output: the normalised
fields (B, 5, levels, lat, lon) and (B, 4, lat, lon), cropped, equal to
``patch_recovery((canonical skip, canonical dec))``.  The upper branch reads
token planes 1.., the surface branch plane 0.

``recovery_wm_upper`` / ``recovery_wm_surface`` launch one CUDA kernel each
(``csrc/recovery_wm.cu``; bf16 on the tensor cores, ``csrc/edge_mma.cuh``,
whose operands ``recovery_operands`` checks and aligns before a launch) on
a CUDA tensor, with a launch counter each, and run their plain versions on
a CPU tensor; ``recovery_wm`` runs both.

Training: ``recovery_wm_train`` is the differentiable recovery, an autograd
Function whose backward is ``recovery_bwd`` alone (the kernel
``csrc/recovery_bwd.cu``, counterpart of ``pangu_tpu/ops/recovery_wm.py::
recovery_bwd_pallas``, with its own ``launches`` count): the field
cotangents -> the pair's cotangents in its rolled storage and the heads'
float32 gradients.  Its bf16 route first lays the field cotangents out in
the pair's storage order (``field_cotangent_wm``; the pass alone:
``field_cotangent_wm_kernel``), then runs both products on the tensor
cores.
"""

from __future__ import annotations

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import ModelConfig, recovery_supported
from pangu_tpu_torch.models.layers import recover_surface, recover_upper
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset, aligned16,
                                                check_tensor_core_shape,
                                                params_in, to_window_major,
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


def recovery_operands(surface: bool, p, skip_wm, dec_wm, cfg: ModelConfig):
    """What the kernel of one branch takes, checked before a launch:
    ``(skip_wm, dec_wm, q, out_shape)``, q the branch's params in the
    pair's dtype.  Raises ValueError on an unsupported input or, in bf16
    (the tensor-core route of both branches), on a C that is not a multiple
    of 8; the bf16 pair and kernel are 16-byte aligned (copies where they
    are not)."""
    what = "recovery_wm_surface" if surface else "recovery_wm_upper"
    _check_pair(skip_wm, dec_wm, cfg, what)
    b, c = skip_wm.shape[0], skip_wm.shape[-1]
    q = params_in(p["surface" if surface else "upper"], skip_wm.dtype)
    for t in q.values():
        if t.device != skip_wm.device:
            raise ValueError(f"{what}: parameter on {t.device}, input on "
                             f"{skip_wm.device}")
    pz, ph, pw = cfg.patch
    if surface:
        feat = cfg.surface_vars * ph * pw
        shape = (b, cfg.surface_vars, cfg.lat, cfg.lon)
    else:
        feat = cfg.upper_vars * pz * ph * pw
        shape = (b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)
    if q["kernel"].shape != (2 * c, feat):
        raise ValueError(f"{what}: kernel {tuple(q['kernel'].shape)}")
    if skip_wm.dtype == torch.bfloat16:                 # the tensor cores
        check_tensor_core_shape((c,), None, what)
        skip_wm, dec_wm, q["kernel"] = (aligned16(t) for t in (
            skip_wm, dec_wm, q["kernel"]))
    return skip_wm, dec_wm, q, shape


def _launch(surface: bool, p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig):
    skip_wm, dec_wm, q, shape = recovery_operands(surface, p, skip_wm, dec_wm,
                                                  cfg)
    wz, wh, ww = cfg.stage(3).window
    b, nz, nlat, nlon, n, c = skip_wm.shape
    out = torch.empty(shape, dtype=skip_wm.dtype, device=skip_wm.device)
    tensors = (skip_wm, dec_wm, q["kernel"], q["bias"], out)
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_recovery_wm(
            DTYPE_CODE[skip_wm.dtype], int(surface),
            *(t.data_ptr() for t in tensors), b, nz, nlat, nlon, n, c, wz, wh,
            ww, cfg.h_tokens, shape[1], cfg.levels, cfg.lat, cfg.lon, *off,
            stream)
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


# ---------------------------------------------------------------------------
# Training: the backward kernel and the differentiable recovery
# ---------------------------------------------------------------------------

def _feat_cotangents(dU, dS, cfg: ModelConfig):
    """Field cotangents -> per-token feature cotangents (B, ZP, HT, WT,
    V*pz*ph*pw) and (B, HT, WT, S*ph*pw): the inverse of the recovery's
    interleave of non-overlapping patches, on the zero-padded fields."""
    pz, ph, pw = cfg.patch
    zp, ht, wt = cfg.upper_planes, cfg.h_tokens, cfg.w_tokens
    b = dU.shape[0]
    du = torch.nn.functional.pad(dU, (0, 0, 0, ht * ph - cfg.lat,
                                      0, zp * pz - cfg.levels))
    du = du.reshape(b, cfg.upper_vars, zp, pz, ht, ph, wt, pw)
    du = du.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, zp, ht, wt, -1)
    ds = torch.nn.functional.pad(dS, (0, 0, 0, ht * ph - cfg.lat))
    ds = ds.reshape(b, cfg.surface_vars, ht, ph, wt, pw)
    ds = ds.permute(0, 2, 4, 1, 3, 5).reshape(b, ht, wt, -1)
    return du, ds


def field_cotangent_wm(dU, dS, off: Offset, cfg: ModelConfig):
    """The feature cotangents in the pair's rolled storage order (plain, any
    device): (B, nz, nlat, nlon, N, V*pz*ph*pw + S*ph*pw), the upper head's
    columns then the surface head's.  A row holds the cotangent of the
    canonical token its storage position holds (position p, token p + off),
    zero in the head the token's plane does not belong to and on the
    latitude-pad rows: the matrix the bf16 recovery backward multiplies."""
    g = cfg.stage(3)
    dF_u, dF_s = _feat_cotangents(dU, dS, cfg)
    fu, fs = dF_u.shape[-1], dF_s.shape[-1]
    pad = torch.nn.functional.pad
    t = torch.cat([pad(dF_s, (fu, 0))[:, None], pad(dF_u, (0, fs))], dim=1)
    t = pad(t, (0, 0, 0, 0, 0, g.h_padded - cfg.h_tokens))
    t = torch.roll(t, shifts=tuple(-o for o in off), dims=(1, 2, 3))
    return to_window_major(t, g.window)


def _check_pair(skip_wm, dec_wm, cfg: ModelConfig, what: str):
    """The stage-3 storage shape the recovery kernels take, or ValueError."""
    g = cfg.stage(3)
    wz, wh, ww = g.window
    b = skip_wm.shape[0]
    want = (b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, g.dim)
    if (not recovery_supported(cfg) or skip_wm.dtype not in DTYPE_CODE
            or skip_wm.shape != want or dec_wm.shape != want
            or dec_wm.dtype != skip_wm.dtype or not skip_wm.is_contiguous()
            or not dec_wm.is_contiguous()):
        raise ValueError(f"{what}: unsupported input {tuple(skip_wm.shape)} "
                         f"{tuple(dec_wm.shape)} {skip_wm.dtype} for {cfg}")


def field_cotangent_wm_kernel(dU, dS, off: Offset, cfg: ModelConfig):
    """The bf16 recovery backward's relayout pass alone (the step of
    ``csrc/recovery_bwd.cu`` that writes :func:`field_cotangent_wm`): on a
    bf16 CUDA tensor the pass, on a CPU tensor the plain version."""
    if not dU.is_cuda:
        return field_cotangent_wm(dU, dS, off, cfg)
    g = cfg.stage(3)
    wz, wh, ww = g.window
    b = dU.shape[0]
    if (not recovery_supported(cfg) or dU.dtype != torch.bfloat16
            or dS.dtype != dU.dtype
            or dU.shape != (b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)
            or dS.shape != (b, cfg.surface_vars, cfg.lat, cfg.lon)):
        raise ValueError(f"field_cotangent_wm_kernel: unsupported cotangents "
                         f"{tuple(dU.shape)} {tuple(dS.shape)} {dU.dtype}")
    du, ds = aligned16(dU.contiguous()), aligned16(dS.contiguous())
    pz, ph, pw = cfg.patch
    feat = (cfg.upper_vars * pz + cfg.surface_vars) * ph * pw
    shape = (b, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww)
    out = torch.empty(shape + (feat,), dtype=du.dtype, device=du.device)
    with _build.launch_stream(du, ds, out) as stream:
        code = _build.library().pangu_recovery_cot_wm(
            du.data_ptr(), ds.data_ptr(), out.data_ptr(), b, *shape[1:], wz,
            wh, ww, cfg.h_tokens, cfg.upper_vars, cfg.surface_vars,
            cfg.levels, cfg.lat, cfg.lon, *off, stream)
    _build.check(code, "field_cotangent_wm_kernel")
    return out


def recovery_bwd_plain(p, skip_wm, dec_wm, dU, dS, off: Offset,
                       cfg: ModelConfig):
    """Plain PyTorch version of the recovery backward kernel (any device):
    ``(grads, d_skip_wm, d_dec_wm)``, grads float32."""
    g = cfg.stage(3)
    dt = skip_wm.dtype
    c = g.dim
    ht = cfg.h_tokens
    dF_u, dF_s = _feat_cotangents(dU.to(dt), dS.to(dt), cfg)
    ku, ks = p["upper"]["kernel"].to(dt), p["surface"]["kernel"].to(dt)

    def token_cotangent(rows_u, rows_s):
        du = (dF_u.float() @ rows_u.float().T).to(dt)
        ds = (dF_s.float() @ rows_s.float().T).to(dt)
        t = torch.cat([ds[:, None], du], dim=1)          # (B, Z, HT, WT, C)
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, g.h_padded - ht))
        t = torch.roll(t, shifts=tuple(-o for o in off), dims=(1, 2, 3))
        return to_window_major(t, g.window)

    cs = wm_to_canonical(skip_wm, off, g)
    cd = wm_to_canonical(dec_wm, off, g)

    def head(feat, plane):
        feat = feat.reshape(-1, feat.shape[-1]).float()
        parts = [(t[:, 1:] if plane == "upper" else t[:, 0]).reshape(-1, c)
                 .float().T @ feat for t in (cs, cd)]
        return {"kernel": torch.cat(parts), "bias": feat.sum(0)}

    grads = {"upper": head(dF_u, "upper"), "surface": head(dF_s, "surface")}
    return (grads, token_cotangent(ku[:c], ks[:c]),
            token_cotangent(ku[c:], ks[c:]))


def recovery_bwd(p, skip_wm, dec_wm, dU, dS, off: Offset, cfg: ModelConfig):
    """The recovery backward: field cotangents dU (B, 5, levels, lat, lon)
    and dS (B, 4, lat, lon) plus the saved rolled pair -> ``(grads,
    d_skip_wm, d_dec_wm)``, the pair's cotangents rolled by ``off`` like
    the pair, grads a float32 {"upper", "surface"} {"kernel", "bias"} tree.
    The CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    In bf16 the weight gradients sum over every storage row, where the rows
    outside a head add 0 x the pair: the pair must be finite on its
    latitude-pad rows (the trunk's are)."""
    if not skip_wm.is_cuda:
        return recovery_bwd_plain(p, skip_wm, dec_wm, dU, dS, off, cfg)
    _check_pair(skip_wm, dec_wm, cfg, "recovery_bwd")
    g = cfg.stage(3)
    wz, wh, ww = g.window
    b, nz, nlat, nlon, n, c = skip_wm.shape
    dt = skip_wm.dtype
    if (dU.shape != (b, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)
            or dS.shape != (b, cfg.surface_vars, cfg.lat, cfg.lon)):
        raise ValueError(f"recovery_bwd: cotangents {tuple(dU.shape)} "
                         f"{tuple(dS.shape)} for {cfg}")
    q = {k: params_in(p[k], dt) for k in ("upper", "surface")}
    for t in (q["upper"]["kernel"], q["surface"]["kernel"], dU, dS):
        if t.device != skip_wm.device:
            raise ValueError(f"recovery_bwd: operand on {t.device}, pair on "
                             f"{skip_wm.device}")
    du = dU.to(dt).contiguous()
    ds = dS.to(dt).contiguous()
    if dt == torch.bfloat16:            # the tensor-core route
        check_tensor_core_shape((c,), None, "recovery_bwd")
        du, ds, skip_wm, dec_wm = (aligned16(t) for t in (du, ds, skip_wm,
                                                           dec_wm))
    lib = _build.library()
    ws = torch.empty(lib.pangu_recovery_bwd_ws(
        DTYPE_CODE[dt], b, nz, nlat, nlon, n, wz, wh, ww, cfg.h_tokens, c,
        cfg.upper_vars, cfg.surface_vars),
        dtype=torch.float32, device=skip_wm.device)
    f32 = dict(dtype=torch.float32, device=skip_wm.device)
    fu, fs = q["upper"]["kernel"].shape[1], q["surface"]["kernel"].shape[1]
    dku = torch.empty((2 * c + 1, fu), **f32)
    dks = torch.empty((2 * c + 1, fs), **f32)
    d_skip, d_dec = torch.empty_like(skip_wm), torch.empty_like(dec_wm)
    tensors = (du, ds, skip_wm, dec_wm, q["upper"]["kernel"],
               q["surface"]["kernel"], d_skip, d_dec, ws, dku, dks)
    with _build.launch_stream(*tensors) as stream:
        code = lib.pangu_recovery_bwd(
            DTYPE_CODE[dt], *(t.data_ptr() for t in tensors),
            b, nz, nlat, nlon, n, c, wz, wh, ww, cfg.h_tokens, cfg.upper_vars,
            cfg.surface_vars, cfg.levels, cfg.lat, cfg.lon, *off, stream)
    _build.check(code, "recovery_bwd")
    recovery_bwd.launches += 1
    grads = {"upper": {"kernel": dku[:2 * c], "bias": dku[2 * c]},
             "surface": {"kernel": dks[:2 * c], "bias": dks[2 * c]}}
    return grads, d_skip, d_dec


recovery_bwd.launches = 0


class _RecoveryTrain(torch.autograd.Function):
    """The recovery forward (kernels or plain); backward: ``recovery_bwd``
    alone."""

    @staticmethod
    def forward(ctx, meta, skip_wm, dec_wm, ku, bu, ks, bs):
        cfg, off, kernels = meta
        p = {"upper": {"kernel": ku, "bias": bu},
             "surface": {"kernel": ks, "bias": bs}}
        out = (recovery_wm if kernels else recovery_wm_plain)(
            p, skip_wm, dec_wm, off, cfg)
        ctx.meta = meta
        ctx.dtypes = (bu.dtype, bs.dtype)
        ctx.save_for_backward(skip_wm, dec_wm, ku, ks)
        return out

    @staticmethod
    def backward(ctx, dU, dS):
        cfg, off, kernels = ctx.meta
        skip_wm, dec_wm, ku, ks = ctx.saved_tensors
        p = {"upper": {"kernel": ku}, "surface": {"kernel": ks}}
        bwd = recovery_bwd if kernels else recovery_bwd_plain
        grads, d_skip, d_dec = bwd(p, skip_wm, dec_wm, dU, dS, off, cfg)
        bu_dt, bs_dt = ctx.dtypes
        return (None, d_skip, d_dec,
                grads["upper"]["kernel"].to(ku.dtype),
                grads["upper"]["bias"].to(bu_dt),
                grads["surface"]["kernel"].to(ks.dtype),
                grads["surface"]["bias"].to(bs_dt))


def recovery_wm_train(p, skip_wm, dec_wm, off: Offset, cfg: ModelConfig, *,
                      kernels: bool = True):
    """Differentiable :func:`recovery_wm` (in the pair and the recovery
    parameters): the two recovery kernels forward, ``recovery_bwd``
    backward; ``kernels=False`` runs the plain versions on any device."""
    return _RecoveryTrain.apply((cfg, tuple(off), kernels), skip_wm, dec_wm,
                                p["upper"]["kernel"], p["upper"]["bias"],
                                p["surface"]["kernel"], p["surface"]["bias"])

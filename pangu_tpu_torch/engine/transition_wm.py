"""Window-major token-space transition: the counterpart of
``pangu_tpu/engine/transition_wm.py`` (``build_transition_wm``,
``apply_transition_wm``, single device).

The composed recovery -> embed map of ``engine/transition.py`` applied to
the ROLLED window-major skip/decoder pair that the trunk leaves (storage
position p holds canonical token p + off), written as the next step's
stage-0 window-major entry storage in canonical coordinates.  Latitude-pad
rows of the output are zeros (the next entry block zero-synthesises them
anyway).

``apply_transition_wm`` launches the CUDA kernel (``csrc/transition_wm.cu``;
bf16 on the tensor cores, ``csrc/edge_mma.cuh``) on a CUDA tensor and runs
``apply_transition_wm_plain`` on a CPU tensor or with ``kernels=False``;
``apply_transition_wm.launches`` counts the kernel's launches.

Under a mesh it runs on one rank's shard of the pair: a longitude share of
the windows (sp; the read offset's lon component is then 0) and, with
``z_base`` / ``nz_global``, a tp share of the z windows (the JAX kernel's
``z_scalar=True`` variant, row 5z: the surface and top-plane rows are typed
by the global z window ``z_base + zz``; the offset's z component is 0).
``apply_transition_wm.z_launches`` counts the launches on a z shard alone.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import ModelConfig, StageGeometry
from pangu_tpu_torch.engine.transition import apply_transition, build_transition
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset, aligned16,
                                                check_shard_read,
                                                check_tensor_core_shape,
                                                from_window_major,
                                                to_window_major, wm_extent,
                                                wm_to_canonical)

MATRICES = ("M_s", "M_sh", "M_u", "M_uh", "M_uz", "M_uzh")


def build_transition_wm(params, constants, cfg: ModelConfig,
                        embed_params=None) -> Dict[str, torch.Tensor]:
    """``build_transition`` plus ``bias_field_wm``: the bias field laid out
    as stage-0 wm storage (1, nz, nlat, nlon, N, C), zero pad rows."""
    tp = build_transition(params, constants, cfg, embed_params=embed_params)
    g = cfg.stage(0)
    bf = tp["bias_field"][None]
    bf = torch.nn.functional.pad(bf, (0, 0, 0, 0, 0, g.h_padded - bf.shape[2]))
    tp["bias_field_wm"] = to_window_major(bf, g.window).contiguous()
    return tp


def apply_transition_wm_plain(tp, skip, dec, geom: StageGeometry,
                              off: Offset, *, z_base: int = 0,
                              nz_global: Optional[int] = None):
    """Plain PyTorch version of the transition kernel (any device); on a
    shard, ``tp["bias_field_wm"]`` is the shard's and ``z_base`` /
    ``nz_global`` place its z windows in the global grid."""
    wz = geom.window[0]
    nz = skip.shape[1]
    bias = from_window_major(tp["bias_field_wm"], geom.window)[0, :, :geom.h]
    y = apply_transition(
        {**tp, "bias_field": bias},
        (wm_to_canonical(skip, off, geom), wm_to_canonical(dec, off, geom)),
        z0=z_base * wz, z_global=(nz if nz_global is None else nz_global) * wz)
    y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, geom.h_padded - geom.h))
    return to_window_major(y, geom.window)


def shard_origin(skip, geom: StageGeometry, off: Offset, z_base, nz_global,
                 what: str = "apply_transition_wm"):
    """Check a launch's shard and return its ``(z_base, nz_global)``: the
    pair is the stage-0 grid or a shard of it (``check_shard_read``: no
    read across shards), a z shard comes with its ``z_base`` and
    ``nz_global``, and under ``z_base`` the offset's z component is 0.
    Raises ValueError on the rest."""
    wz = geom.window[0]
    extent = wm_extent(skip, geom.window)
    check_shard_read(extent, geom, off, what)
    nz = skip.shape[1]
    if z_base is None:
        if extent[0] != geom.z:
            raise ValueError(f"{what}: a z shard {tuple(skip.shape)} needs "
                             f"z_base and nz_global")
        return 0, nz
    if off[0]:
        raise ValueError(f"{what}: the z offset must be resolved in storage "
                         f"under tp, got {tuple(off)}")
    if nz_global != geom.z // wz or not 0 <= z_base <= nz_global - nz:
        raise ValueError(f"{what}: z windows {z_base}..{z_base + nz - 1} of "
                         f"{nz_global} for {geom}")
    return int(z_base), int(nz_global)


def apply_transition_wm(tp, skip, dec, geom: StageGeometry, off: Offset, *,
                        z_base: Optional[int] = None,
                        nz_global: Optional[int] = None, kernels: bool = True):
    """skip, dec: (B, nz, nlat, nlon, N, C) rolled wm storage with offset
    ``off``.  Returns the next step's stage-0 wm entry storage in canonical
    coordinates: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor or with ``kernels=False``.

    On a rank's shard, ``tp["bias_field_wm"]`` is the shard's too.  A tp z
    shard passes ``z_base`` (its first global z window) and ``nz_global``,
    and ``off[0]`` must be 0; a longitude shard needs ``off[2] == 0``
    (:func:`shard_origin` raises otherwise)."""
    z_shard = z_base is not None
    z0, nzg = shard_origin(skip, geom, off, z_base, nz_global)
    if not kernels or not skip.is_cuda:
        return apply_transition_wm_plain(tp, skip, dec, geom, off,
                                         z_base=z0, nz_global=nzg)
    b, nz, nlat, nlon, n, c = skip.shape
    wz, wh, ww = geom.window
    mats = [tp[k].contiguous() for k in MATRICES]
    bias = tp["bias_field_wm"].contiguous()
    if (skip.dtype not in DTYPE_CODE or dec.shape != skip.shape
            or dec.dtype != skip.dtype or not skip.is_contiguous()
            or not dec.is_contiguous() or c != geom.dim
            or bias.shape != (1,) + skip.shape[1:]
            or any(m.shape != (2 * c, c) for m in mats)):
        raise ValueError(f"apply_transition_wm: unsupported input "
                         f"{tuple(skip.shape)} {skip.dtype} for {geom}")
    for t in mats + [bias]:
        if t.dtype != skip.dtype or t.device != skip.device:
            raise ValueError(f"apply_transition_wm: operator {t.dtype} on "
                             f"{t.device}, input {skip.dtype} on {skip.device}")
    if skip.dtype == torch.bfloat16:    # the tensor-core route
        check_tensor_core_shape((c,), None, "apply_transition_wm")
        skip, dec, bias, *mats = (aligned16(t) for t in (skip, dec, bias,
                                                          *mats))
    out = torch.empty_like(skip)
    tensors = (skip, dec, bias, *mats, out)
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_transition_wm(
            DTYPE_CODE[skip.dtype], *(t.data_ptr() for t in tensors),
            b, nz, nlat, nlon, n, c, wz, wh, ww, geom.h, *off, z0, nzg,
            stream)
    _build.check(code, "transition_wm")
    apply_transition_wm.launches += 1
    if z_shard:
        apply_transition_wm.z_launches += 1
    return out


apply_transition_wm.launches = 0
apply_transition_wm.z_launches = 0

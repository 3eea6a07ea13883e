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
``apply_transition_wm.launches`` counts the kernel's launches.  The tp
z-sharded variant (``z_base``, ``nz_global``) is not ported yet (ROADMAP
queue A).
"""

from __future__ import annotations

from typing import Dict

import torch

from pangu_tpu_torch import _build
from pangu_tpu_torch.config import ModelConfig, StageGeometry
from pangu_tpu_torch.engine.transition import apply_transition, build_transition
from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, Offset, aligned16,
                                                check_tensor_core_shape,
                                                to_window_major,
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
                              off: Offset):
    """Plain PyTorch version of the transition kernel (any device)."""
    y = apply_transition(tp, (wm_to_canonical(skip, off, geom),
                              wm_to_canonical(dec, off, geom)))
    y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, geom.h_padded - geom.h))
    return to_window_major(y, geom.window)


def apply_transition_wm(tp, skip, dec, geom: StageGeometry, off: Offset, *,
                        kernels: bool = True):
    """skip, dec: (B, nz, nlat, nlon, N, C) rolled wm storage with offset
    ``off``.  Returns the next step's stage-0 wm entry storage in canonical
    coordinates: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor or with ``kernels=False``."""
    if not kernels or not skip.is_cuda:
        return apply_transition_wm_plain(tp, skip, dec, geom, off)
    b, nz, nlat, nlon, n, c = skip.shape
    wz, wh, ww = geom.window
    mats = [tp[k].contiguous() for k in MATRICES]
    bias = tp["bias_field_wm"]
    if (skip.dtype not in DTYPE_CODE or dec.shape != skip.shape
            or dec.dtype != skip.dtype or not skip.is_contiguous()
            or not dec.is_contiguous() or c != geom.dim
            or (nz * wz, nlat * wh, nlon * ww) != (geom.z, geom.h_padded, geom.w)
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
            b, nz, nlat, nlon, n, c, wz, wh, ww, geom.h, *off, stream)
    _build.check(code, "transition_wm")
    apply_transition_wm.launches += 1
    return out


apply_transition_wm.launches = 0

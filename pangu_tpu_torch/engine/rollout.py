"""Autoregressive multi-day rollout: the counterpart of
``pangu_tpu/engine/rollout.py`` (``single_step``, and ``make_rollout`` with
``token_space=False`` or, on one device, ``token_space=True`` through
``rollout_tokens_wm``).  The JAX ``lax.scan`` is a Python loop over steps.

``token_space=False``: each 24 h step is a full ``forward`` followed by
de-normalisation, as ``cli/inference.py`` serves it.

``token_space=True``: the state stays window-major token storage between
steps.  Embed once; each chained step runs the trunk and then the composed
recovery -> embed transition (``engine/transition_wm``); the fields are
recovered only where an output is due (the last step, or every step with
``return_trajectory``).
"""

from __future__ import annotations

import dataclasses

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.data.constants import denorm_data, to_device
from pangu_tpu_torch.engine.transition_wm import (apply_transition_wm,
                                                  build_transition_wm)
from pangu_tpu_torch.models import pangu


def single_step(params, upper, surface, constants, cfg: ModelConfig, *,
                device: _device.DeviceLike = "cuda", kernels: bool = True):
    """One 24 h forecast in *physical* units: forward (normalises inside),
    then de-normalise the prediction."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
    out_u, out_s = pangu.forward(params, upper, surface, consts, cfg,
                                 device=dev, kernels=kernels)
    return denorm_data(out_u, out_s, consts)


def make_rollout(cfg: ModelConfig, constants, steps: int, *,
                 return_trajectory: bool = False, token_space: bool = False,
                 device: _device.DeviceLike = "cuda", kernels: bool = True):
    """Build a rollout fn: (params, upper, surface) -> final state
    ``(upper, surface)``, or ``(final, (upper_traj, surface_traj))`` with the
    per-step states stacked on a leading axis when ``return_trajectory``.
    ``steps`` = horizon // 24.  Constants go to ``device`` once, here.
    ``kernels=False`` runs every kernel's plain version instead."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
    canonical_cfg = dataclasses.replace(cfg, edge_kernels=False)
    if steps < 1:
        raise ValueError(f"steps must be at least 1, not {steps}")

    def stacked(final, traj):
        return final, (torch.stack([t[0] for t in traj]),
                       torch.stack([t[1] for t in traj]))

    def rollout(params, upper, surface):
        u, s = upper.to(dev), surface.to(dev)
        traj = []
        for _ in range(steps):
            u, s = single_step(params, u, s, consts, cfg, device=dev,
                               kernels=kernels)
            if return_trajectory:
                traj.append((u, s))
        return stacked((u, s), traj) if return_trajectory else (u, s)

    def rollout_tokens(params, upper, surface):
        cdt = _device.dtype_of(cfg.compute_dtype)
        g = cfg.stage(0)
        tp = build_transition_wm(params, consts, cfg)
        xs = pangu.embed_tokens(params, upper.to(dev, cdt),
                                surface.to(dev, cdt), consts, cfg,
                                kernels=kernels)
        traj = []
        for step in range(steps):
            skip, dec, off = pangu.forward_core_wm(params, xs, cfg,
                                                   kernels=kernels)
            if return_trajectory:       # every step through the canonical grid
                traj.append(denorm_data(*pangu.recover_fields(
                    params, skip, dec, off, canonical_cfg), consts))
            if step < steps - 1:
                xs = apply_transition_wm(tp, skip, dec, g, off,
                                         kernels=kernels)
        if return_trajectory:
            return stacked(traj[-1], traj)
        return denorm_data(*pangu.recover_fields(params, skip, dec, off, cfg,
                                                 kernels=kernels), consts)

    return rollout_tokens if token_space else rollout

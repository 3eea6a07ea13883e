"""Autoregressive multi-day rollout: the counterpart of
``pangu_tpu/engine/rollout.py`` (``single_step``, and ``make_rollout`` for
``token_space=False``).  Each 24 h step is a full ``forward`` followed by
de-normalisation, as ``cli/inference.py`` serves it; the JAX ``lax.scan`` is
a Python loop over steps."""

from __future__ import annotations

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig
from pangu_tpu_torch.data.constants import denorm_data, to_device
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
                 return_trajectory: bool = False,
                 device: _device.DeviceLike = "cuda"):
    """Build a rollout fn: (params, upper, surface) -> final state
    ``(upper, surface)``, or ``(final, (upper_traj, surface_traj))`` with the
    per-step states stacked on a leading axis when ``return_trajectory``.
    ``steps`` = horizon // 24.  Constants go to ``device`` once, here."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)

    def rollout(params, upper, surface):
        u, s = upper.to(dev), surface.to(dev)
        traj = []
        for _ in range(steps):
            u, s = single_step(params, u, s, consts, cfg, device=dev)
            if return_trajectory:
                traj.append((u, s))
        if return_trajectory:
            return (u, s), (torch.stack([t[0] for t in traj]),
                            torch.stack([t[1] for t in traj]))
        return u, s

    return rollout

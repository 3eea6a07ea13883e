"""Autoregressive multi-day rollout: the counterpart of
``pangu_tpu/engine/rollout.py`` (``single_step``; ``make_rollout`` with
``token_space=False`` or, on one device, ``token_space=True`` through
``rollout_tokens_wm``; ``greedy_schedule`` and ``make_hierarchical_rollout``
on one device).  The JAX ``lax.scan`` is a Python loop over steps.

``token_space=False``: each 24 h step is a full ``forward`` followed by
de-normalisation, as ``cli/inference.py`` serves it.

``token_space=True``: the state stays window-major token storage between
steps.  Embed once; each chained step runs the trunk and then the composed
recovery -> embed transition (``engine/transition_wm``); the fields are
recovered only where an output is due (the last step, or every step with
``return_trajectory``).

The hierarchical rollout chains a model hierarchy (24/6/3/1 h) by the
greedy schedule, largest horizon first: full steps per model, or, with
``token_space=True``, token space throughout, each model's own transition
within a group and a transition from model A's recovery into model B's
embed at each hand-off.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


# ---------------------------------------------------------------------------
# Hierarchical multi-model rollout (1h/3h/6h/24h greedy scheduling)
# ---------------------------------------------------------------------------

def greedy_schedule(horizon: int,
                    available: Tuple[int, ...] = (24, 6, 3, 1)) -> list:
    """Decompose a forecast horizon into the fewest model steps, largest
    horizon first (the Pangu-Weather paper's scheme for its 1/3/6/24 h
    models).  Raises ``ValueError`` for a horizon that is not positive or
    that the available models cannot sum to."""
    if horizon <= 0:
        raise ValueError("horizon must be positive")
    steps = []
    remaining = horizon
    for h in sorted(available, reverse=True):
        while remaining >= h:
            steps.append(h)
            remaining -= h
    if remaining:
        raise ValueError(
            f"horizon {horizon} h not representable with models {available}")
    return steps


def _canonical_token_branch_only(params_by_horizon) -> None:
    """Raise where the JAX package would take its canonical token-space
    branch: under a multi-device mesh or with LoRA leaves (odd depths are
    refused by the config)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the hierarchical token-space rollout under a multi-device mesh "
            "is ROADMAP queue A item 9")
    for params in params_by_horizon.values():
        stack = [params]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                if any(str(k).startswith("lora") for k in node):
                    raise NotImplementedError(
                        "the hierarchical token-space rollout with LoRA "
                        "leaves is ROADMAP queue A items 8 and 3")
                stack.extend(node.values())
            elif isinstance(node, list):
                stack.extend(node)


def make_hierarchical_rollout(cfg: ModelConfig, constants, horizon: int,
                              model_horizons: Tuple[int, ...], *,
                              token_space: bool = False,
                              device: _device.DeviceLike = "cuda",
                              kernels: bool = True):
    """Build a rollout over a model hierarchy; returns ``(rollout,
    schedule)``.  ``rollout(params_by_horizon, upper, surface)`` takes
    ``{horizon_hours: params}`` and the state in physical units and returns
    the final state ``(upper, surface)``; ``schedule`` is the greedy list of
    model horizons.  Consecutive steps of one model form a group.

    ``token_space=False``: full steps (``single_step``) per model.
    ``token_space=True``: the single-device window-major chain, with the
    edge kernels when ``cfg.edge_kernels``: embed with the first model; in a
    group, trunk + that model's own transition; at a hand-off, trunk + the
    transition from this model's recovery into the next model's embed
    (``build_transition_wm(..., embed_params=next)``); trunk + recovery at
    the end.  ``kernels=False`` runs every kernel's plain version."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
    schedule = greedy_schedule(horizon, model_horizons)
    groups = []                     # [24, 24, 6] -> [(24, 2), (6, 1)]
    for h in schedule:
        if groups and groups[-1][0] == h:
            groups[-1] = (h, groups[-1][1] + 1)
        else:
            groups.append((h, 1))
    g = cfg.stage(0)

    def rollout(params_by_horizon, upper, surface):
        u, s = upper.to(dev), surface.to(dev)
        for h, count in groups:
            for _ in range(count):
                u, s = single_step(params_by_horizon[h], u, s, consts, cfg,
                                   device=dev, kernels=kernels)
        return u, s

    def rollout_tokens(params_by_horizon, upper, surface):
        _canonical_token_branch_only(params_by_horizon)
        cdt = _device.dtype_of(cfg.compute_dtype)
        xs = pangu.embed_tokens(params_by_horizon[groups[0][0]],
                                upper.to(dev, cdt), surface.to(dev, cdt),
                                consts, cfg, kernels=kernels)
        for gi, (h, count) in enumerate(groups):
            params = params_by_horizon[h]
            if count > 1:
                tp = build_transition_wm(params, consts, cfg)
                for _ in range(count - 1):
                    skip, dec, off = pangu.forward_core_wm(params, xs, cfg,
                                                           kernels=kernels)
                    xs = apply_transition_wm(tp, skip, dec, g, off,
                                             kernels=kernels)
            skip, dec, off = pangu.forward_core_wm(params, xs, cfg,
                                                   kernels=kernels)
            if gi < len(groups) - 1:
                tp = build_transition_wm(
                    params, consts, cfg,
                    embed_params=params_by_horizon[groups[gi + 1][0]])
                xs = apply_transition_wm(tp, skip, dec, g, off,
                                         kernels=kernels)
        return denorm_data(*pangu.recover_fields(params, skip, dec, off, cfg,
                                                 kernels=kernels), consts)

    return (rollout_tokens if token_space else rollout), schedule

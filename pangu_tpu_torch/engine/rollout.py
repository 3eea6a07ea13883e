"""Autoregressive multi-day rollout: the counterpart of
``pangu_tpu/engine/rollout.py`` (``single_step``; ``make_rollout`` with
``token_space=False`` or ``token_space=True`` through ``rollout_tokens_wm``
or, under ``block_layout="v2"`` or with LoRA leaves on the trunk,
``rollout_tokens``; ``greedy_schedule`` and ``make_hierarchical_rollout``;
under a mesh, ``rollout_tokens_wm_sharded`` and the canonical branches).  The
JAX ``lax.scan`` is a Python loop over steps.

``token_space=False``: each 24 h step is a full ``forward`` followed by
de-normalisation, as ``cli/inference.py`` serves it.

``token_space=True``: the state stays token storage between steps.  Embed
once; each chained step runs the trunk and then the composed recovery ->
embed transition; the fields are recovered only where an output is due (the
last step, or every step with ``return_trajectory``).  Under
``block_layout="wm"`` the storage is window-major and the transition
``engine/transition_wm`` (``rollout_tokens_wm``); under ``"v2"``, or with
LoRA leaves on the trunk (the chain runs them unmerged, block by block
where a stage carries them), it is the canonical token grid, the transition
``engine/transition`` (the JAX package's ``rollout_tokens``).

Under an active mesh (``parallel.sharding.use_mesh``) a full step is the
sharded ``forward``; the window-major chain runs per (dp, sp, tp) shard
(``_rollout_tokens_sharded``, the JAX package's
``rollout_tokens_wm_sharded``) where ``pangu.serving_mesh`` gives the
window-major route, and the canonical chain runs per (dp, sp) shard under
the canonical route's view everywhere else: a trajectory, the hierarchical
token-space rollout, and the trees and meshes that route takes.

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
from pangu_tpu_torch.engine.transition import (apply_transition,
                                               build_transition)
from pangu_tpu_torch.engine.transition_wm import (apply_transition_wm,
                                                  build_transition_wm)
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.parallel import sharding


def single_step(params, upper, surface, constants, cfg: ModelConfig, *,
                device: _device.DeviceLike = "cuda", kernels: bool = True):
    """One 24 h forecast in *physical* units: forward (normalises inside),
    then de-normalise the prediction."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
    out_u, out_s = pangu.forward(params, upper, surface, consts, cfg,
                                 device=dev, kernels=kernels)
    return denorm_data(out_u, out_s, consts)


@dataclasses.dataclass
class _Chain:
    """What a token-space chain runs with; ``_WmChain`` and ``_CanonChain``
    add the five steps (``embed``, ``core``, ``build``, ``transition``,
    ``recover``) and ``recover_step``, the fields a trajectory records."""
    cfg: ModelConfig
    consts: dict
    dev: torch.device
    kernels: bool
    mesh: object = None     # the canonical route's view (_CanonChain)

    def _fields_in(self, upper, surface):
        cdt = _device.dtype_of(self.cfg.compute_dtype)
        return upper.to(self.dev, cdt), surface.to(self.dev, cdt)


class _WmChain(_Chain):
    """The token-space chain of ``block_layout="wm"``: the state is stage-0
    window-major storage, a step's pre-recovery pair the rolled ``(skip,
    dec, off)``; embed and recovery by the edge kernels with
    ``cfg.edge_kernels``."""

    def embed(self, params, upper, surface):
        return pangu.embed_tokens(params, *self._fields_in(upper, surface),
                                  self.consts, self.cfg, kernels=self.kernels)

    def core(self, params, x):
        return pangu.forward_core_wm(params, x, self.cfg, kernels=self.kernels)

    def build(self, params, embed_params=None):
        return build_transition_wm(params, self.consts, self.cfg,
                                   embed_params=embed_params)

    def transition(self, tp, pair):
        skip, dec, off = pair
        return apply_transition_wm(tp, skip, dec, self.cfg.stage(0), off,
                                   kernels=self.kernels)

    def _recover(self, params, pair, cfg):
        return denorm_data(*pangu.recover_fields(params, *pair, cfg,
                                                 kernels=self.kernels),
                           self.consts)

    def recover(self, params, pair):
        return self._recover(params, pair, self.cfg)

    def recover_step(self, params, pair):
        """Through the canonical grid and patch recovery even with the edge
        kernels, as the JAX rollout records its trajectory."""
        return self._recover(
            params, pair, dataclasses.replace(self.cfg, edge_kernels=False))


class _CanonChain(_Chain):
    """The token-space chain of ``block_layout="v2"``: the state is the
    canonical (B, Z, H, W, C) grid, a step's pre-recovery pair ``(skip,
    dec)``; patch embed, patch recovery and ``engine/transition``.  With a
    ``mesh`` (the canonical route's (dp, sp) view) the state is this rank's
    shard: the transition is per token and typed by z and latitude only,
    so it runs on the shard with the shard's longitude columns of the bias
    field; the fields are gathered at the recovery."""

    def embed(self, params, upper, surface):
        u, s = self._fields_in(upper, surface)
        if self.mesh is not None:
            return pangu.embed_canon_shard(params, u, s, self.consts,
                                           self.cfg, self.mesh)
        return L.patch_embed(params["patch_embed"], u, s, self.consts,
                             self.cfg)

    def core(self, params, x):
        return pangu.forward_core(params, x, self.cfg, kernels=self.kernels,
                                  mesh=self.mesh)

    def build(self, params, embed_params=None):
        tp = build_transition(params, self.consts, self.cfg,
                              embed_params=embed_params)
        if self.mesh is not None:       # (Z, HT, WT, C): its lon columns
            tp["bias_field"] = sharding.shard(
                tp["bias_field"], sharding.CANON_TOKEN_SPEC[1:],
                self.mesh).contiguous()
        return tp

    def transition(self, tp, pair):
        return apply_transition(tp, pair)

    def recover(self, params, pair):
        if self.mesh is not None:
            out = pangu.recover_canon_shard(params, pair, self.cfg, self.mesh)
        else:
            out = L.patch_recovery(params["patch_recovery"], pair, self.cfg)
        return denorm_data(*out, self.consts)

    recover_step = recover      # the canonical grid already


def _token_chain(cfg: ModelConfig, consts, dev, kernels: bool, trees,
                 mesh=None):
    """The window-major chain where every parameter tree of the rollout
    takes the window-major trunk (``pangu.wm_core_supported``), else the
    canonical chain (``block_layout="v2"``, or LoRA leaves left unmerged on
    the trunk, as the JAX package's token-space dispatch); under the
    canonical route's view ``mesh``, the canonical chain on its shards."""
    wm = mesh is None and all(pangu.wm_core_supported(p, cfg) for p in trees)
    return (_WmChain if wm else _CanonChain)(cfg, consts, dev, kernels, mesh)


def _rollout_tokens_sharded(params, upper, surface, cfg: ModelConfig, consts,
                            dev, kernels: bool, steps: int, mesh):
    """The window-major token-space chain per (dp, sp, tp) shard (the JAX
    package's ``rollout_tokens_wm_sharded``): embed and slice once, then
    ``steps - 1`` times the sharded trunk and the transition on the shard
    (its slice of the bias field; under tp > 1 the z-shard transition,
    typed by the global z window), then the last trunk, the gathers and
    patch recovery.  Every rank returns the whole batch."""
    g = cfg.stage(0)
    p = pangu.mesh_params(params, cfg, mesh)
    tp = build_transition_wm(p, consts, cfg)
    tp["bias_field_wm"] = sharding.shard(
        tp["bias_field_wm"], sharding.TOKEN_SPEC[:4] + (None, None),
        mesh).contiguous()
    z_kw = {}
    if mesh.shape["tp"] > 1:
        nzg = g.z // g.window[0]
        z_kw = {"z_base": mesh.coords["tp"] * (nzg // mesh.shape["tp"]),
                "nz_global": nzg}
    cdt = _device.dtype_of(cfg.compute_dtype)
    x = pangu.embed_shard(p, upper.to(dev, cdt), surface.to(dev, cdt), consts,
                          cfg, mesh)
    for _ in range(steps - 1):
        skip, dec, off = pangu.forward_core_wm(p, x, cfg, mesh=mesh,
                                               kernels=kernels)
        x = apply_transition_wm(tp, skip, dec, g, off, kernels=kernels,
                                **z_kw)
    skip, dec, off = pangu.forward_core_wm(p, x, cfg, mesh=mesh,
                                           kernels=kernels)
    return denorm_data(*pangu.recover_shard(p, skip, dec, off, cfg, mesh),
                       consts)


def make_rollout(cfg: ModelConfig, constants, steps: int, *,
                 return_trajectory: bool = False, token_space: bool = False,
                 device: _device.DeviceLike = "cuda", kernels: bool = True):
    """Build a rollout fn: (params, upper, surface) -> final state
    ``(upper, surface)``, or ``(final, (upper_traj, surface_traj))`` with the
    per-step states stacked on a leading axis when ``return_trajectory``.
    ``steps`` = horizon // 24.  Constants go to ``device`` once, here.
    ``kernels=False`` runs every kernel's plain version instead.

    Under an active mesh of more than one rank every rank passes the whole
    batch and gets the whole result: each full step is the sharded
    ``forward``; ``token_space=True`` runs the window-major chain per shard
    (``_rollout_tokens_sharded``) where ``pangu.serving_mesh`` gives that
    route, else (a trajectory, v2, unmerged LoRA, a mesh the gate refuses)
    the canonical chain per (dp, sp) shard of the canonical route's
    view."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
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
        routed = pangu.serving_mesh(params, cfg, upper.shape[0],
                                    canonical=return_trajectory)
        if routed is not None and routed[0] == "wm":
            return _rollout_tokens_sharded(params, upper, surface, cfg,
                                           consts, dev, kernels, steps,
                                           routed[1])
        chain = _token_chain(cfg, consts, dev, kernels, [params],
                             None if routed is None else routed[1])
        tp = chain.build(params)
        x = chain.embed(params, upper, surface)
        traj = []
        for step in range(steps):
            pair = chain.core(params, x)
            if return_trajectory:
                traj.append(chain.recover_step(params, pair))
            if step < steps - 1:
                x = chain.transition(tp, pair)
        if return_trajectory:
            return stacked(traj[-1], traj)
        return chain.recover(params, pair)

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
    ``token_space=True``: the token chain (window-major, with the edge
    kernels when ``cfg.edge_kernels``; the canonical grid under
    ``block_layout="v2"``, and under an active mesh, where it runs per
    (dp, sp) shard of the canonical route's view, as the JAX package's
    mesh branch): embed with the first model; in a group, trunk + that
    model's own transition; at a hand-off, trunk + the transition from
    this model's recovery into the next model's embed (``embed_params=
    next``); trunk + recovery at the end.  ``kernels=False`` runs every
    kernel's plain version."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)
    schedule = greedy_schedule(horizon, model_horizons)
    groups = []                     # [24, 24, 6] -> [(24, 2), (6, 1)]
    for h in schedule:
        if groups and groups[-1][0] == h:
            groups[-1] = (h, groups[-1][1] + 1)
        else:
            groups.append((h, 1))

    def rollout(params_by_horizon, upper, surface):
        u, s = upper.to(dev), surface.to(dev)
        for h, count in groups:
            for _ in range(count):
                u, s = single_step(params_by_horizon[h], u, s, consts, cfg,
                                   device=dev, kernels=kernels)
        return u, s

    def rollout_tokens(params_by_horizon, upper, surface):
        first = params_by_horizon[groups[0][0]]
        routed = pangu.serving_mesh(first, cfg, upper.shape[0],
                                    canonical=True)
        chain = _token_chain(cfg, consts, dev, kernels,
                             [params_by_horizon[h] for h, _ in groups],
                             None if routed is None else routed[1])
        x = chain.embed(params_by_horizon[groups[0][0]], upper, surface)
        for gi, (h, count) in enumerate(groups):
            params = params_by_horizon[h]
            if count > 1:
                tp = chain.build(params)
                for _ in range(count - 1):
                    x = chain.transition(tp, chain.core(params, x))
            pair = chain.core(params, x)
            if gi < len(groups) - 1:
                tp = chain.build(
                    params, embed_params=params_by_horizon[groups[gi + 1][0]])
                x = chain.transition(tp, pair)
        return chain.recover(params, pair)

    return (rollout_tokens if token_space else rollout), schedule

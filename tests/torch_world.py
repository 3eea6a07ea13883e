"""Rank functions of the port's multi-rank tests (``tests/test_torch_
parallel*.py``, ``tests/test_torch_train_cli.py``), run by
``pangu_tpu_torch.parallel.launch.run`` in spawned ranks: this module
imports the port and torch, never JAX (``tests/conftest.py`` does), so a
rank starts quickly.  Every function returns CPU tensors."""

from __future__ import annotations

import dataclasses

import torch

from pangu_tpu_torch.config import MeshConfig
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.engine.rollout import (make_hierarchical_rollout,
                                            make_rollout)
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.ops.earth_block_wm import _lon_shift_wm, _z_shift_wm
from pangu_tpu_torch.parallel import mesh as M
from pangu_tpu_torch.parallel import sharding

WM_SPEC = (None, "tp", None, "sp", None, None)   # (B, nz, nlat, nlon, N, C)


def halos(xs, window, lon_shifts, z_shifts):
    """On 2 ranks: each lon shift of ``xs`` (wm storage) on sp = 2 shards
    and each z shift on tp = 2 shards, gathered; ``Mesh.ppermute`` of each
    rank's id by +1 and -1 along sp; whether a mesh of one rank leaves this
    rank idle."""
    out = {}
    for cfg, shifts, fn in ((MeshConfig(sp=2), lon_shifts, _lon_shift_wm),
                            (MeshConfig(tp=2), z_shifts, _z_shift_wm)):
        mesh = M.build_mesh(cfg, device="cpu")
        local = sharding.shard(xs, WM_SPEC, mesh)
        k = window[2] if cfg.sp > 1 else window[0]
        for d in shifts:
            out[(cfg.sp, cfg.tp, d)] = sharding.unshard(
                fn(local, d, k, mesh), WM_SPEC, mesh)
        if cfg.sp > 1:
            me = torch.tensor([float(M.world()[0])])
            out["ppermute"] = [mesh.ppermute(me, "sp", s) for s in (1, -1)]
            out["exchanges"] = mesh.exchanges
    out["idle"] = M.build_mesh(MeshConfig(), device="cpu") is None
    return out


def host_slots(sizes):
    """On the (1, 2, 2) mesh, for a rank-seeded float32 vector of each
    length in ``sizes``: ``Mesh.ppermute`` by +1 and -1 and
    ``Mesh.all_gather`` along sp and tp, and ``Mesh.all_reduce`` over sp,
    tp and both, through the mesh's shared-memory slots ("shm") and again
    through gloo alone, the same mesh without its slots ("gloo"); the axes
    that have slots."""
    mesh = M.build_mesh(MeshConfig(1, 2, 2), device="cpu")
    routes = {"shm": mesh, "gloo": dataclasses.replace(mesh, slots={})}
    rank = M.world()[0]
    out = {"slots": sorted(mesh.slots)}
    for n in sizes:
        x = torch.randn(n, generator=torch.Generator().manual_seed(
            100 * rank + n))
        for name, m in routes.items():
            res = out[(name, n)] = []
            for a in ("sp", "tp"):
                res += [m.ppermute(x, a, s) for s in (1, -1)]
                res.append(m.all_gather(x, a, 0))
            res += [m.all_reduce(x, axes)
                    for axes in (("sp",), ("tp",), ("sp", "tp"))]
    return out


def serve(meshes, cfg, params, consts, upper, surface, steps):
    """Per mesh: the sharded ``forward`` and the ``steps``-step token-space
    rollout, the whole batch on every rank, with the mesh's exchange
    count."""
    out = {}
    for mcfg in meshes:
        mesh = M.build_mesh(mcfg, device="cpu")
        with sharding.use_mesh(mesh):
            fwd = pangu.forward(params, upper, surface, consts, cfg,
                                device="cpu")
            roll = make_rollout(cfg, consts, steps, token_space=True,
                                device="cpu")(params, upper, surface)
        out[(mcfg.dp, mcfg.sp, mcfg.tp)] = {"forward": fwd, "rollout": roll,
                                            "exchanges": mesh.exchanges}
    return out


def cli_main(runs):
    """``pangu_tpu_torch.cli.<module>.main(argv)`` on this rank for each
    ``(module, argv)`` of ``runs``, "{rank}" in an argument replaced by
    this rank's number; their return codes."""
    import importlib
    rank = str(M.world()[0])
    return [importlib.import_module(f"pangu_tpu_torch.cli.{m}").main(
        [a.replace("{rank}", rank) for a in argv]) for m, argv in runs]


def _clone(tree):
    return T._map(tree, lambda t: t.detach().clone())


def _grads(tree):
    return T._map(tree, lambda t: None if t.grad is None
                  else t.grad.detach().clone())


def train(runs, tcfg, consts, batch, seed):
    """For each ``(key, mesh_cfg, cfg, params, masked, steps)`` of ``runs``:
    ``steps`` steps of ``make_train_step`` from a copy of ``params`` under
    that mesh (a (1, 1, 1) mesh: one device), step i with the seed ``seed
    + i`` and the whole batch, the optimizer masked to the LoRA factors and
    the recovery where ``masked``.  Returns per key the loss and grad norm
    of each step, the summed gradient of the first, the params after each
    and the mesh's exchange count."""
    from pangu_tpu_torch.models import lora
    out = {}
    for key, mcfg, cfg, tree, masked, steps in runs:
        mesh = M.build_mesh(mcfg, device="cpu")
        if mesh is None:                # a rank the mesh leaves idle
            continue
        p = _clone(tree)
        opt = T.make_optimizer(tcfg, trainable_mask=(
            lora.trainable_mask(p) if masked else None))
        state = T.create_train_state(p, opt)
        step = T.make_train_step(cfg, tcfg, consts, opt, device="cpu")
        rec = {"loss": [], "grad_norm": [], "params": []}
        with sharding.use_mesh(mesh):
            for i in range(steps):
                state, metrics = step(state, batch, seed + i)
                rec["loss"].append(metrics["loss"])
                rec["grad_norm"].append(metrics["grad_norm"])
                if i == 0:
                    rec["grads"] = _grads(state.params)
                rec["params"].append(_clone(state.params))
        rec["exchanges"] = mesh.exchanges
        out[key] = rec
    return out


def collectives(xs, window, lon_shifts, z_shifts, cot):
    """The backward of each lon shift of ``xs`` (wm storage) on sp = 2
    shards and of each z shift on tp = 2 shards, for the cotangent ``cot``
    (whole on every rank), gathered; on the (1, 2, 2) mesh the backward of
    ``Mesh.all_gather`` over sp and ``Mesh.all_reduce`` of (rank + 1) over
    sp, tp and both; on (2, 1, 2) over dp.  Ranks a mesh leaves idle skip
    it."""
    out = {}
    for mcfg, shifts, fn in ((MeshConfig(sp=2), lon_shifts, _lon_shift_wm),
                             (MeshConfig(tp=2), z_shifts, _z_shift_wm)):
        mesh = M.build_mesh(mcfg, device="cpu")
        if mesh is None:
            continue
        k = window[2] if mcfg.sp > 1 else window[0]
        for d in shifts:
            local = sharding.shard(xs, WM_SPEC, mesh).clone().requires_grad_()
            fn(local, d, k, mesh).backward(sharding.shard(cot, WM_SPEC, mesh))
            out[(mcfg.sp, mcfg.tp, d)] = sharding.unshard(local.grad, WM_SPEC,
                                                          mesh)
    me = torch.tensor([M.world()[0] + 1.0], dtype=torch.float64)
    for mcfg, axes_list in ((MeshConfig(1, 2, 2), (("sp",), ("tp",),
                                                   ("sp", "tp"))),
                            (MeshConfig(2, 1, 2), (("dp",), ("sp",)))):
        mesh = M.build_mesh(mcfg, device="cpu")
        out[("all_reduce", mcfg.dp, mcfg.sp, mcfg.tp)] = {
            axes: float(mesh.all_reduce(me, axes)) for axes in axes_list}
        if mcfg.sp > 1:
            x = (torch.arange(3.0, dtype=torch.float64)
                 + 10 * M.world()[0]).requires_grad_()
            mesh.all_gather(x, "sp", 0).backward(
                torch.arange(6.0, dtype=torch.float64))
            out["all_gather_grad"] = x.grad
            out["all_gather_exchanges"] = mesh.exchanges
    return out


def train_world(collective_args, train_args):
    """:func:`collectives`, then :func:`train`, in one world."""
    return {"collectives": collectives(*collective_args),
            "train": train(*train_args)}


# ---- the canonical-layout route (tests/test_torch_parallel_canon*.py) -----

def serve_case(kind, cfg, trees, consts, upper, surface):
    """One served call of the canonical-route tests, on one device or under
    the active mesh: ``forward``, ``taps`` (the prediction and the taps),
    a 2-step token-space ``rollout``, its ``trajectory``, or the 24 + 6 h
    token-space ``hierarchy`` (``trees["base"]`` the 24 h model,
    ``trees["h6"]`` the 6 h one)."""
    p = trees["base"]
    if kind == "forward":
        return pangu.forward(p, upper, surface, consts, cfg, device="cpu")
    if kind == "taps":
        taps = {}
        out = pangu.forward(p, upper, surface, consts, cfg, device="cpu",
                            taps=taps)
        return out, taps
    if kind in ("rollout", "trajectory"):
        return make_rollout(cfg, consts, 2, token_space=True, device="cpu",
                            return_trajectory=kind == "trajectory")(
            p, upper, surface)
    if kind == "hierarchy":
        roll, _ = make_hierarchical_rollout(cfg, consts, 30, (24, 6),
                                            token_space=True, device="cpu")
        return roll({24: p, 6: trees["h6"]}, upper, surface)
    raise ValueError(kind)


def canon_serve(cases, trees, consts, upper, surface):
    """For each ``(key, mesh shape, cfg, kind, batch)`` of ``cases``: the
    :func:`serve_case` on this rank under that mesh, with the first
    ``batch`` samples, and the mesh's exchange count.  Ranks a mesh leaves
    idle skip it."""
    out = {}
    for key, shape, cfg, kind, b in cases:
        mesh = M.build_mesh(MeshConfig(*shape), device="cpu")
        if mesh is None:
            continue
        with sharding.use_mesh(mesh):
            res = serve_case(kind, cfg, trees, consts, upper[:b], surface[:b])
        out[key] = {"result": res, "exchanges": mesh.exchanges}
    return out


def grads_case(cfg, tree, tcfg, consts, batch, seed):
    """``engine.train.loss_and_grads`` from a copy of ``tree``, on one
    device or under the active mesh: the loss and the summed gradient."""
    p = _clone(tree)
    for t in T._leaves(p):
        t.requires_grad_(True)
    loss, _, grads = T.loss_and_grads(p, batch, consts, cfg, tcfg,
                                      device="cpu", seed=seed)
    return loss, T._map(grads, lambda g: None if g is None
                        else g.detach().clone())


def canon_train(cases, tcfg, consts, batch, seed):
    """For each ``(key, mesh shape, cfg, tree, batch)`` of ``cases``:
    :func:`grads_case` under that mesh with the first ``batch`` samples,
    and the mesh's exchanges by collective.  Ranks a mesh leaves idle skip
    it."""
    out = {}
    for key, shape, cfg, tree, b in cases:
        mesh = M.build_mesh(MeshConfig(*shape), device="cpu")
        if mesh is None:
            continue
        with sharding.use_mesh(mesh):
            loss, grads = grads_case(cfg, tree, tcfg, consts,
                                     {k: v[:b] for k, v in batch.items()},
                                     seed)
        out[key] = {"loss": loss, "grads": grads,
                    "by_op": {k: list(v) for k, v in mesh.by_op.items()}}
    return out

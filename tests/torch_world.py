"""Rank functions of the port's multi-rank tests (``tests/test_torch_
parallel*.py``), run by ``pangu_tpu_torch.parallel.launch.run`` in spawned
ranks: this module imports the port and torch, never JAX (``tests/
conftest.py`` does), so a rank starts quickly.  Every function returns CPU
tensors."""

from __future__ import annotations

import torch

from pangu_tpu_torch.config import MeshConfig
from pangu_tpu_torch.engine.rollout import make_rollout
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
    ``(module, argv)`` of ``runs``; their return codes."""
    import importlib
    return [importlib.import_module(f"pangu_tpu_torch.cli.{m}").main(argv)
            for m, argv in runs]

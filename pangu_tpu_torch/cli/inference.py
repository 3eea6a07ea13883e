"""Autoregressive multi-day forecast: chains 24 h steps (or a model
hierarchy) on the device over the test window and scores the final frame
with the lat-weighted RMSE / anomaly ACC into the 12 CSVs, the scores
computed on the device.

Usage:
  python -m pangu_tpu_torch.cli.inference --horizon 168 --bf16 \\
      --set model.gelu=tanh --pretrained weights/pangu24.pt   # 7 days
  python -m pangu_tpu_torch.cli.inference --device cpu --tiny --synthetic \\
      --horizon 48 --limit 1
  torchrun --nproc_per_node 6 -m pangu_tpu_torch.cli.inference --bf16 \\
      --token-space --horizon 48     # one (dp 1, sp 3, tp 2) mesh

Under a launch of N ranks each rank serves its shard of the mesh
(``cli/common.py::setup_mesh``; a ``--models`` hierarchy in token space on
the canonical route's shards); every rank scores the whole batch, rank 0
writes the CSVs and the log.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.cli import common
from pangu_tpu_torch.engine import evaluate as E
from pangu_tpu_torch.engine import rollout as R
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.parallel import sharding
from pangu_tpu_torch.utils.logging import device_timer


def main(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--horizon", type=int, default=None,
                   help="total forecast horizon in hours")
    p.add_argument("--models", type=str, default=None,
                   help="model hierarchy 'H=weights_path,...' e.g. "
                        "'24=w24,6=w6,3=w3,1=w1'; horizons are chained "
                        "greedily (largest first); an empty path draws "
                        "fresh weights. Default: the single --pretrained "
                        "24 h model")
    p.add_argument("--limit", type=int, default=0,
                   help="forecast at most N batches (0 = all)")
    p.add_argument("--onnx-baseline", default=None, metavar="ONNX_PATH",
                   help="run the official .onnx through ONNX Runtime "
                        "instead of the port's model (the reference's "
                        "engine): the same rollout, the same CSVs. Needs "
                        "onnxruntime (an optional dependency)")
    p.add_argument("--ort-providers", default="cpu",
                   help="comma list for --onnx-baseline: cpu and/or cuda")
    p.add_argument("--token-space", action="store_true",
                   help="chain rollout steps in token space (the "
                        "recovery -> embed transition between steps; the "
                        "same function)")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    if args.horizon:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, horizon=args.horizon))
    hierarchy = None
    if args.models:
        hierarchy = {}
        for item in args.models.split(","):
            h, _, path = item.partition("=")
            hierarchy[int(h)] = path
        R.greedy_schedule(cfg.data.horizon, tuple(hierarchy))  # validate
    elif cfg.data.horizon < 24 or cfg.data.horizon % 24 != 0:
        raise SystemExit("--horizon must be a positive multiple of 24 "
                         "(or pass a --models hierarchy)")
    mesh = common.setup_mesh(cfg, args.device)
    if mesh is None:            # a rank the mesh leaves idle
        return 0
    dev = _device.resolve(args.device)
    out, logger = common.run_dirs(cfg, args.type_net)
    constants = common.load_constants_device(cfg, args.synthetic, dev)

    if args.onnx_baseline:
        from pangu_tpu_torch.engine import onnx_baseline as OB
        prov = {"cpu": "CPUExecutionProvider",
                "cuda": "CUDAExecutionProvider"}
        session = OB.make_session(
            args.onnx_baseline,
            providers=[prov[p.strip()] for p in args.ort_providers.split(",")])
        steps = cfg.data.horizon // 24

        def roll(u, s):
            outs = [OB.rollout(session, ui, si, steps) for ui, si in
                    zip(u.cpu().numpy(), s.cpu().numpy())]
            return tuple(torch.stack([torch.from_numpy(o[k]) for o in outs]
                                     ).to(dev) for k in (0, 1))
    elif hierarchy is not None:
        models = {h: common.load_params(argparse.Namespace(
                      **{**vars(args), "pretrained": path or None}), cfg)
                  for h, path in hierarchy.items()}
        hroll, schedule = R.make_hierarchical_rollout(
            cfg.model, constants, cfg.data.horizon, tuple(hierarchy),
            token_space=args.token_space, device=dev)
        roll = lambda u, s: hroll(models, u, s)  # noqa: E731
        steps = len(schedule)
    else:
        params = common.load_params(args, cfg)
        with sharding.use_mesh(mesh):
            routed = pangu.serving_mesh(params, cfg.model,
                                        cfg.train.eval_batch_size)
        if routed is not None and routed[0] == "wm":
            # the rank keeps its tp slice of the bias tables alone
            params = pangu.mesh_params(params, cfg.model, routed[1])
        steps = cfg.data.horizon // 24
        rollout = R.make_rollout(cfg.model, constants, steps,
                                 token_space=args.token_space, device=dev)
        roll = lambda u, s: rollout(params, u, s)  # noqa: E731
    _, loaders = common.make_loaders(cfg, args.synthetic, dev)

    names = E.score_names(cfg.model.upper_vars)
    tables = {n: {} for n in names}
    stats = {"samples": 0, "load_s": 0.0, "device_s": 0.0}
    t0 = time.perf_counter()
    with torch.no_grad(), sharding.use_mesh(mesh):
        for b in common.timed_batches(loaders["test"].epoch(0), args.limit,
                                      stats):
            keys = b["times"][1]
            logger.info(f"rollout {steps} steps -> {keys[0]}")
            with device_timer(dev) as t:
                pu, ps = roll(b["upper"], b["surface"])
                res = E.score_fields(pu, ps, b["target_upper"],
                                     b["target_surface"], constants)
            stats["device_s"] += t.seconds
            for n in names:
                arr = res[n].cpu().numpy()
                for i, key in enumerate(keys):
                    tables[n][key] = arr[i]

    if common.writes():
        E.save_error_scores(os.path.join(out, "csv"), tables,
                            levels=cfg.data.levels_hpa[:cfg.model.levels],
                            surface_vars=cfg.data.surface_variables)
        common.log_timing(logger, stats, time.perf_counter() - t0)
        logger.info(f"wrote {os.path.join(out, 'csv')} (mesh {mesh.cfg})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

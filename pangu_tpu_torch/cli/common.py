"""Shared plumbing of the port's command lines: the counterpart of
``pangu_tpu/cli/common.py`` (argument parsing, run-directory layout,
constants and parameter loading, loaders), with ``--device`` (default
"cuda"; asking for the card where there is none raises).

Under a launch of several ranks (torchrun, SLURM, ``parallel/launch.py``)
``setup_mesh`` joins the process group and builds this rank's mesh as the
JAX command lines build theirs; rank 0 alone writes (``writes``).

``build_config`` starts from ``TINY`` under ``--tiny`` and then applies the
config file and the ``--set`` overrides, so ``--tiny --set
model.edge_kernels=true`` keeps the override (the JAX package replaces the
whole model section by ``TINY`` after them).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import os
import time
from typing import Tuple

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import TINY, Config, load_config
from pangu_tpu_torch.data import era5
from pangu_tpu_torch.data.constants import get_constants, to_device
from pangu_tpu_torch.models import convert, pangu
from pangu_tpu_torch.parallel import mesh as M
from pangu_tpu_torch.utils import checkpoint
from pangu_tpu_torch.utils.logging import setup_logger


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--type_net", type=str, default="pangu_tpu",
                   help="run name (output subdirectory)")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="a.b.c=v", help="config override (repeatable)")
    p.add_argument("--pretrained", type=str, default=None,
                   help="pretrained weights: .pth (torch), .onnx, or a "
                        "params file of convert_weights")
    p.add_argument("--keys_csv", type=str, default=None,
                   help="torch->onnx name CSV (for .onnx pretrained)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data/constants (smoke runs without ERA5)")
    p.add_argument("--tiny", action="store_true",
                   help="use the TINY model geometry (smoke runs)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 params/activations")
    p.add_argument("--pallas", action="store_true",
                   help='attn_impl="pallas": the kernels (the port\'s '
                        "default already)")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (default: the card; raises where there is '
                        'none) or "cpu" (the plain versions)')
    return p


def build_config(args) -> Config:
    cfg = load_config(args.config, args.overrides,
                      base=Config(model=TINY) if args.tiny else None)
    model = cfg.model
    if args.bf16:
        model = dataclasses.replace(model, param_dtype="bfloat16",
                                    compute_dtype="bfloat16")
    if getattr(args, "pallas", False):
        model = dataclasses.replace(model, attn_impl="pallas")
    return dataclasses.replace(cfg, model=model)


def setup_mesh(cfg: Config, device: _device.DeviceLike = "cuda", *,
               batch: int = 1):
    """Join the process group where the launch describes one (torchrun,
    SLURM; idempotent), then build this rank's mesh, as the JAX command
    lines set theirs up: ``cfg.mesh`` where its size is more than 1, else
    ``auto_mesh_config`` over the world's ranks (dp dividing ``batch``: the
    fine-tuning command lines pass ``cfg.train.batch_size``; sp dividing
    stage 1's longitude windows, tp the smallest head count).  None on a
    rank the mesh leaves idle."""
    M.initialize_distributed(device=device)
    _, n_world = M.world()
    mcfg = cfg.mesh if cfg.mesh.size > 1 else M.auto_mesh_config(
        n_world, lon_windows=cfg.model.stage(1).w // cfg.model.window[2],
        max_heads=min(cfg.model.heads), batch=batch)
    return M.build_mesh(mcfg, device=device)


def writes() -> bool:
    """True on the rank that writes CSVs, logs and figures: rank 0."""
    return M.world()[0] == 0


def run_dirs(cfg: Config, type_net: str) -> Tuple[str, object]:
    """<out>/<type_net>/<horizon>/ with a file + stream logger; on a rank
    that does not write (:func:`writes`), the path alone and a logger of
    warnings without a file."""
    out = os.path.join(cfg.output_path, type_net, str(cfg.data.horizon))
    name = f"{type_net}{cfg.data.horizon}"
    if not writes():
        return out, setup_logger(f"{name}.rank{M.world()[0]}",
                                 level=logging.WARNING)
    os.makedirs(out, exist_ok=True)
    logger = setup_logger(name, os.path.join(out, f"{type_net}.log"))
    return out, logger


def load_constants_device(cfg: Config, synthetic: bool,
                          device: _device.DeviceLike = "cuda"):
    aux = None if synthetic else cfg.data.resolved_aux_path()
    return to_device(get_constants(aux, cfg.model), _device.resolve(device))


def load_params(args, cfg: Config):
    """``--pretrained``: a .pth, a .onnx (with ``--keys_csv``) or a params
    file of ``convert_weights``, on ``--device`` in ``cfg.model.param_dtype``;
    without it, fresh weights from a ``torch.Generator`` seeded with
    ``cfg.train.seed`` (the port's own draws)."""
    dev = _device.resolve(args.device)
    path = args.pretrained
    if path is None:
        return pangu.init_params(torch.Generator().manual_seed(cfg.train.seed),
                                 cfg.model, device=dev)
    if path.endswith(".pth"):
        return convert.load_torch_checkpoint(path, cfg.model, device=dev)
    if path.endswith(".onnx"):
        if not args.keys_csv:
            raise SystemExit("--keys_csv is required with an .onnx file")
        return convert.convert_onnx(path, args.keys_csv, cfg.model,
                                    device=dev)
    return checkpoint.load_params(path, device=dev,
                                  dtype=cfg.model.param_dtype)


def make_loaders(cfg: Config, synthetic: bool,
                 device: _device.DeviceLike = "cuda"):
    """The train / val / test datasets and loaders; each batch reaches the
    consumer on ``device`` whole (under a mesh every rank loads and holds
    the whole batch, and the forward, served or trained, takes its dp
    slice itself)."""
    shard_fn = era5.device_put_fn(device)
    dsets = {s: era5.make_dataset(cfg.data, s, cfg.model,
                                  synthetic=synthetic or None)
             for s in ("train", "val", "test")}
    loaders = {
        "train": era5.Loader(dsets["train"], cfg.train.batch_size,
                             shuffle=True, seed=cfg.train.seed,
                             num_workers=cfg.data.num_workers,
                             prefetch=cfg.data.prefetch, shard_fn=shard_fn),
        "val": era5.Loader(dsets["val"], 1, num_workers=cfg.data.num_workers,
                           shard_fn=shard_fn),
        "test": era5.Loader(dsets["test"], cfg.train.eval_batch_size,
                            num_workers=cfg.data.num_workers,
                            shard_fn=shard_fn, drop_last=False),
    }
    return dsets, loaders


def timed_batches(batches, limit: int, stats: dict):
    """The first ``limit`` batches (all for 0), each with per-sample target
    lists; ``stats["load_s"]`` sums the seconds spent waiting for them (the
    loader's decode and the copy to the device)."""
    it = iter(batches)
    for _ in (range(limit) if limit else itertools.count()):
        t0 = time.perf_counter()
        b = next(it, None)
        stats["load_s"] += time.perf_counter() - t0
        if b is None:
            return
        starts, targets = b["times"]
        # always per-sample target lists, so the CSV row keys keep one
        # format across the sweep
        b["times"] = (list(starts), list(targets))
        stats["samples"] += len(targets)
        yield b


def log_timing(logger, stats: dict, wall_s: float):
    """One line ``timing {json}``: samples, wall, host-loading and device
    seconds per sample."""
    n = max(stats["samples"], 1)
    logger.info("timing " + json.dumps({
        "samples": stats["samples"], "wall_s_per_sample": wall_s / n,
        "load_s_per_sample": stats["load_s"] / n,
        "device_s_per_sample": stats["device_s"] / n}))

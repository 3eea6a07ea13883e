"""LoRA (parameter-efficient) fine-tuning: attaches rank-r LoRA factors to
every linear site, freezes the base (the optimizer trains only the factors
and the patch recovery), trains with the standard loop, prints the
updated-vs-frozen audit, exports the adapter and a merged-weight snapshot,
then evaluates the merged params.

Usage:
  python -m pangu_tpu_torch.cli.lora_tune --type_net loratuner_normout \\
      --pretrained /path/pangu_weather_24_torch.pth
  python -m pangu_tpu_torch.cli.lora_tune --device cpu --tiny --synthetic \\
      --smoke
  torchrun --nproc_per_node 6 -m pangu_tpu_torch.cli.lora_tune --bf16

Under a launch of N ranks each rank trains its shard of the mesh
(``cli/common.py::setup_mesh``); rank 0 alone writes the adapter, the
merged snapshot, the log and the CSVs.  With the default element-mode
LoRA dropout the step trains block by block on the canonical route, each
rank on its (dp, sp) shard with its part of the one-device masks; with
``--set train.lora_dropout_mode=feature`` it merges and trains the
window-major trunk.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.cli import common
from pangu_tpu_torch.cli.finetune import smoke_batches
from pangu_tpu_torch.engine import evaluate as E
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import lora
from pangu_tpu_torch.parallel import sharding
from pangu_tpu_torch.utils.checkpoint import Checkpointer, save_params
from pangu_tpu_torch.utils.logging import get_writer


def _path_notes(cfg, logger) -> None:
    """Which compute path the step takes: the cost differs by several
    times with the dropout mode."""
    if cfg.model.attn_impl != "pallas" or not cfg.model.lora_fused:
        return
    rate, mode = cfg.train.lora_dropout, cfg.train.lora_dropout_mode
    if rate > 0 and mode == "element":
        logger.warning(
            "lora_dropout=%.3g mode=element (per-token masks, peft-exact) "
            "keeps TRAINING on the unmerged per-block path: the "
            "token-varying mask has no merged-weight form, so the fused "
            "kernels cannot run it (several times the full-tune step). "
            "Options: --set train.lora_dropout_mode=feature (one "
            "token-constant mask a step, merged exactly: the fused path) or "
            "--set train.lora_dropout=0. Evaluation runs merged.", rate)
    elif rate > 0:
        logger.info("lora_dropout=%.3g mode=feature: the step's feature mask "
                    "folds into the merge exactly; training runs merged "
                    "through the fused kernels", rate)
    else:
        logger.info("lora_dropout=0: training runs merged through the fused "
                    "kernels")


def main(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs x 2 steps for pipeline validation")
    p.add_argument("--rank", type=int, default=None,
                   help="LoRA rank (default from config)")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    if args.smoke:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=2))
    if args.rank:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, lora_rank=args.rank))
    mesh = common.setup_mesh(cfg, args.device, batch=cfg.train.batch_size)
    if mesh is None:            # a rank the mesh leaves idle
        return 0
    dev = _device.resolve(args.device)
    out, logger = common.run_dirs(cfg, args.type_net)
    writer = (get_writer(os.path.join(out, "writer")) if common.writes()
              else None)

    constants = common.load_constants_device(cfg, args.synthetic, dev)
    base = common.load_params(args, cfg)
    _, loaders = common.make_loaders(cfg, args.synthetic, dev)
    tc = cfg.train
    params, opt = T.attach_lora(torch.Generator().manual_seed(tc.seed), base,
                                tc, max(len(loaders["train"]), 1))
    del base
    # a copy for the post-train audit (the optimizer updates in place)
    init_snapshot = T._map(params, lambda t: t.detach().clone())
    logger.info(f"LoRA attached: rank={tc.lora_rank} alpha={tc.lora_alpha} "
                f"dropout={tc.lora_dropout} mode={tc.lora_dropout_mode} "
                f"mesh={mesh.cfg}")
    _path_notes(cfg, logger)
    state = T.create_train_state(params, opt)
    ckpt = Checkpointer(out) if common.writes() else None

    with sharding.use_mesh(mesh):
        train_step = T.make_train_step(cfg.model, tc, constants, opt,
                                       device=dev)
        eval_step = T.make_eval_step(cfg.model, tc, constants, device=dev)
        state, history = T.train_loop(
            tc, state, train_step, eval_step,
            lambda e: smoke_batches(loaders["train"], e, args.smoke),
            lambda: smoke_batches(loaders["val"], 0, args.smoke),
            seed=tc.seed, checkpointer=ckpt, logger=logger, writer=writer)

        # updated-vs-frozen audit (the reference's post-train sanity check)
        report = lora.audit(init_snapshot, state.params)
        for name in report["updated"][:20]:
            logger.info(f"parameter {name} | updated")
        logger.info(f"updated={len(report['updated'])} "
                    f"frozen={len(report['frozen'])}")

        merged = lora.merge_lora(T._map(state.params,
                                        lambda t: t.detach()))
        if common.writes():
            save_params(os.path.join(out, "models", "lora_adapter"),
                        state.params)
            save_params(os.path.join(out, "models", "merged"), merged)
        E.evaluate(merged, loaders["test"].epoch(0), cfg, constants,
                   res_path=os.path.join(out, "test") if common.writes()
                   else None, visualize=not args.smoke, logger=logger,
                   device=dev)
    if ckpt is not None:
        ckpt.close()
    if writer is not None:
        writer.close()
    logger.info(f"done; best val loss {history['best_val_loss']:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

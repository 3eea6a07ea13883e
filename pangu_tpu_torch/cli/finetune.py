"""Full fine-tuning: loads pretrained weights (or draws fresh ones),
fine-tunes every parameter with Adam + MultiStep over the (dp, sp, tp)
mesh, validates with early stopping, then evaluates the best params on the
test window.  The gradient is summed over the mesh every step
(``parallel/sharding.py::reduce_grads``), the sum the reference's DDP set-up
forgot.

Usage:
  python -m pangu_tpu_torch.cli.finetune --type_net finetune_fully \\
      --pretrained /path/pangu_weather_24_torch.pth
  python -m pangu_tpu_torch.cli.finetune --device cpu --tiny --synthetic \\
      --smoke                             # smoke run
  torchrun --nproc_per_node 6 -m pangu_tpu_torch.cli.finetune --bf16 \\
      --set model.gelu=tanh --set mesh.sp=3 --set mesh.tp=2

Under a launch of N ranks every rank loads the whole batch and trains its
shard of the mesh (``cli/common.py::setup_mesh``, dp dividing the batch);
rank 0 alone writes checkpoints, logs and CSVs, and every rank resumes
from the same checkpoint.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

from pangu_tpu_torch import _device
from pangu_tpu_torch.cli import common
from pangu_tpu_torch.engine import evaluate as E
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.parallel import sharding
from pangu_tpu_torch.utils.checkpoint import Checkpointer
from pangu_tpu_torch.utils.logging import get_writer


def smoke_batches(loader, epoch, smoke: bool, n: int = 2):
    """The loader's batches of ``epoch`` without their "times" (the first
    ``n`` only under ``smoke``: the loader is left before it is asked for
    batch n + 1, so its read-ahead stops and nothing waits for it)."""
    for b in itertools.islice(loader.epoch(epoch), n if smoke else None):
        b.pop("times", None)
        yield b


def main(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="2 epochs x 2 steps for pipeline validation")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    if args.smoke:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, epochs=2))
    mesh = common.setup_mesh(cfg, args.device, batch=cfg.train.batch_size)
    if mesh is None:            # a rank the mesh leaves idle
        return 0
    dev = _device.resolve(args.device)
    out, logger = common.run_dirs(cfg, args.type_net)
    writer = (get_writer(os.path.join(out, "writer")) if common.writes()
              else None)
    logger.info(f"mesh={mesh.cfg} device={dev}")

    constants = common.load_constants_device(cfg, args.synthetic, dev)
    params = common.load_params(args, cfg)
    logger.info(f"params loaded ({'pretrained' if args.pretrained else 'init'})")

    _, loaders = common.make_loaders(cfg, args.synthetic, dev)
    opt = T.make_optimizer(cfg.train, max(len(loaders["train"]), 1))
    state = T.create_train_state(params, opt)

    state, start_epoch, start_batch = resume(out, state, logger)
    ckpt = Checkpointer(out) if common.writes() else None

    with sharding.use_mesh(mesh):
        train_step = T.make_train_step(cfg.model, cfg.train, constants, opt,
                                       device=dev)
        eval_step = T.make_eval_step(cfg.model, cfg.train, constants,
                                     device=dev)
        state, history = T.train_loop(
            cfg.train, state, train_step, eval_step,
            lambda e: smoke_batches(loaders["train"], e, args.smoke),
            lambda: smoke_batches(loaders["val"], 0, args.smoke),
            seed=cfg.train.seed, start_epoch=start_epoch,
            start_batch=start_batch, checkpointer=ckpt, logger=logger,
            writer=writer)

        logger.info("Begin testing...")
        E.evaluate(state.params, loaders["test"].epoch(0), cfg, constants,
                   res_path=os.path.join(out, "test") if common.writes()
                   else None, visualize=not args.smoke, logger=logger,
                   device=dev)
    if ckpt is not None:
        ckpt.close()
    if writer is not None:
        writer.close()
    logger.info(f"done; best val loss {history['best_val_loss']:.6f}")
    return 0


def resume(out: str, state, logger):
    """``(state, epoch, batch)``: the latest checkpoint under ``out`` (every
    rank reads the one rank 0 wrote, before any rank trains), resumed at
    the exact (epoch, batch) it recorded, step-granular (the reference
    resumes per epoch only); without one, the state at epoch 1, batch 0."""
    if not os.path.isdir(os.path.join(out, "models")):
        return state, 1, 0
    restored, step, progress = Checkpointer(out).restore_latest(state)
    if step is None:
        return state, 1, 0
    logger.info(f"resumed from checkpoint at step {step} "
                f"(epoch {progress['epoch']}, batch {progress['batch']})")
    return restored, progress["epoch"], progress["batch"]


if __name__ == "__main__":
    raise SystemExit(main())

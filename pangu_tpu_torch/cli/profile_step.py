"""Profiling harness: time and trace the forward or the train step on one
device.  Per-step wall-clock statistics (``utils/logging.py::StepTimer``,
each step ended by a device synchronise) and, with ``--trace DIR``, a
``torch.profiler`` Chrome trace ``DIR/trace.json`` of the timed steps
(CPU activity, and CUDA activity on a card), viewable in Perfetto or
``chrome://tracing``.  One warm-up step (the kernel build included) runs
first and is not timed.

Usage:
  python -m pangu_tpu_torch.cli.profile_step --bf16            # forward
  python -m pangu_tpu_torch.cli.profile_step --bf16 --train \\
      --trace /tmp/prof                                     # train step
  python -m pangu_tpu_torch.cli.profile_step --device cpu --tiny   # smoke
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.utils.logging import StepTimer, profile_trace


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 params and activations, tanh GELU (the "
                        "perf config)")
    p.add_argument("--train", action="store_true",
                   help="profile the train step (forward, backward, Adam)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler trace.json into this "
                        "directory")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (default: the card; raises where there is '
                        'none) or "cpu" (the plain versions)')
    args = p.parse_args(argv)

    from pangu_tpu_torch.config import PANGU_24, TINY, TrainConfig
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine import train as T
    from pangu_tpu_torch.models import pangu

    dev = _device.resolve(args.device)
    cfg = TINY if args.tiny else PANGU_24
    cfg = dataclasses.replace(
        cfg,
        param_dtype="bfloat16" if args.bf16 else cfg.param_dtype,
        compute_dtype="bfloat16" if args.bf16 else cfg.compute_dtype,
        gelu="tanh" if args.bf16 else cfg.gelu, remat=args.train)

    params = pangu.init_params(torch.Generator().manual_seed(0), cfg,
                               device=dev)
    consts = to_device(synthetic_constants(cfg), dev)
    rng = np.random.default_rng(0)
    batch = {
        "upper": torch.as_tensor(rng.normal(size=(
            args.batch, cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon)
        ).astype(np.float32)).to(dev),
        "surface": torch.as_tensor(rng.normal(size=(
            args.batch, cfg.surface_vars, cfg.lat, cfg.lon)
        ).astype(np.float32)).to(dev),
    }
    print(pangu.summarize(params, cfg))

    if args.train:
        tcfg = TrainConfig()
        batch["target_upper"] = batch["upper"]
        batch["target_surface"] = batch["surface"]
        opt = T.make_optimizer(tcfg, steps_per_epoch=100)
        state = T.create_train_state(params, opt)
        step = T.make_train_step(cfg, tcfg, consts, opt, device=dev)
        seeds = iter(range(1, 1 << 30))

        def run():
            nonlocal state
            state, m = step(state, batch, next(seeds))
            return m["loss"]
    else:
        def run():
            with torch.no_grad():
                return pangu.forward(params, batch["upper"], batch["surface"],
                                     consts, cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()                       # warm-up: the kernel build, allocations
    sync()
    timer = StepTimer(window=max(args.steps, 1))
    with profile_trace(args.trace):
        for _ in range(args.steps):
            timer.start()
            run()
            sync()
            timer.stop()
    kind = "train" if args.train else "forward"
    print(f"{kind} step: mean {timer.mean_ms:.1f} ms over {args.steps} steps "
          f"(min {1e3 * min(timer.times):.1f}, max "
          f"{1e3 * max(timer.times):.1f}) on {dev}")
    if args.trace:
        print(f"trace written to {args.trace}/trace.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

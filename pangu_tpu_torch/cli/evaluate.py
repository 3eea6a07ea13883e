"""Single-step evaluation sweep: loads weights, scores the test window with
the lat-weighted RMSE / ACC, writes the 12 CSVs (and the four-panel PNGs
unless ``--no-viz``) under ``<output_path>/<type_net>/<horizon>/``.

Usage:
  python -m pangu_tpu_torch.cli.evaluate --type_net eval24 \\
      --pretrained /path/pangu_weather_24_torch.pth
  python -m pangu_tpu_torch.cli.evaluate --device cpu --tiny --synthetic \\
      --no-viz --limit 1
  torchrun --nproc_per_node 6 -m pangu_tpu_torch.cli.evaluate --bf16 \\
      --no-viz                        # one (dp 1, sp 3, tp 2) mesh

Under a launch of N ranks each rank serves its shard of the mesh; rank 0
writes the CSVs, figures and the log.
"""

from __future__ import annotations

import os
import time

from pangu_tpu_torch import _device
from pangu_tpu_torch.cli import common
from pangu_tpu_torch.engine import evaluate as E
from pangu_tpu_torch.parallel import sharding


def main(argv=None):
    p = common.base_parser(__doc__)
    p.add_argument("--no-viz", action="store_true")
    p.add_argument("--limit", type=int, default=0,
                   help="score at most N batches (0 = all)")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    mesh = common.setup_mesh(cfg, args.device)
    if mesh is None:            # a rank the mesh leaves idle
        return 0
    dev = _device.resolve(args.device)
    out, logger = common.run_dirs(cfg, args.type_net)

    constants = common.load_constants_device(cfg, args.synthetic, dev)
    params = sharding.shard_params(common.load_params(args, cfg), mesh)
    _, loaders = common.make_loaders(cfg, args.synthetic, dev)

    stats = {"samples": 0, "load_s": 0.0, "device_s": 0.0}
    t0 = time.perf_counter()
    with sharding.use_mesh(mesh):
        tables = E.evaluate(
            params, common.timed_batches(loaders["test"].epoch(0), args.limit,
                                         stats),
            cfg, constants, res_path=out if common.writes() else None,
            visualize=not args.no_viz, logger=logger, device=dev,
            timing=stats)
    if common.writes():
        common.log_timing(logger, stats, time.perf_counter() - t0)
        n = len(next(iter(tables.values())))
        logger.info(f"scored {n} samples -> {os.path.join(out, 'csv')} "
                    f"(mesh {mesh.cfg})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

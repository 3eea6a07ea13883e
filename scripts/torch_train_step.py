#!/usr/bin/env python3
"""Time the port's bf16 window-major train step (Pangu-24 at full width and
depth, batch 1, the perf config with the edge kernels, Adam included), its
served 24 h steps (full-step and token-space rollouts, and the
``block_layout="v2"`` full step) and its served per-block step on one CUDA
card, for the copy of the port in a given directory, so that two versions
compare in one call.

    python3 scripts/torch_train_step.py [--repo DIR] [--steps N]

``--repo`` (default: this checkout) is the directory whose
``pangu_tpu_torch`` is imported.  After two warm-up steps, each of ``--steps``
train steps and served per-block steps (``forward`` with
``lora_fused=False`` on rank-16 adapters on each stage's first block, as
chip_smoke.py phase 8b) is timed alone on the host clock, ending in
``torch.cuda.synchronize()``; so is each of ``--steps`` 3-step rollouts,
full-step, full-step with the edge kernels, token-space with the edge
kernels (chip_smoke.py phases 4a-b) and the v2 full step (phase 7c; its
trunk runs the canonical DownSample and UpSample), each time divided by 3:
ms a chained step.  Printed: every time, the median, and the peak memory
of the train steps.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import pangu_tpu_torch
    if Path(pangu_tpu_torch.__file__).resolve().parent.parent != repo:
        raise RuntimeError(f"imported {pangu_tpu_torch.__file__}, not {repo}")
    from pangu_tpu_torch import _build
    from pangu_tpu_torch.config import PANGU_24, TrainConfig
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine.rollout import make_rollout
    from pangu_tpu_torch.engine.train import (create_train_state,
                                              make_optimizer, make_train_step)
    from pangu_tpu_torch.models import lora, pangu

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"repo {repo}  torch {torch.__version__}  card: {smi}")
    _build.build()
    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    consts = to_device(synthetic_constants(PANGU_24, seed=0), dev)
    g = torch.Generator(device=dev).manual_seed(2)

    def field(*shape, m):
        return (consts[f"{m}_mean"][None] + consts[f"{m}_std"][None]
                * torch.randn(shape, generator=g, device=dev))

    up = (1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon)
    sf = (1, 4, PANGU_24.lat, PANGU_24.lon)
    batch = {"upper": field(*up, m="upper"), "surface": field(*sf, m="surface"),
             "target_upper": field(*up, m="upper"),
             "target_surface": field(*sf, m="surface")}

    def timed(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    params = pangu.init_params(torch.Generator().manual_seed(0), perf,
                               device=dev)
    tcfg = TrainConfig()
    opt = make_optimizer(tcfg)
    cfg = dataclasses.replace(perf, edge_kernels=True)
    holder = [create_train_state(params, opt)]
    step = make_train_step(cfg, tcfg, consts, opt, device=dev)

    def train():
        holder[0], _ = step(holder[0], batch, 10)

    timed(train, 2)
    torch.cuda.reset_peak_memory_stats()
    train_ms = timed(train, args.steps)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ms: {[round(t, 1) for t in train_ms]}; median "
          f"{statistics.median(train_ms):.1f}; peak {peak / 2**30:.2f} GiB")
    del holder, step, opt
    torch.cuda.empty_cache()

    served_steps = {}
    for label, rcfg, token in (("full-step", perf, False),
                               ("full-step, edge kernels", cfg, False),
                               ("token-space", cfg, True),
                               ("v2 full-step",
                                dataclasses.replace(perf, block_layout="v2"),
                                False)):
        rollout = make_rollout(rcfg, consts, 3, token_space=token, device=dev)

        def run():
            rollout(params, batch["upper"], batch["surface"])

        timed(run, 1)
        served_steps[label] = [t / 3 for t in timed(run, args.steps)]
        ms = served_steps[label]
        print(f"served {label} ms a step (3-step rollouts): "
              f"{[round(t, 2) for t in ms]}; median "
              f"{statistics.median(ms):.2f}")
    del rollout
    torch.cuda.empty_cache()

    tree = lora.init_lora(g, pangu.init_params(
        torch.Generator().manual_seed(0), perf, device=dev), rank=16,
        alpha=16.0)
    for sp in tree["stages"]:
        sp["blocks"] = [sp["blocks"][0]] + [lora.strip_lora(bp)
                                            for bp in sp["blocks"][1:]]
    tree["downsample"] = lora.strip_lora(tree["downsample"])
    tree["upsample"] = lora.strip_lora(tree["upsample"])
    for bp in (sp["blocks"][0] for sp in tree["stages"]):
        for site in (bp["attn"]["qkv"], bp["attn"]["proj"], bp["mlp"]["fc1"],
                     bp["mlp"]["fc2"]):
            site["lora_b"] = (0.02 * torch.randn(
                site["lora_b"].shape, generator=g, device=dev)).to(
                    site["lora_b"].dtype)
    cfg_pb = dataclasses.replace(perf, lora_fused=False)

    def served():
        with torch.no_grad():
            pangu.forward(tree, batch["upper"], batch["surface"], consts,
                          cfg_pb, device=dev)

    timed(served, 1)
    served_ms = timed(served, args.steps)
    print(f"served per-block step ms: {[round(t, 1) for t in served_ms]}; "
          f"median {statistics.median(served_ms):.1f}")
    print(json.dumps({"repo": str(repo), "card": smi,
                      "train_ms": train_ms, "train_peak_bytes": peak,
                      "served_step_ms": served_steps,
                      "served_per_block_ms": served_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

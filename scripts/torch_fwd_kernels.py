#!/usr/bin/env python3
"""Time the port's bf16 forward block kernel (every entry of
``csrc/block_wm.cu``) and grid attention forward (``csrc/grid_attn.cu``) at
the full-width Pangu-24 shapes on one CUDA card, for the copy of the port
in a given directory, so that two versions compare in one call.

    python3 scripts/torch_fwd_kernels.py [--repo DIR] [--reps N] [--split]

``--repo`` (default: this checkout) is the directory whose
``pangu_tpu_torch`` is imported.  Per case: the error against the plain
version (max |kernel - plain| / max |plain|, gate 2^-6), whether two runs
agree bit for bit, ms per launch (CUDA events over ``--reps`` launches
after one warm-up) and the bound of chip_smoke.py.  ``--split``: one
stage-0 block and one stage-0 grid attention by class of kernel
(``torch.profiler``: products, attention, row passes).  The last line is
one JSON object of the times.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its timing helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_kernels: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    cs = _chip_smoke()
    import pangu_tpu_torch
    if Path(pangu_tpu_torch.__file__).resolve().parent.parent != repo:
        raise RuntimeError(f"imported {pangu_tpu_torch.__file__}, not {repo}")
    from pangu_tpu_torch import _build
    from pangu_tpu_torch.config import PANGU_24, _pick_gh
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_canon,
                                                    block_wm_canon_plain,
                                                    block_wm_group,
                                                    block_wm_plain)
    from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                      block_noroll_plain,
                                                      grid_attention,
                                                      grid_attention_plain)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"repo {repo}  torch {torch.__version__}  card: {smi}")
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.2f} s")

    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    params = pangu.init_params(torch.Generator().manual_seed(0), perf,
                               device=dev)
    g0, g1 = PANGU_24.stage(0), PANGU_24.stage(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    half, neg = (1, 3, 6), (-1, -3, -6)
    gh = _pick_gh(g1.h_padded // g1.window[1], perf.lat_group)

    def storage(geom):
        wz, wh, ww = geom.window
        return torch.randn((1, geom.z // wz, geom.h_padded // wh,
                            geom.w // ww, wz * wh * ww, geom.dim),
                           generator=gen, device=dev).to(bf)

    def grid(geom):
        x = torch.randn((1, geom.z, geom.h_padded, geom.w, geom.dim),
                        generator=gen, device=dev).to(bf)
        x[:, :, geom.h:] = 0
        return x

    def ids_of(geom):
        return torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                                 geom.window), device=dev)

    def cost(bp, x, geom):   # chip_smoke.py's block_cost on any layout
        rows, c, n = x.numel() // geom.dim, geom.dim, geom.window_tokens
        w = sum(t.numel() for t in cs.leaves(bp) if t.dim() < 4) * 2
        return (2 * rows * c * (12 * c + 2 * n),
                2 * cs.nbytes(x) + cs.nbytes(bp["attn"]["bias_table"]) + w)

    s0 = params["stages"][0]["blocks"][1]
    s1 = params["stages"][1]["blocks"][1]
    drop = torch.tensor([[0.8, 1.25]], device=dev)
    cases = []   # (name, label, kernel, plain, (flops, bytes))
    x = storage(g0)
    cases += [("block_wm", "stage 0 shifted",
               lambda x=x: block_wm(s0, x, g0, half, 3, ids_of(g0), True),
               lambda x=x: block_wm_plain(s0, x, g0, half, 3, ids_of(g0), True),
               cost(s0, x, g0)),
              ("block_wm drop", "stage 0 shifted, scales (0.8, 1.25)",
               lambda x=x: block_wm(s0, x, g0, half, 3, ids_of(g0), True, drop),
               lambda x=x: block_wm_plain(s0, x, g0, half, 3, ids_of(g0), True,
                                          drop), cost(s0, x, g0)),
              ("block_wm_canon", "stage 0 canon out, shifted",
               lambda x=x: block_wm_canon(s0, x, g0, half, 3, ids_of(g0), True,
                                          out_layout="canon"),
               lambda x=x: block_wm_canon_plain(s0, x, g0, half, 3,
                                                ids_of(g0), True, "wm",
                                                "canon"), cost(s0, x, g0))]
    x = storage(g1)
    cases += [("block_wm", "stage 1 shifted",
               lambda x=x: block_wm(s1, x, g1, half, 3, ids_of(g1), True),
               lambda x=x: block_wm_plain(s1, x, g1, half, 3, ids_of(g1), True),
               cost(s1, x, g1)),
              ("block_wm_group", f"stage 1 shifted, gh {gh}",
               lambda x=x: block_wm_group(s1, x, g1, half, 3, ids_of(g1), True,
                                          gh),
               lambda x=x: block_wm_plain(s1, x, g1, half, 3, ids_of(g1), True),
               cost(s1, x, g1))]
    x = grid(g0)
    cases += [("block_v2", "stage 0 shifted",
               lambda x=x: block_v2(s0, x, g0, half, 3, ids_of(g0), True),
               lambda x=x: block_v2_plain(s0, x, g0, half, 3, ids_of(g0), True),
               cost(s0, x, g0)),
              ("block_noroll_fused", "stage 0, padded grid",
               lambda x=x: block_noroll_fused(s0, x, g0, True),
               lambda x=x: block_noroll_plain(s0, x, g0, True), cost(s0, x, g0))]
    for label, geom, bp, ids in (("stage 0, region ids", g0, s0, ids_of(g0)),
                                 ("stage 1, no ids", g1, s1, None)):
        x = grid(geom)
        at = bp["attn"]
        w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
             at["proj"]["bias"], at["bias_table"])
        rows, c, n = x.numel() // geom.dim, geom.dim, geom.window_tokens
        cases.append(("grid_attention", label,
                      lambda x=x, w=w, g=geom, i=ids:
                          grid_attention(x, *w, g.window, i),
                      lambda x=x, w=w, g=geom, i=ids:
                          grid_attention_plain(x, *w, g.window, i),
                      (2 * rows * c * (4 * c + 2 * n),
                       2 * cs.nbytes(x) + cs.nbytes(*w))))

    times, ok = {}, True
    for name, label, kern, plain, (flops, byts) in cases:
        got, want = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        err, rel = cs.rel_err(got, want)
        same = bool(torch.equal(got, again))
        del got, want, again
        ms = cs.time_ms(kern, args.reps)
        bound_ms, by = cs.bound(flops, byts, bf)
        good = rel <= cs.TOL[bf] and same
        ok &= good
        times[f"{name} {label}"] = ms
        print(f"{name:18s} {label:36s} rel {rel:.3e} bit-identical {same} "
              f"{'ok' if good else 'FAIL'}  kernel {ms:.3f} ms  bound "
              f"{bound_ms:.3f} ms ({by})", flush=True)
    if args.split:
        x = storage(g0)
        print("block_wm stage 0 shifted bf16 by class:", cs.fwd_breakdown(
            lambda: block_wm(s0, x, g0, half, 3, ids_of(g0), True),
            cs.block_fwd_work(x.numel() // g0.dim, g0.dim,
                              4 * g0.dim, g0.window_tokens)))
        x = grid(g0)
        at = s0["attn"]
        w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
             at["proj"]["bias"], at["bias_table"])
        print("grid_attention stage 0 bf16 by class:", cs.fwd_breakdown(
            lambda: grid_attention(x, *w, g0.window, ids_of(g0)),
            cs.grid_fwd_work(x.numel() // g0.dim, g0.dim, g0.window_tokens)))
    print(json.dumps({"repo": str(repo), "card": smi, "ms": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``pangu_tpu_torch``) on one CUDA
card, and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each with its wall seconds:
  1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
  2. build: nvcc compiles ``pangu_tpu_torch/csrc/*.cu`` into one library;
  3. each kernel against its plain PyTorch version on the card, at the
     full-width Pangu-24 shapes the served step gives it, in float32 and bf16:
     error, time per launch, the plain version's time and the card's bound;
     then one full-width float32 forward, kernels against plain versions;
  4. the main path: a 2-step chained rollout of Pangu-24 in the perf config
     (bf16 params and compute, tanh GELU, float32 LayerNorm statistics and
     softmax), batch 1, random weights and synthetic constants from a seed.
     The launch counters, set to 0 just before it, must read 2 x (16 blocks,
     1 DownSample, 1 UpSample); step 1 must match the plain path;
  5. where one step's time goes: embed, trunk, recovery (CUDA events).

Every failed check raises, and the script exits nonzero.  The last lines are
the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository beside it, it exits nonzero and prints no result.

Error measure throughout: max |kernel - plain| / max |plain|.  Tolerances:
1e-4 for one kernel in float32 and 1e-3 for the whole float32 forward
(float32 reassociation, amplified by the LayerNorms and compounded over 18
kernel units); 2**-6 for one kernel in bf16 (a few bf16 ulps: a value that
rounds one way in one version and the other way in the other moves by an ulp
and the difference propagates) and 2**-4 for the whole bf16 step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12,      # dense tensor-core bf16
                   torch.float32: 67e12}        # float32 outside tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
TOL_FORWARD = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -4}
SEED = 0
STEPS = 2


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"-- {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def rel_err(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def to_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dtype(v, dtype) for v in tree]
    return tree.to(dtype)


def bound(flops, nbytes_, dtype):
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pangu_tpu_torch import _build, ops
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.data.constants import (denorm_data, norm_data,
                                                synthetic_constants, to_device)
    from pangu_tpu_torch.engine.rollout import make_rollout, single_step
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.models import layers as L
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_plain,
                                                    from_window_major,
                                                    to_window_major,
                                                    wm_to_canonical)
    from pangu_tpu_torch.ops.updown_wm import (down_sample_wm,
                                               down_sample_wm_plain,
                                               up_sample_wm, up_sample_wm_plain)

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. environment -------------------------------------------------
    t0 = phase("environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print("nvcc:", nvcc.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    smi = smi.splitlines()[0]
    print("card:", smi)
    done("environment", t0)

    # ---- 2. build ---------------------------------------------------------
    t0 = phase("build")
    lib_path = _build.build()
    _build.library()
    print(f"built {os.path.relpath(lib_path)}")
    done("build", t0)

    # ---- 3. kernels against their plain versions --------------------------
    t0 = phase("kernels vs plain versions, full width")
    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    params = pangu.init_params(torch.Generator().manual_seed(SEED), perf,
                               device=dev)
    print(f"params: {pangu.param_count(params):,} ({perf.param_dtype})")
    g0, g1, g2, g3 = (PANGU_24.stage(i) for i in range(4))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def storage(geom, dtype):
        wz, wh, ww = geom.window
        shape = (1, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                 wz * wh * ww, geom.dim)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ids_of(geom):
        return torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                                 geom.window), device=dev)

    def weight_bytes(p, dtype):
        n = sum(t.numel() for t in leaves(p) if t.dim() < 4)   # not the table
        return n * torch.tensor([], dtype=dtype).element_size()

    def block_cost(bp, xs, ids):
        b, nz, nlat, nlon, n, c = xs.shape
        flops = 2 * b * nz * nlat * nlon * n * c * (4 * c + 2 * n + 8 * c)
        byts = (2 * nbytes(xs) + nbytes(bp["attn"]["bias_table"])
                + weight_bytes(bp, xs.dtype)
                + (nbytes(ids) if ids is not None else 0))
        return flops, byts

    def rows(g):          # window-major storage rows, latitude padding included
        return g.z * g.h_padded * g.w

    half = (1, 3, 6)
    cases = []  # (name, label, dtype, flops, bytes, kernel, plain, view)
    for dtype in (torch.float32, torch.bfloat16):
        tanh = dtype == torch.bfloat16
        pdt = to_dtype({"s0": params["stages"][0]["blocks"][1],
                        "s1": params["stages"][1]["blocks"][1],
                        "down": params["downsample"],
                        "up": params["upsample"]}, dtype)
        for label, geom, bp, delta, canon, ids in (
                ("stage 0 unshifted", g0, pdt["s0"], (0, 0, 0), 0, None),
                ("stage 0 shifted", g0, pdt["s0"], half, 3, ids_of(g0)),
                ("stage 1 shifted", g1, pdt["s1"], half, 3, ids_of(g1))):
            xs = storage(geom, dtype)
            flops, byts = block_cost(bp, xs, ids)
            cases.append((
                "block_wm", label, dtype, flops, byts,
                lambda bp=bp, xs=xs, geom=geom, d=delta, c=canon, i=ids, t=tanh:
                    block_wm(bp, xs, geom, d, c, i, t),
                lambda bp=bp, xs=xs, geom=geom, d=delta, c=canon, i=ids, t=tanh:
                    block_wm_plain(bp, xs, geom, d, c, i, t),
                lambda out: out))
        isz = torch.tensor([], dtype=dtype).element_size()
        xs = storage(g0, dtype)
        c = g0.dim
        cases.append((       # work: the valid stage-1 rows; bytes: in + out
            "down_sample_wm", "stage 0 -> 1, off (1, 3, 6)", dtype,
            2 * (g1.z * g1.h * g1.w) * 4 * c * 2 * c,
            nbytes(xs) + rows(g1) * 2 * c * isz + weight_bytes(pdt["down"], dtype),
            lambda xs=xs, p=pdt["down"]: down_sample_wm(p, xs, g0, g1, half),
            lambda xs=xs, p=pdt["down"]: down_sample_wm_plain(p, xs, g0, g1, half),
            lambda out: out))
        xs = storage(g2, dtype)
        c_in, c_out = g2.dim, g3.dim
        cases.append((       # work: the input rows that feed valid output rows
            "up_sample_wm", "stage 2 -> 3, off (1, 3, 6), valid rows", dtype,
            2 * (g2.z * -(-g3.h // 2) * g2.w) * c_in * 4 * c_out
            + 2 * (g3.z * g3.h * g3.w) * c_out * c_out,
            nbytes(xs) + rows(g3) * c_out * isz + weight_bytes(pdt["up"], dtype),
            lambda xs=xs, p=pdt["up"]: up_sample_wm(p, xs, g2, g3, half),
            lambda xs=xs, p=pdt["up"]: up_sample_wm_plain(p, xs, g2, g3, half),
            lambda out: from_window_major(out, g3.window)[:, :, :g3.h]))

    records = {}
    for name, label, dtype, flops, byts, kern, plain, view in cases:
        got, want = view(kern()), view(plain())
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        del got, want
        ms = time_ms(kern, 3)
        plain_ms = time_ms(plain, 2)
        bound_ms, bound_by = bound(flops, byts, dtype)
        ok = rel <= TOL[dtype]
        print(f"{name:15s} {label:38s} {str(dtype):15s} max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol {TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} {dtype}: rel err {rel:.3e}")
        if dtype == torch.bfloat16 and (name not in records
                                        or label == "stage 0 shifted"):
            records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "at": f"{label}, bf16"}

    consts = synthetic_constants(PANGU_24, seed=SEED)
    consts_dev = to_device(consts, dev)

    def state(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        u = (consts_dev["upper_mean"][None] + consts_dev["upper_std"][None]
             * torch.randn((1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                           generator=g, device=dev))
        s = (consts_dev["surface_mean"][None] + consts_dev["surface_std"][None]
             * torch.randn((1, 4, PANGU_24.lat, PANGU_24.lon), generator=g,
                           device=dev))
        return u, s

    u0, s0 = state(SEED + 2)
    params32 = to_dtype(params, torch.float32)
    cfg32 = dataclasses.replace(PANGU_24, gelu="erf")
    got = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev)
    want = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev,
                         kernels=False)
    for part, a, b in zip(("upper", "surface"), got, want):
        err, rel = rel_err(a, b)
        print(f"forward float32 {part}: max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {TOL_FORWARD[torch.float32]:.1e})")
        if rel > TOL_FORWARD[torch.float32]:
            raise AssertionError(f"float32 forward {part}: rel err {rel:.3e}")
    del params32, got, want
    torch.cuda.empty_cache()
    done("kernels vs plain versions, full width", t0)

    # ---- 4. the main path: a chained rollout ------------------------------
    t0 = phase(f"{STEPS}-step rollout, Pangu-24 perf config")
    rollout = make_rollout(perf, consts, STEPS, return_trajectory=True,
                           device=dev)
    rollout(params, u0, s0)                     # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_run = time.perf_counter()
    _, (ut, st) = rollout(params, u0, s0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_run) * 1e3 / STEPS
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"launches {counts}")
    want_counts = {"block_wm": STEPS * PANGU_24.total_blocks,
                   "down_sample_wm": STEPS, "up_sample_wm": STEPS}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts} != {want_counts}")
    if ut.shape != (STEPS, 1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon) \
            or st.shape != (STEPS, 1, 4, PANGU_24.lat, PANGU_24.lon):
        raise AssertionError(f"trajectory shapes {ut.shape} {st.shape}")
    if not (torch.isfinite(ut).all() and torch.isfinite(st).all()):
        raise AssertionError("rollout output is not finite")
    pu, ps = single_step(params, u0, s0, consts_dev, perf, device=dev,
                         kernels=False)
    for part, a, b in zip(("upper", "surface"),
                          norm_data(ut[0], st[0], consts_dev),
                          norm_data(pu, ps, consts_dev)):
        err, rel = rel_err(a, b)
        mean = float((a - b).abs().mean())
        print(f"step 1 bf16 {part} vs plain path: max_abs_err {err:.3e} rel "
              f"{rel:.3e} mean_abs_err {mean:.3e} "
              f"(tol {TOL_FORWARD[torch.bfloat16]:.1e})")
        if rel > TOL_FORWARD[torch.bfloat16]:
            raise AssertionError(f"bf16 step 1 {part}: rel err {rel:.3e}")
    print(f"rollout: {step_ms:.1f} ms per step ({STEPS} steps, batch 1, bf16), "
          f"peak memory {peak / 2**30:.2f} GiB")
    done(f"{STEPS}-step rollout, Pangu-24 perf config", t0)

    # ---- 5. where one step's time goes -------------------------------------
    t0 = phase("step breakdown (CUDA events, 3 reps each)")
    g = perf.stage(0)
    cdt = torch.bfloat16

    def embed():
        x = L.patch_embed(params["patch_embed"], u0.to(cdt), s0.to(cdt),
                          consts_dev, perf)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, g.h_padded - x.shape[2]))
        return to_window_major(x, g.window).contiguous()

    xs = embed()
    trunk = lambda: pangu.forward_core_wm(params, xs, perf)  # noqa: E731
    skip, dec, off = trunk()

    def recover():
        out = L.patch_recovery(params["patch_recovery"],
                               (wm_to_canonical(skip, off, g),
                                wm_to_canonical(dec, off, g)), perf)
        return denorm_data(*out, consts_dev)

    parts = {"embed + to_window_major": time_ms(embed, 3),
             "trunk (16 blocks, down, up)": time_ms(trunk, 3),
             "canonicalise + recovery + denorm": time_ms(recover, 3)}
    for part, ms in parts.items():
        print(f"{part:34s} {ms:9.3f} ms  {100 * ms / step_ms:5.1f}% of the step")
    done("step breakdown (CUDA events, 3 reps each)", t0)

    sources = {"block_wm": ("pangu_tpu_torch/csrc/block_wm.cu",
                            "pangu_tpu/ops/earth_block_wm.py:358"),
               "down_sample_wm": ("pangu_tpu_torch/csrc/updown_wm.cu",
                                  "pangu_tpu/ops/updown_wm.py:169"),
               "up_sample_wm": ("pangu_tpu_torch/csrc/updown_wm.cu",
                                "pangu_tpu/ops/updown_wm.py:305")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **records[name], "library_ms": None}
               for name, (src, rep) in sources.items()]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"rollout": {"ms_per_step": step_ms, "steps": STEPS,
                                  "batch": 1, "peak_bytes": peak}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

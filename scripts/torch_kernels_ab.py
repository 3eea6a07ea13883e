#!/usr/bin/env python3
"""Time the port's redesigned bf16 kernels at the full-width Pangu-24
shapes on one CUDA card, for the copy of the port in a given directory, so
that two versions compare in one call: the forward block kernel (every
entry of ``csrc/block_wm.cu``), the grid attention forward
(``csrc/grid_attn.cu``), the block tail (``csrc/block_tail.cu``, tanh and
erf GELU), the recovery backward (``csrc/recovery_bwd.cu``, pair
offsets (1, 3, 6) and (0, 0, 0)), the window-major DownSample and
UpSample (``csrc/updown_wm.cu``, offsets (1, 3, 6) and (0, 0, 0)), the
token-space transition (``csrc/transition_wm.cu``) and the upper and
surface patch recovery (``csrc/recovery_wm.cu``), pair offsets (1, 3, 6)
and (0, 0, 0), the patch embed (``csrc/embed_wm.cu``, the wrapper with
its PyTorch prepass, on the bf16 state ``chip_smoke.py`` gives it), the
upper embed's weight gradient (``csrc/embed_dw.cu``, the wrapper with its
prepass, on a bf16 stage-0 cotangent and the physical field) and the
canonical UpSample and DownSample (``csrc/updown.cu``, stage 2 -> 3 and
0 -> 1 on the canonical grid) and the fused window attention
(``csrc/window_attn.cu``, ``window_attention_pallas``'s kernel on the
stage-0 and stage-1 windows, with and without the folded mask); the last
two in float32 too.

    python3 scripts/torch_kernels_ab.py [--repo DIR] [--reps N] [--split]
                                        [--only REGEX]

``--repo`` (default: this checkout) is the directory whose
``pangu_tpu_torch`` is imported.  Per case: the error against the plain
version (max |kernel - plain| / max |plain| over every output, gate 2^-6
in bf16, 1e-4 in float32), whether two runs agree bit for bit, the first
12 hex digits of the sha256 of the output's bytes (so that two versions'
bits compare across runs: the inputs are drawn the same way for every
``--repo``), ms per launch (CUDA events over ``--reps`` launches after one
warm-up) and the bound of chip_smoke.py.
``--split``: one stage-0 block, grid attention and tail, one recovery
backward, DownSample, UpSample, transition and upper and surface recovery
by class of kernel (``torch.profiler``, chip_smoke.py's classes; the edge
products' gather, product and epilogue are one kernel in both versions,
``edge_class``), and the embed wrapper split into its prepass (the
normalisation passes, the surface columns and products), the upper
product and the plane-0 copy (``embed_class``), the prepass's kernels
listed one by one, the weight gradient into its prepass, relayout, product
and split sum (``dw_class``), the canonical UpSample and DownSample into
their products and row passes and the fused window attention at stage 0
(region ids) into its products and attention.  The case ``embed_dw_upper
library`` times the library yardstick of the weight gradient
(``chip_smoke.embed_dw_library``: cuDNN's weight and bias gradient of the
equivalent Conv3d) and, apart, the relayout of its inputs into the layout
it takes.  ``--only``: the cases
(and splits) whose ``name label`` the regular expression finds, e.g.
``--only sample_wm`` or ``--only "embed_dw|up_sample stage"``.
The last line is one JSON object of the times.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import re
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
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    cs = _chip_smoke()
    import pangu_tpu_torch
    if Path(pangu_tpu_torch.__file__).resolve().parent.parent != repo:
        raise RuntimeError(f"imported {pangu_tpu_torch.__file__}, not {repo}")
    from pangu_tpu_torch import _build
    from pangu_tpu_torch.config import PANGU_24, _pick_gh
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine.transition_wm import (
        apply_transition_wm, apply_transition_wm_plain, build_transition_wm)
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.block_tail import (fused_block_tail,
                                                fused_block_tail_plain)
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_canon,
                                                    block_wm_canon_plain,
                                                    block_wm_group,
                                                    block_wm_plain)
    from pangu_tpu_torch.ops.embed_wm import (embed_dw_upper,
                                              embed_dw_upper_plain, embed_wm,
                                              embed_wm_plain)
    from pangu_tpu_torch.ops.recovery_wm import (recovery_bwd,
                                                 recovery_bwd_plain,
                                                 recovery_wm_surface,
                                                 recovery_wm_surface_plain,
                                                 recovery_wm_upper,
                                                 recovery_wm_upper_plain)
    from pangu_tpu_torch.models.layers import window_partition
    from pangu_tpu_torch.ops.updown import (down_sample, down_sample_plain,
                                            up_sample, up_sample_plain)
    from pangu_tpu_torch.ops.updown_wm import (down_sample_wm,
                                               down_sample_wm_plain,
                                               up_sample_wm, up_sample_wm_plain)
    from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                      block_noroll_plain,
                                                      grid_attention,
                                                      grid_attention_plain,
                                                      window_attention_fused,
                                                      window_attention_plain)

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

    tails = {}
    for i, bp in ((0, s0), (1, s1)):
        geom = PANGU_24.stage(i)
        tail = {k: bp[k] for k in ("norm1", "norm2", "mlp")}
        c, hidden = geom.dim, bp["mlp"]["fc1"]["kernel"].shape[-1]
        a, s = (torch.randn((1, geom.z, geom.h, geom.w, c), generator=gen,
                            device=dev).to(bf) for _ in range(2))
        rows = a.numel() // c
        tails[i] = (tail, a, s, rows, c, hidden)
        w = sum(t.numel() for t in cs.leaves(tail)) * 2
        for tanh, form in ((True, "tanh"), (False, "erf")):
            cases.append(("fused_block_tail",
                          f"stage {i}, cropped grid, {form}",
                          lambda p=tail, a=a, s=s, t=tanh:
                              fused_block_tail(p, a, s, t),
                          lambda p=tail, a=a, s=s, t=tanh:
                              fused_block_tail_plain(p, a, s, t),
                          (4 * rows * c * hidden, 3 * cs.nbytes(a) + w)))
    g3 = PANGU_24.stage(3)
    skip, dec = storage(g3), storage(g3)
    du = torch.randn((1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                     generator=gen, device=dev).to(bf)
    ds = torch.randn((1, 4, PANGU_24.lat, PANGU_24.lon), generator=gen,
                     device=dev).to(bf)
    pr = params["patch_recovery"]
    c3, rows_all = g3.dim, g3.z * g3.h_padded * g3.w
    kf = 5 * 32 * (g3.z - 1) * g3.h * g3.w + 4 * 16 * g3.h * g3.w
    rec_cost = (2 * rows_all * 160 * 2 * c3 + 2 * kf * 2 * c3,  # chip_smoke's
                cs.nbytes(du, ds) + 2 * cs.nbytes(skip)
                + sum(t.numel() for t in cs.leaves(pr)) * 2
                + 2 * rows_all * c3 * 2 + 4 * (2 * c3 + 1) * (160 + 64))
    for off in (half, (0, 0, 0)):
        cases.append(("recovery_bwd", f"off {off}",
                      lambda o=off: recovery_bwd(pr, skip, dec, du, ds, o,
                                                 PANGU_24),
                      lambda o=off: recovery_bwd_plain(pr, skip, dec, du, ds,
                                                       o, PANGU_24),
                      rec_cost))
    g2 = PANGU_24.stage(2)
    pd, pu = params["downsample"], params["upsample"]
    xd, xu = storage(g0), storage(g2)
    wd, wu = (sum(t.numel() for t in cs.leaves(p)) * 2 for p in (pd, pu))
    c, c_in, c_out = g0.dim, g2.dim, g3.dim
    down_cost = (2 * g1.z * g1.h * g1.w * 4 * c * 2 * c,   # chip_smoke's
                 cs.nbytes(xd) + g1.z * g1.h_padded * g1.w * 2 * c * 2 + wd)
    up_cost = (2 * g2.z * -(-g3.h // 2) * g2.w * c_in * 4 * c_out
               + 2 * g3.z * g3.h * g3.w * c_out * c_out,
               cs.nbytes(xu) + g3.z * g3.h_padded * g3.w * c_out * 2 + wu)
    for off in (half, (0, 0, 0)):
        cases += [("down_sample_wm", f"stage 0 -> 1, off {off}",
                   lambda o=off: down_sample_wm(pd, xd, g0, g1, o),
                   lambda o=off: down_sample_wm_plain(pd, xd, g0, g1, o),
                   down_cost),
                  ("up_sample_wm", f"stage 2 -> 3, off {off}",
                   lambda o=off: up_sample_wm(pu, xu, g2, g3, o),
                   lambda o=off: up_sample_wm_plain(pu, xu, g2, g3, o),
                   up_cost)]

    # the edge products on the rolled stage-3 exit pair (chip_smoke.py's
    # work: the real rows; bytes: their pair rows, the bias field or the
    # weights, the output)
    skip3, dec3 = storage(g3), storage(g3)
    consts = to_device(synthetic_constants(PANGU_24, seed=0), dev)
    tp = build_transition_wm(params, consts, perf)
    valid0 = g0.z * g0.h * g0.w
    upper_rows = (g0.z - 1) * g0.h * g0.w
    field_u = 5 * PANGU_24.levels * PANGU_24.lat * PANGU_24.lon
    field_s = 4 * PANGU_24.lat * PANGU_24.lon
    edge_cost = {
        "transition_wm": (2 * valid0 * 2 * c3 * c3,
                          3 * valid0 * c3 * 2 + 6 * 2 * c3 * c3 * 2
                          + rows_all * c3 * 2),
        "recovery_wm_upper": (2 * upper_rows * 2 * c3 * 160,
                              2 * upper_rows * c3 * 2
                              + sum(t.numel() for t in cs.leaves(pr["upper"]))
                              * 2 + field_u * 2),
        "recovery_wm_surface": (2 * g0.h * g0.w * 2 * c3 * 64,
                                2 * g0.h * g0.w * c3 * 2
                                + sum(t.numel() for t in
                                      cs.leaves(pr["surface"])) * 2
                                + field_s * 2)}
    for off in (half, (0, 0, 0)):
        cases += [("transition_wm", f"off {off}",
                   lambda o=off: apply_transition_wm(tp, skip3, dec3, g0, o),
                   lambda o=off: apply_transition_wm_plain(tp, skip3, dec3, g0,
                                                           o),
                   edge_cost["transition_wm"]),
                  ("recovery_wm_upper", f"off {off}",
                   lambda o=off: recovery_wm_upper(pr, skip3, dec3, o,
                                                   PANGU_24),
                   lambda o=off: recovery_wm_upper_plain(pr, skip3, dec3, o,
                                                         PANGU_24),
                   edge_cost["recovery_wm_upper"]),
                  ("recovery_wm_surface", f"off {off}",
                   lambda o=off: recovery_wm_surface(pr, skip3, dec3, o,
                                                     PANGU_24),
                   lambda o=off: recovery_wm_surface_plain(pr, skip3, dec3, o,
                                                           PANGU_24),
                   edge_cost["recovery_wm_surface"])]

    # the patch embed on chip_smoke.py's bf16 state (work: the upper-plane
    # rows; bytes: the fields and const_h in, the weights, wm storage out)
    pe = params["patch_embed"]
    ecfg = dataclasses.replace(PANGU_24, compute_dtype="bfloat16")
    ge = torch.Generator(device=dev).manual_seed(2)
    ue = (consts["upper_mean"][None] + consts["upper_std"][None]
          * torch.randn((1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                        generator=ge, device=dev)).to(bf)
    se = (consts["surface_mean"][None] + consts["surface_std"][None]
          * torch.randn((1, 4, PANGU_24.lat, PANGU_24.lon), generator=ge,
                        device=dev)).to(bf)
    flops_e = 2 * upper_rows * pe["upper"]["kernel"].shape[0] * c
    plane = g0.h_padded * g0.w * c * 2              # a token plane's storage
    cases.append(("embed_wm", "full width",
                  lambda: embed_wm(pe, ue, se, consts, ecfg),
                  lambda: embed_wm_plain(pe, ue, se, consts, ecfg),
                  (flops_e, cs.nbytes(ue, se) + consts["const_h"].numel() * 2
                   + sum(t.numel() for t in cs.leaves(pe)) * 2
                   + g0.z * plane)))
    embed_split = cs.embed_work(flops_e, cs.nbytes(ue),
                                consts["const_h"].numel() * 2,
                                g0.h * g0.w * c * 2, plane,
                                (g0.z - 1) * plane)

    # the upper embed's weight gradient on a bf16 stage-0 cotangent and the
    # physical field, as a bf16 train step gives it (work and bytes:
    # chip_smoke.py's phase-6 line), and the canonical UpSample (phase 3's
    # line); inputs from a generator of their own
    gb = torch.Generator(device=dev).manual_seed(3)
    wz, wh, ww = g0.window
    dxs = torch.randn((1, g0.z // wz, g0.h_padded // wh, g0.w // ww,
                       wz * wh * ww, c), generator=gb, device=dev).to(bf)
    uw = (consts["upper_mean"][None] + consts["upper_std"][None]
          * torch.randn((1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                        generator=gb, device=dev))
    k_up = pe["upper"]["kernel"].shape[0]
    n_ch = consts["const_h"].numel()
    cases.append(("embed_dw_upper", "full width",
                  lambda: embed_dw_upper(dxs, uw, consts, ecfg),
                  lambda: embed_dw_upper_plain(dxs, uw, consts, ecfg),
                  (2 * upper_rows * (k_up + 1) * c,
                   upper_rows * c * 2 + field_u * 4 + n_ch * 4
                   + (k_up + 1) * c * 4)))
    dw_split = cs.dw_work(dxs.numel() // c, k_up, c, field_u, n_ch)
    xc = torch.randn((1, g2.z, g2.h, g2.w, c_in), generator=gb,
                     device=dev).to(bf)
    cases.append(("up_sample", "stage 2 -> 3, canonical grid",
                  lambda: up_sample(pu, xc, g3.h),
                  lambda: up_sample_plain(pu, xc, g3.h),
                  (2 * g2.z * g2.h * g2.w * c_in * 4 * c_out
                   + 2 * g3.z * g3.h * g3.w * c_out * c_out,
                   cs.nbytes(xc) + g3.z * g3.h * g3.w * c_out * 2 + wu)))

    # the canonical DownSample (stage 0 -> 1, chip_smoke.py's phase-3 line)
    # and the fused window attention on the stage-0 (region ids and none)
    # and stage-1 windows (phase 9a's lines), bf16 and float32; inputs from
    # a generator of their own
    gw = torch.Generator(device=dev).manual_seed(4)
    pd32 = cs.to_dtype(pd, torch.float32)
    wins = {}
    for dt in (bf, torch.float32):
        tag = "" if dt == bf else ", float32"
        xd0 = torch.randn((1, g0.z, g0.h, g0.w, c), generator=gw,
                          device=dev).to(dt)
        p_d = pd if dt == bf else pd32
        cases.append(("down_sample", f"stage 0 -> 1, canonical grid{tag}",
                      lambda x=xd0, p=p_d: down_sample(p, x),
                      lambda x=xd0, p=p_d: down_sample_plain(p, x),
                      (2 * g1.z * g1.h * g1.w * 4 * c * 2 * c,
                       cs.nbytes(xd0) + g1.z * g1.h * g1.w * 2 * c
                       * xd0.element_size()
                       + sum(t.numel() for t in cs.leaves(p_d))
                       * xd0.element_size()), dt))
        for st, geom, bp, masked in (("stage 0", g0, s0, True),
                                     ("stage 0", g0, s0, False),
                                     ("stage 1", g1, s1, True)):
            at = bp["attn"]
            xw = window_partition(
                torch.randn((1, geom.z, geom.h_padded, geom.w, geom.dim),
                            generator=gw, device=dev).to(dt),
                geom.window).contiguous()
            bias = at["bias_table"].float()
            if masked:
                ids = ids_of(geom)
                bias = bias + torch.where(ids[:, None, :] != ids[:, :, None],
                                          -100.0, 0.0)[:, None]
            bias = bias.contiguous()
            w = [t.to(dt) for t in (at["qkv"]["kernel"], at["qkv"]["bias"],
                                    at["proj"]["kernel"], at["proj"]["bias"])]
            rows, cc, n = xw.numel() // geom.dim, geom.dim, geom.window_tokens
            label = (f"{st}, {'region ids' if masked else 'no ids'}{tag}")
            wins[label] = (xw, w, bias, rows, cc, n)
            cases.append(("window_attention_pallas", label,
                          lambda x=xw, w=w, b=bias:
                              window_attention_fused(x, *w, b),
                          lambda x=xw, w=w, b=bias:
                              window_attention_plain(x, *w, b),
                          (2 * rows * cc * (4 * cc + 2 * n),
                           2 * cs.nbytes(xw) + cs.nbytes(bias)
                           + sum(t.numel() for t in w) * xw.element_size()),
                          dt))

    def wanted(what):
        return re.search(args.only, what) is not None

    def digest(out):
        h = hashlib.sha256()
        for t in cs.flat(out):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    times, ok = {}, True
    for name, label, kern, plain, (flops, byts), *dtype in cases:
        dt = dtype[0] if dtype else bf
        if not wanted(f"{name} {label}"):
            continue
        got, want = kern(), plain()
        again = kern()
        torch.cuda.synchronize()
        rel = max(e[2] for e in cs.tree_errs(got, want))
        same = all(torch.equal(x, y) for x, y in zip(cs.flat(got),
                                                     cs.flat(again)))
        sha = digest(got)
        del got, want, again
        ms = cs.time_ms(kern, args.reps)
        bound_ms, by = cs.bound(flops, byts, dt)
        good = rel <= cs.TOL[dt] and same
        ok &= good
        times[f"{name} {label}"] = ms
        print(f"{name:18s} {label:36s} rel {rel:.3e} bit-identical {same} "
              f"sha {sha} {'ok' if good else 'FAIL'}  kernel {ms:.3f} ms  "
              f"bound {bound_ms:.3f} ms ({by})", flush=True)
    if wanted("embed_dw_upper library"):
        # cuDNN on the canonical layout: the cotangent's upper planes
        # channels-first, the normalised field padded with const_h
        un = ((uw.to(bf) - consts["upper_mean"].to(bf)[None])
              / consts["upper_std"].to(bf)[None]).contiguous()
        relayout, library = cs.embed_dw_library(
            dxs, un, consts["const_h"].to(bf), ecfg)
        x6, dy = relayout()
        rel = max(e[2] for e in cs.tree_errs(
            library(x6, dy), embed_dw_upper_plain(dxs, uw, consts, ecfg)))
        lib_ms = cs.time_ms(lambda: library(x6, dy), args.reps)
        relayout_ms = cs.time_ms(relayout, args.reps)
        times["embed_dw_upper library"] = lib_ms
        times["embed_dw_upper library relayout"] = relayout_ms
        print(f"embed_dw_upper library (cuDNN convolution_backward, weight "
              f"and bias, canonical layout): {lib_ms:.3f} ms, rel "
              f"{rel:.3e} against the plain version (its outputs bf16); "
              f"the relayout into its layout {relayout_ms:.3f} ms apart",
              flush=True)
        del un, x6, dy
    if args.split:
        xb, xg = storage(g0), grid(g0)
        xd0b = torch.randn((1, g0.z, g0.h, g0.w, c), generator=gw,
                           device=dev).to(bf)
        at = s0["attn"]
        w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
             at["proj"]["bias"], at["bias_table"])
        tail, a, s, rows, c, hidden = tails[0]
        r0, r1, r2, r3 = (g.z * g.h_padded * g.w for g in (g0, g1, g2, g3))
        splits = [   # (what, launch, work by class, classify)
            ("block_wm stage 0 shifted",
             lambda: block_wm(s0, xb, g0, half, 3, ids_of(g0), True),
             cs.block_fwd_work(xb.numel() // g0.dim, g0.dim, 4 * g0.dim,
                               g0.window_tokens), cs.fwd_class),
            ("grid_attention stage 0",
             lambda: grid_attention(xg, *w, g0.window, ids_of(g0)),
             cs.grid_fwd_work(xg.numel() // g0.dim, g0.dim, g0.window_tokens),
             cs.fwd_class),
            ("fused_block_tail stage 0",
             lambda: fused_block_tail(tail, a, s, True),
             cs.tail_work(rows, c, hidden), cs.fwd_class),
            ("recovery_bwd off (1, 3, 6)",
             lambda: recovery_bwd(pr, skip, dec, du, ds, half, PANGU_24),
             cs.recovery_work(rows_all, c3, 160, 64, du.numel() + ds.numel()),
             cs.recovery_class),
            ("down_sample_wm off (1, 3, 6)",
             lambda: down_sample_wm(pd, xd, g0, g1, half),
             cs.down_work(r0, r1, g0.dim), cs.fwd_class),
            ("up_sample_wm off (1, 3, 6)",
             lambda: up_sample_wm(pu, xu, g2, g3, half),
             cs.up_work(r2, r3, c_in, c_out), cs.fwd_class),
            ("transition_wm off (1, 3, 6)",
             lambda: apply_transition_wm(tp, skip3, dec3, g0, half),
             cs.edge_work(*edge_cost["transition_wm"]), cs.edge_class),
            ("recovery_wm_upper off (1, 3, 6)",
             lambda: recovery_wm_upper(pr, skip3, dec3, half, PANGU_24),
             cs.edge_work(*edge_cost["recovery_wm_upper"]), cs.edge_class),
            ("recovery_wm_surface off (1, 3, 6)",
             lambda: recovery_wm_surface(pr, skip3, dec3, half, PANGU_24),
             cs.edge_work(*edge_cost["recovery_wm_surface"]), cs.edge_class),
            ("embed_wm full width",
             lambda: embed_wm(pe, ue, se, consts, ecfg), embed_split,
             cs.embed_class),
            ("embed_dw_upper full width",
             lambda: embed_dw_upper(dxs, uw, consts, ecfg), dw_split,
             cs.dw_class),
            ("up_sample stage 2 -> 3, canonical grid",
             lambda: up_sample(pu, xc, g3.h),
             cs.up_work(g2.z * g2.h * g2.w, g3.z * g3.h * g3.w, c_in, c_out),
             cs.fwd_class),
            ("down_sample stage 0 -> 1, canonical grid",
             lambda: down_sample(pd, xd0b),
             cs.down_work(g0.z * g0.h * g0.w, g1.z * g1.h * g1.w, c),
             cs.fwd_class)]
        xw, w, bias, rows, cc, n = wins["stage 0, region ids"]
        splits.append(("window_attention_pallas stage 0, region ids",
                       lambda: window_attention_fused(xw, *w, bias),
                       cs.window_work(rows, cc, n), cs.fwd_class))
        for what, fn, work, classify in splits:
            if wanted(what):
                print(f"{what} bf16 by class:", cs.class_breakdown(
                    fn, work, classify, detail="prepass"
                    if classify in (cs.embed_class, cs.dw_class) else None))
    print(json.dumps({"repo": str(repo), "card": smi, "ms": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

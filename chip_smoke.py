#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``pangu_tpu_torch``) on one CUDA
card, and check it.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each with its wall seconds:
  1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
  2. build: nvcc compiles ``pangu_tpu_torch/csrc/*.cu`` into one library;
     the registers and spills ptxas reports for the bf16 sdpa kernels
     (tensor cores) and their launch plan at full width (shared memory,
     blocks per SM), and for the tensor-core products and attention
     (``csrc/mma_gemm.cuh``, ``csrc/wattn_mma.cuh``), those of the bf16
     forward (the block kernel's and the grid attention's objects, with
     their 16-byte row kernels), of the bf16 block tail and recovery
     backward (their objects' products, row passes, relayout and split
     sum), of the bf16 DownSample and UpSample (their products and
     gather + LayerNorm passes), of the bf16 transition, recovery
     (upper and surface) and embed (their tensor-core kernel) and of the
     bf16 upper embed weight gradient and canonical UpSample (relayout,
     products, split sum, gather + LayerNorm pass) and of the bf16
     canonical DownSample and fused window attention (their products,
     attention and gather + LayerNorm pass) on lines of their own;
  3. each kernel against its plain PyTorch version on the card, at the
     full-width Pangu-24 shapes the served paths give it, in float32 and bf16:
     error, time per launch, the plain version's time and the card's bound
     (the block wm -> wm, grouped at stage 1 (gh 2) beside the ungrouped one
     on the same input, and with a canonical input or output at stages 0
     and 1; DownSample / UpSample, window-major and canonical; the edge
     kernels: embed, transition and recovery upper / surface, the last three
     at the stage-end offsets (0, 0, 0) and the served (1, 3, 6)); a batch of
     8 through the stage-0 block, DownSample and UpSample (window-major and
     canonical), the transition, both recovery branches and the embed and
     of 16 through UpSample (its mix product then has more than 65,535 row
     tiles), the last sample
     against a batch-1 launch (bit for bit but the block's); then
     full-width float32 forwards, without and with the edge kernels,
     kernels against plain versions.  Every bf16 block entry, DownSample
     and UpSample (both), the transition, both recovery branches and the
     embed twice,
     bit for bit, and the grouped block equal to the ungrouped one on the
     same input; beside each bf16
     time of a redesigned row its earlier kernel's (``PREVIOUS_BF16_MS``);
     the float32 error lines of the block entries, the grid attention,
     DownSample and UpSample (both), the transition, the recovery, the
     embed and the fused window attention (here and in phases 6a, 7a, 8a,
     9a) equal to their earlier kernels'
     (``F32_BEFORE``, the float32 route being unchanged); one stage-0 bf16
     block and grid attention forward, DownSample (both), UpSample,
     transition and upper and surface recovery by class of kernel
     (``torch.profiler``:
     products, attention, row passes, each with its rate), and the embed
     wrapper by prepass, upper product and plane-0 copy; junk on the
     latitude-pad rows of the bf16 DownSample's and UpSample's input leaves
     their output bit-equal, whose pad rows are zeros, and junk on those of
     the rolled pair leaves the bf16 transition's and both recovery
     branches' outputs bit-equal; the bf16 window-major DownSample at
     offset (0, 0, 0) on the canonical grid bit-equal to the canonical
     DownSample on its real rows (one gather + LayerNorm kernel, two row
     maps);
  4. the main paths, Pangu-24 in the perf config (bf16 params and compute,
     tanh GELU, float32 LayerNorm statistics and softmax, lat_group 2),
     batch 1, random weights and synthetic constants from a seed, each driven
     with the launch counters set to 0 just before it and read just after:
     a. a 2-step full-step rollout with its trajectory: 2 x (4 blocks, 12
        grouped blocks, 1 DownSample, 1 UpSample); step 1 must match the
        plain path;
     b. a 3-step token-space rollout with the edge kernels: 12 blocks, 36
        grouped blocks, 3 DownSample, 3 UpSample, 1 embed, 2 transitions,
        1 recovery upper, 1 recovery surface; its final state must match the
        same rollout with plain versions and the 3-step full-step rollout;
        the 3-step full-step rollout with the edge kernels (the JAX
        package's default served step: per step the trunk, 1 embed, 1
        recovery upper, 1 recovery surface), timed, its final state against
        the same rollout with plain versions; then (not gates) the bf16
        drift of both rollouts against float32 over 3 and 7 chained steps;
     c. the hierarchical rollout, two parameter sets (seeds 0 and 1) as the
        24 h and 6 h models, horizon 30 h (schedule [24, 6]), full-step and
        token-space with the edge kernels: the launch counters, the final
        state against the plain path and token-space against full-step;
     d. ``forward(taps={})`` in float32 (the canonical-layout trunk: 8
        end-point blocks, 8 grouped blocks, 1 canonical DownSample and
        UpSample): its output against the window-major forward, every tap
        against the plain path;
  5. where the time goes: a full step (embed, trunk, recovery) and a
     token-space chained step (trunk, transition) (CUDA events);
  6. the training step, Pangu-24 at full width and depth, batch 1, edge
     kernels, targets the inputs of a second seeded state:
     a. the training kernels against their plain versions, float32 and
        bf16: the block with per-sample branch scales (``drop``) and the
        block backward at stages 0 and 1, shifted, scales from {0, 0.8,
        1.25} and without scales; the recovery backward at offset (1, 3,
        6) and (0, 0, 0); the upper embed weight gradient; the redesigned
        rows' earlier bf16 times beside the new ones (``PREVIOUS_BF16_MS``),
        the recovery backward's and the weight gradient's float32 lines
        equal to their first versions' (``F32_BEFORE``), and one stage-0
        bf16 block backward's, one bf16 recovery backward's (relayout,
        token-cotangent product, weight gradient, split sum) and one bf16
        upper embed weight gradient's (prepass, relayout, product, split
        sum) device time by class (``torch.profiler``); junk on the
        cotangent's token-lat pad rows and other values on its plane-0 rows
        leave the bf16 weight gradient bit-equal; its library column:
        cuDNN's weight and bias gradient of the equivalent Conv3d on the
        canonical layout, the relayout into that layout timed apart;
     b. the float32 train step (loss and every gradient) with the kernels
        against ``kernels=False``, the same scales, both paths
        back-propagating the same loss cotangent;
     c. 3 Adam steps in the perf config with the launch counters read per
        step (16 blocks with scales, 16 block backwards, 1 DownSample, 1
        UpSample, embed, embed weight gradient, recovery upper and surface,
        recovery backward), and two runs of one step's gradient on the same
        input, which must agree bit for bit;
  7. the rolled-coordinate trunk, ``block_layout="v2"``, at full width and
     depth:
     a. its kernels against their plain versions, float32 and bf16: the grid
        block at stages 0 and 1, shifted (half a window, region ids) and
        back (minus half a window), with and without branch scales; the grid
        attention and its backward at stage 0 with region ids and stage 1
        without;
     b. the float32 v2 forward against the plain path and against the
        window-major forward from the same params (16 grid blocks, 1
        DownSample, 1 UpSample);
     c. a 2-step v2 full-step rollout (step 1 against the plain path) and a
        3-step v2 token-space rollout (against the 3-step full-step one),
        perf config, per step 16 grid blocks, 1 DownSample, 1 UpSample and
        no other kernel;
     d. the float32 v2 train step, kernels against plain versions on the
        same loss cotangent; two runs of one bf16 step's gradient, bit for
        bit; 3 bf16 Adam steps with the launch counters read per step (16
        grid blocks with scales, 16 grid attentions, 16 grid attention
        backwards, 1 DownSample, 1 UpSample) and device time by kernel.

  8. the per-block path (``L.earth_block``) and LoRA, at full width and
     depth:
     a. its kernels against their plain versions, float32 and bf16: the
        no-roll block and the block tail at stages 0 and 1 (bf16 with the
        tanh and the erf GELU; its float32 lines equal to its first
        version's, its bf16 time beside the first version's, one stage-0
        bf16 tail by class: products, row passes), the windowed
        sdpa and its backward at stages 0 and 1 with and without the folded
        mask; two bf16 runs of each sdpa kernel, which must agree bit for
        bit; the sdpa and its backward beside ``scaled_dot_product_attention``
        and its backward at stages 0 and 1 (the library column only, never
        on a path);
     b. the served per-block step: ``forward`` with ``lora_fused=False`` on
        adapters (rank 16, B non-zero) on the first block of each stage
        only: per step 4 no-roll blocks, 8 grid attentions, 8 block tails, 1
        DownSample, 1 UpSample; float32 against the merged forward
        (``lora_fused=True``, the window-major trunk) and against
        ``kernels=False``, bf16 against ``kernels=False``;
     c. the per-block train step (``train_fused=False``, ``remat``): float32
        against the fused step with the same scales and against each other
        (``grid_bwd`` "pallas" and "xla") on a shared loss cotangent; 3 bf16
        Adam steps each, counters per step (the grid attention and its
        backward, or the sdpa and its backward);
     d. one bf16 ``block_layout="v2"`` train step with ``grid_bwd="xla"``;
     e. LoRA fine-tuning as ``cli/lora_tune.py`` sets it up (every site,
        rank 16, alpha 16): element-mode dropout 0.1 (unmerged, every site
        plain), feature-mode dropout 0.1 and dropout 0 (merged, the fused
        window-major trunk), 2 bf16 steps each; ``audit`` must show only
        LoRA factors and ``patch_recovery`` updated.
  9. the last kernel sites, the canonical training route and ``attn_impl``,
     at full width and depth:
     a. float32 and bf16 against the plain versions: the fused window
        attention (``window_attention_pallas``) forward on the stage-0
        windows (1, 30, 124, 144, 192) and the stage-1 windows (1, 15, 64,
        144, 384), with and without region ids (bf16 twice, bit for bit;
        each sample of a batch of 2 at stage 0 bit-equal to it run alone;
        one stage-0 launch by class: products, attention), and every
        gradient of its drop-in at stage 0; the block backward with a
        canonical end
        (``block_bwd_canon``: the first block reading the grid, the shifted
        last block reading its cotangent as the grid) at stages 0 and 1
        with branch scales, and the first block without; the grouped block
        with branch scales at stage 1, gh 2;
     b. the drop-in on the stage-0 windows of the embedded state, forward
        and every gradient: 1 fused attention, 1 sdpa, 1 sdpa backward;
     c. the canonical training route: adapters (rank 16) only at
        ``downsample.reduce``, ``upsample.expand`` and ``upsample.mix``,
        ``lora_fused=False``, so ``wm_core_supported`` is false and every
        stage trains through ``run_stage_train_wm(io canon)``: the float32
        step against the window-major trunk's from the same base params on
        one loss cotangent (B zero: the same function), then 3 bf16 Adam
        steps, per step 10 blocks and 6 canonical end-point blocks, 10 block
        backwards and 6 canonical ones;
     d. ``attn_impl="xla"``: the served step against "pallas" in bf16 and
        float32 and one bf16 train step, with no kernel launched.
 10. the command lines, Pangu-24 at full width (random weights from seed 0,
     synthetic ERA5 fields and constants, two test dates):
     a. ``init_params`` (float32, 276,659,936 parameters) through
        ``export_torch_state_dict`` into a reference ``.pth`` in a temporary
        directory, ``cli.convert_weights --dtype bfloat16`` into the port's
        params file, every leaf loaded back equal to the bf16 cast;
     b. ``cli.inference --bf16 --pallas --set model.gelu=tanh --horizon 48
        --limit 2 --synthetic --pretrained <file>``: 12 CSVs of 2 rows keyed
        by the target times, 13 level or 4 surface columns, every value
        finite and every ACC in [-1, 1]; launches 2 samples x 2 steps x the
        trunk (4 blocks, 12 grouped blocks, 1 DownSample, 1 UpSample);
     c. the same with ``--token-space --set model.edge_kernels=true``: per
        sample besides one embed, one transition and one recovery (upper
        and surface);
     d. ``cli.evaluate --limit 2 --no-viz`` twice, the CSVs byte-identical;
        ``engine.evaluate.make_score_step`` with the kernels against
        ``kernels=False`` on the first test batch, float32 (RMSE 1e-3
        relative, ACC 1e-3 absolute) and bf16 (2^-4); the score functions
        on the card against float64 numpy on the same outputs (RMSE 1e-5
        relative, ACC 1e-5 absolute);
     e. each run's wall seconds per sample, split into host loading and
        device rollout (CUDA events), which fastpack route loaded, the
        card's name and power limit.
 11. the sharded serving path, a world of ranks on the one card:
     a. row 5z alone (the transition on a tp z shard, ``z_base`` /
        ``nz_global``), float32 and bf16, at full width: the stage-0 pair at
        offsets (0, 3, 6) and (0, 0, 0) cut into tp 2 and tp 4 z shards (and,
        at (0, 0, 0), tp 2 x sp 3 shards); each shard's kernel against its
        plain version (``TOL``), the shards' outputs put together against
        row 5's kernel on the whole pair, bit for bit; per-launch times
        beside the bound; a launch with a z offset under tp and one with a
        lon offset on a lon shard must raise;
     b. a world of 6 ranks, mesh (dp 1, sp 3, tp 2), over gloo
        (``parallel/launch.py``; the halos through host buffers): Pangu-24
        from seed 0, float32 and bf16, one seeded state: ``forward`` and a
        2-step ``make_rollout(token_space=True)`` against the single-device
        runs of the same params and inputs (float32 1e-4, bf16
        ``TOL_FORWARD``), whether they are bit-equal; per rank the launch
        counts (a trunk: 4 blocks, 12 grouped blocks, 1 DownSample, 1
        UpSample; the rollout one 5z transition; no embed, no recovery
        kernel), the halo exchanges and bytes and the wall seconds per step;
     c. in the same world, ``cli.inference --bf16 --pallas --set
        model.gelu=tanh --token-space --horizon 48 --limit 1`` on phase 10's
        weights file: rank 0 writes the 12 CSVs, each value within 2^-4 of
        phase 10's token-space run on that date (RMSE relative, ACC
        absolute).
 12. sharded training, a world of ranks on the one card:
     a. ``block_bwd`` on a (tp 2, sp 3) shard of stage 0 at full width
        (the rank's ``ntype / tp`` rows of the region ids and the bias
        table, drop scales), float32 and bf16, against its plain version on
        the same shard (``TOL``, each output: dx and every gradient);
        a launch whose shift would read across shards must raise;
     b. a world of 6 ranks over gloo, Pangu-24 at full width from seed 0,
        drop-path rate 0.2: mesh (dp 1, sp 3, tp 2) at batch 1 and full
        depth, float32 and bf16 (the perf config), and mesh (2, 3, 1) at
        batch 2 and depths (2, 2, 2, 2), bf16; two ``make_train_step`` Adam
        steps each against one device's two steps of the same params,
        batch and seeds in this process: each step's loss (float32 1e-6
        relative, bf16 1e-3), every leaf of the first step's summed
        gradient (float32 1e-5, bf16 2e-2 of the leaf's max |value|), the
        params bit-equal across ranks after each step (equal ``checksum``s
        of their words); per rank and step the launch counts (one
        ``block_wm`` with scales and one ``block_bwd`` a block, one
        DownSample, one UpSample; no other kernel: no embed, recovery or
        grouped block), the exchanges and bytes of the halos, the gathers
        and the gradient sum, the wall seconds, and the rank's peak device
        memory;
     c. in the same world, ``cli.finetune`` and ``cli.lora_tune``
        (feature-mode dropout) with ``--bf16 --synthetic --smoke --set
        model.gelu=tanh`` at mesh (2, 3, 1), batch 2, depths (2, 2, 2, 2),
        fresh weights: each rank its own output directory, every rank
        returns 0 and only rank 0's directory exists (checkpoints, best
        params, 12 test CSVs, the log; the adapter and the merged
        snapshot); the validation losses (batch 1, dp collapsed) finite and
        equal across the ranks; per rank 4 steps' ``block_bwd`` launches,
        the served forwards' blocks, DownSample and UpSample, and no embed
        or recovery kernel; each command's wall seconds.

Training gates (phases 6, 7 and 8): the float32 train step's loss within
1e-4 relative of the plain path's, every gradient leaf within 1e-3 of its
max; the bf16 steps' losses and gradient norms finite.

The bf16 block backward (both layouts), the grid attention and its
backward, every bf16 block entry, the block tail, the recovery backward,
the upper embed weight gradient, DownSample and UpSample (window-major and
canonical), the transition, both recovery branches, the embed and the
fused window attention must also agree bit for bit over two runs
(``BIT_IDENTICAL``, ``BIT_IDENTICAL_FWD``, phase 3).

Every failed check raises, and the script exits nonzero.  The last lines are
the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the rest
of the repository beside it, it exits nonzero and prints no result.

Error measure throughout: max |kernel - plain| / max |plain|.  Tolerances:
1e-4 for one kernel in float32 and 1e-3 for the whole float32 forward
(float32 reassociation, amplified by the LayerNorms and compounded over 18
kernel units); 2**-6 for one kernel in bf16 (a few bf16 ulps: a value that
rounds one way in one version and the other way in the other moves by an ulp
and the difference propagates) and 2**-4 for whole bf16 steps and rollouts.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
TRAIN_STEPS = 3
# outputs whose side of the target the two float32 train-step paths may
# disagree on (of 7.2e7 at full width; expected a few: outputs within the
# paths' ~1e-6 difference of their target)
FLIPS_MAX = 64
STEPS = 2
TOKEN_STEPS = 3
DRIFT_STEPS = (3, 7)
HIER_HORIZON, HIER_MODELS = 30, (24, 6)


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
    scale = float(want.abs().max())
    if scale == 0.0:      # an all-zero plain result (a branch scaled by 0)
        return err, 0.0 if err == 0.0 else float("inf")
    return err, err / scale


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


def sdpa_report(ptxas, lib):
    """Lines on the bf16 sdpa kernels: their registers and spills as ptxas
    reported them, and the launch plan (dynamic shared memory, blocks per
    SM, threads) at the full-width shape hd 32, N 144."""
    lines, name = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for _ZN5pangu\d+(sdpa_mma\w*?_kernel)"
                      r"ILi(\d+)E", line)
        if m:
            name, spill = f"{m[1]}<{m[2]}>", "spills not reported"
            continue
        if name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            lines.append(f"ptxas {name}: {regs} registers; {spill}")
            name = None
    for bwd, what in ((0, "sdpa"), (1, "sdpa_bwd")):
        smem, per_sm, threads, nbuf, shared = (
            lib.pangu_sdpa_ws(bwd, 32, 144, k) for k in range(5))
        held = "dbias partial" if bwd else "bias slice"
        lines.append(f"{what} bf16 plan at hd 32, N 144: {smem} B dynamic "
                     f"shared memory, {per_sm} block(s) per SM of {threads} "
                     f"threads, {nbuf} tile buffer(s), {held} in shared "
                     f"memory: {bool(shared)}")
    return lines


def _short_kernel(mangled):
    """A readable name of a mangled tensor-core kernel:
    mma_gemm_kernel<A transposed, B transposed, epilogue>,
    wattn_mma_{fwd,bwd}_kernel<table dtype>, edge_mma_kernel<Op>, or a row
    kernel's name."""
    m = re.search(r"(block_gather16_kernel|ln_rows16_kernel|"
                  r"field_cot_wm_kernel|concat_heads_kernel|head_sum_kernel|"
                  r"patch_rows_kernel|split_sum_kernel)", mangled)
    if m:
        return m[1]
    m = re.search(r"((?:down|up)_gather_ln_kernel)ILi(\d+)E(?:NS_(\d+))?",
                  mangled)
    if m:   # the gather + LayerNorm kernels name their row map
        rmap = mangled[m.end():m.end() + int(m[3])] if m[3] else ""
        return f"{m[1]}<{m[2]}{',' + rmap if rmap else ''}>"
    m = re.search(r"edge_mma_kernelINS_\d+([A-Za-z]\w*?)EEEvT_", mangled)
    if m:
        return f"edge_mma_kernel<{m[1]}>"
    m = re.search(r"\d+(mma_gemm_kernel|wattn_mma_\w+?_kernel)I(.*)", mangled)
    if not m:
        return mangled
    base, rest = m[1], m[2]
    if base == "mma_gemm_kernel":
        flags = re.match(r"Lb(\d)ELb(\d)ENS_(\d+)", rest)
        epi = rest[flags.end():flags.end() + int(flags[3])]
        return f"{base}<{flags[1]},{flags[2]},{epi}>"
    return f"{base}<{'bf16' if rest.startswith('13__nv_bfloat16') else 'float'}>"


def ptxas_parts(ptxas, stems):
    """What ptxas printed for the objects ``stems`` (``<source>_<part>``,
    the report's ``== `` headings) only."""
    out, keep = [], False
    for line in ptxas.splitlines():
        if line.startswith("== "):
            keep = line[3:].strip() in stems
        elif keep:
            out.append(line)
    return "\n".join(out)


def tc_report(ptxas, kinds=r"mma_gemm_kernel|wattn_mma_", what=""):
    """Lines on the tensor-core kernels (the products of
    csrc/mma_gemm.cuh, the attention of csrc/wattn_mma.cuh; ``kinds``
    widens the set): registers and spills of each instantiation as ptxas
    reported them."""
    lines, seen, name = [], set(), None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for (_ZN5pangu\w+)", line)
        if m:
            name = (_short_kernel(m[1]) if re.search(kinds, m[1]) else None)
            spill = "spills not reported"
            continue
        if name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            if name not in seen:
                seen.add(name)
                regs = re.search(r"Used (\d+) registers", line)[1]
                lines.append(f"ptxas {what}{name}: {regs} registers; {spill}")
            name = None
    return lines


def fwd_report(ptxas):
    """The same lines for the bf16 forward: the block kernel's and the grid
    attention forward's objects (``BLOCK_WM_PART`` / ``GRID_ATTN_PART`` 1),
    products, attention and 16-byte row kernels."""
    return tc_report(ptxas_parts(ptxas, {"block_wm_1", "grid_attn_1"}),
                     r"mma_gemm_kernelILb0ELb0|wattn_mma_fwd|gather16|ln_rows16",
                     "forward ")


def updown_report(ptxas):
    """The same lines for the bf16 DownSample and UpSample: their
    products and their gather + LayerNorm row passes (one line for each
    chunk count a lane)."""
    return tc_report(ptxas_parts(ptxas, {"updown_wm_0"}),
                     r"PadEpi|gather_ln_kernel", "updown ")


def edge_report(ptxas):
    """The same lines for the bf16 transition, recovery (upper and surface)
    and embed: their tensor-core kernel (``csrc/edge_mma.cuh``), one
    instantiation each."""
    return tc_report(ptxas_parts(ptxas, {"transition_wm_0", "recovery_wm_0",
                                         "embed_wm_0"}),
                     r"edge_mma_kernel", "edge ")


def dw_up_report(ptxas):
    """The same lines for the bf16 upper embed weight gradient and the
    canonical UpSample: their relayout, products, split sum and gather +
    LayerNorm pass."""
    return tc_report(ptxas_parts(ptxas, {"embed_dw_0", "updown_0"}),
                     r"mma_gemm_kernel|patch_rows|split_sum|gather_ln_kernel",
                     "embed_dw / updown ")


def window_report(ptxas):
    """The same lines for the bf16 fused window attention (the object of
    ``WINDOW_ATTN_PART`` 1): its two products and its attention."""
    return tc_report(ptxas_parts(ptxas, {"window_attn_1"}),
                     r"QScaleEpi|BiasEpi|wattn_mma_fwd", "window attention ")


def tail_recovery_report(ptxas):
    """The same lines for the bf16 block tail and recovery backward: their
    objects' products, LayerNorm passes, relayout and split sum."""
    return tc_report(ptxas_parts(ptxas, {"block_tail_0", "recovery_bwd_0"}),
                     r"mma_gemm_kernel|ln_rows16|field_cot_wm|concat_heads|"
                     r"head_sum", "tail / recovery ")


# bf16 ms per launch of the redesigned rows as their earlier kernels ran
# them in this script on an NVIDIA H100 80GB HBM3 at 700 W, printed beside
# the new times: name -> label -> ms.  The block entries and the grid
# attention: the CUDA-core forward (commit e1271cc); the block tail and the
# recovery backward: their first versions (commit 37b26cf); DownSample and
# UpSample: their first versions (commit a7e41b5); the transition and the
# upper recovery: their first versions (commit e35ad6a); the embed and the
# surface recovery: their first versions (commit 5d574eb); the upper embed
# weight gradient and the canonical UpSample: their first versions (commit
# 8ea71dc); the canonical DownSample and the fused window attention (and
# the drop-in's gradients, whose forward it is): their first versions
# (commit b419df9).
PREVIOUS_BF16_MS = {
    'down_sample': {
        'stage 0 -> 1, canonical grid': 2.097,
    },
    'window_attention_pallas': {
        'stage 0 windows (1, 30, 124, 144, 192), region ids': 13.236,
        'stage 0 windows (1, 30, 124, 144, 192), no ids': 12.888,
        'stage 1 windows (1, 15, 64, 144, 384), region ids': 8.494,
        'stage 1 windows (1, 15, 64, 144, 384), no ids': 8.452,
    },
    'window_attention_pallas backward': {
        'stage 0, region ids, every gradient': 42.164,
    },
    'embed_dw_upper': {
        'full width': 7.846,
    },
    'up_sample': {
        'stage 2 -> 3, canonical grid': 3.310,
    },
    'embed_wm': {
        'full width': 2.663,
    },
    'recovery_wm_surface': {
        'off (0, 0, 0)': 0.278,
        'off (1, 3, 6)': 0.279,
    },
    'transition_wm': {
        'off (0, 0, 0)': 4.551,
        'off (1, 3, 6)': 4.519,
    },
    'recovery_wm_upper': {
        'off (0, 0, 0)': 3.194,
        'off (1, 3, 6)': 3.183,
    },
    'down_sample_wm': {
        'stage 0 -> 1, off (1, 3, 6)': 2.562,
    },
    'up_sample_wm': {
        'stage 2 -> 3, off (1, 3, 6), valid rows': 4.168,
    },
    'fused_block_tail': {
        'stage 0, cropped grid': 8.693,
        'stage 1, cropped grid': 7.523,
    },
    'recovery_bwd': {
        'off (1, 3, 6)': 24.743,
    },
    'block_wm': {
        'stage 0 unshifted': 22.126,
        'stage 0 shifted': 22.26,
        'stage 1 shifted': 16.477,
    },
    'block_wm_group': {
        'stage 1 unshifted, gh 2': 16.386,
        'stage 1 shifted, gh 2': 16.833,
        'stage 1 shifted, gh 2, scales (1.25, 0)': 16.89,
    },
    'block_wm_canon': {
        'stage 0 canon in': 21.968,
        'stage 0 canon out, shifted': 22.428,
        'stage 1 canon in': 16.326,
        'stage 1 canon out, shifted': 16.425,
    },
    'block_wm drop': {
        'stage 0 shifted, scales (0.8, 1.25)': 22.308,
        'stage 1 shifted, scales (1.25, 0)': 16.582,
    },
    'block_v2': {
        'stage 0 shifted': 22.364,
        'stage 0 -half, scales (0.8, 1.25)': 22.473,
        'stage 1 shifted, scales (1.25, 0)': 16.532,
        'stage 1 -half': 16.358,
    },
    'grid_attention': {
        'stage 0, region ids': 10.43,
        'stage 1, no ids': 5.669,
    },
    'block_noroll_fused': {
        'stage 0, padded grid': 22.263,
        'stage 1, padded grid': 16.309,
    },
}


def previous_ms(name, label):
    return PREVIOUS_BF16_MS.get(name, {}).get(label)


# The float32 route of the block kernel, the grid attention forward, the
# block tail, the recovery backward, DownSample and UpSample (window-major
# and canonical), the transition, the recovery (both branches), the embed,
# its upper weight gradient and the fused window attention did not change
# with their bf16 redesigns, so their float32 error lines must read as the
# earlier kernels' (commits e1271cc, 37b26cf, a7e41b5, e35ad6a, 8ea71dc and
# b419df9, as PREVIOUS_BF16_MS) did
# in the same run of this script ("max_abs_err rel",
# as printed), where torch and the card are the ones of that run (inputs
# drawn elsewhere are not comparable)
F32_BEFORE = {"torch": "2.11.0+cu128", "card": "NVIDIA H100 80GB HBM3",
            "lines": {
                'block_wm | stage 0 unshifted':
                    '4.053e-06 4.117e-07',
                'block_wm | stage 0 shifted':
                    '5.245e-06 5.695e-07',
                'block_wm | stage 1 shifted':
                    '6.199e-06 6.655e-07',
                'block_wm_group | stage 1 unshifted, gh 2':
                    '5.364e-06 5.660e-07',
                'block_wm_group | stage 1 shifted, gh 2':
                    '6.199e-06 6.655e-07',
                'block_wm_canon | stage 0 canon in':
                    '4.292e-06 4.686e-07',
                'block_wm_canon | stage 0 canon out, shifted':
                    '4.292e-06 4.363e-07',
                'block_wm_canon | stage 1 canon in':
                    '5.722e-06 5.787e-07',
                'block_wm_canon | stage 1 canon out, shifted':
                    '5.364e-06 5.596e-07',
                'block_wm drop | stage 0 shifted, scales (0.8, 1.25)':
                    '5.245e-06 5.057e-07',
                'block_wm drop | stage 1 shifted, scales (1.25, 0)':
                    '2.861e-06 3.195e-07',
                'block_v2 | stage 0 shifted':
                    '4.292e-06 4.715e-07',
                'block_v2 | stage 0 -half, scales (0.8, 1.25)':
                    '4.768e-06 4.637e-07',
                'block_v2 | stage 1 shifted, scales (1.25, 0)':
                    '2.861e-06 3.146e-07',
                'block_v2 | stage 1 -half':
                    '5.960e-06 6.211e-07',
                'grid_attention | stage 0, region ids':
                    '1.770e-08 4.020e-07',
                'grid_attention | stage 1, no ids':
                    '2.235e-08 4.291e-07',
                'block_noroll_fused | stage 0, padded grid':
                    '5.007e-06 5.413e-07',
                'block_noroll_fused | stage 1, padded grid':
                    '5.484e-06 5.365e-07',
                'block_wm_group | stage 1 shifted, gh 2, scales (1.25, 0)':
                    '2.861e-06 3.155e-07',
                'fused_block_tail | stage 0, cropped grid':
                    '3.934e-06 3.897e-07',
                'fused_block_tail | stage 1, cropped grid':
                    '4.292e-06 4.415e-07',
                'recovery_bwd | off (1, 3, 6)':
                    '2.812e-01 2.680e-06',
                'down_sample_wm | stage 0 -> 1, off (1, 3, 6)':
                    '1.431e-06 5.053e-07',
                'up_sample_wm | stage 2 -> 3, off (1, 3, 6), valid rows':
                    '4.768e-07 3.566e-07',
                'embed_wm | full width':
                    '0.000e+00 0.000e+00',
                'transition_wm | off (0, 0, 0)':
                    '4.768e-07 6.108e-07',
                'transition_wm | off (1, 3, 6)':
                    '4.172e-07 5.260e-07',
                'recovery_wm_upper | off (0, 0, 0)':
                    '1.907e-06 9.569e-07',
                'recovery_wm_upper | off (1, 3, 6)':
                    '1.907e-06 9.569e-07',
                'recovery_wm_surface | off (0, 0, 0)':
                    '1.669e-06 8.374e-07',
                'recovery_wm_surface | off (1, 3, 6)':
                    '1.550e-06 8.439e-07',
                'up_sample | stage 2 -> 3, canonical grid':
                    '7.153e-07 5.161e-07',
                'embed_dw_upper | full width':
                    '7.568e-03 2.655e-06',
                'down_sample | stage 0 -> 1, canonical grid':
                    '1.550e-06 5.777e-07',
                'window_attention_pallas | stage 0 windows (1, 30, 124, '
                '144, 192), region ids':
                    '1.583e-08 3.310e-07',
                'window_attention_pallas | stage 0 windows (1, 30, 124, '
                '144, 192), no ids':
                    '1.118e-08 4.364e-07',
                'window_attention_pallas | stage 1 windows (1, 15, 64, '
                '144, 384), region ids':
                    '3.353e-08 3.579e-07',
                'window_attention_pallas | stage 1 windows (1, 15, 64, '
                '144, 384), no ids':
                    '2.235e-08 4.238e-07',
                'window_attention_pallas backward | stage 0, region ids, '
                'every gradient':
                    '6.104e-05 7.918e-07',
            }}


# bf16 forward kernels of phase 3 (besides the block entries) whose two
# runs must agree bit for bit
BIT_IDENTICAL_FWD = ("down_sample_wm", "up_sample_wm", "transition_wm",
                     "recovery_wm_upper", "recovery_wm_surface", "embed_wm",
                     "up_sample", "down_sample")


def f32_as_before(name, label, err, rel):
    """' float32 as before' where the error line equals the CUDA-core
    forward's; raises where it differs; says so where the run is not
    comparable or has no record."""
    want = F32_BEFORE["lines"].get(f"{name} | {label}")
    if want is None:
        return ""
    if (torch.__version__ != F32_BEFORE["torch"]
            or torch.cuda.get_device_name(0) != F32_BEFORE["card"]):
        return "  (the earlier float32 line is not comparable here)"
    got = f"{err:.3e} {rel:.3e}"
    if got != want:
        raise AssertionError(f"{name} {label} float32: {got}, before "
                             f"{want} (the float32 route changed)")
    return "  float32 as before"


def bwd_work(rows, c, hidden, n):
    """(FLOP, bytes) of a bf16 block backward launch by class, each input
    read once and each output written once: the recomputed products, the
    data-gradient and weight-gradient products, the attention backward, the
    recomputed attention and the row kernels (gathers, LayerNorm passes,
    split sums of the LayerNorm gradients)."""
    m_, h = rows, hidden
    return {"recompute products": (2 * m_ * c * (4 * c + 2 * h),
                                   2 * m_ * (8 * c + 3 * h)),
            "data-gradient products": (2 * m_ * c * (4 * c + 2 * h),
                                       2 * m_ * (10 * c + 3 * h)),
            "weight-gradient products": (2 * m_ * c * (4 * c + 2 * h),
                                         2 * m_ * (8 * c + 2 * h)),
            "attention backward": (10 * m_ * n * c, 2 * m_ * 7 * c),
            "recompute attention": (4 * m_ * n * c, 2 * m_ * 4 * c),
            "row kernels": (0, 2 * m_ * 19 * c)}


def bwd_class(key):
    """A bf16 block backward kernel's class by its name."""
    m = re.search(r"mma_gemm_kernel<(true|false), (true|false)", key)
    if m:
        return {("false", "false"): "recompute products",
                ("false", "true"): "data-gradient products",
                ("true", "false"): "weight-gradient products"}[m.groups()]
    if "wattn_mma_bwd" in key:
        return "attention backward"
    if "wattn_mma_fwd" in key:
        return "recompute attention"
    return "row kernels"


def block_fwd_work(rows, c, hidden, n):
    """(FLOP, bytes) of a bf16 forward block launch by class, each input
    read once and each output written once: the four products (qkv, proj,
    fc1, fc2), the attention (q.k and P.V; qkv in, attn out) and the row
    passes (the gather, the two LayerNorm-residual passes)."""
    return {"products": (2 * rows * c * (4 * c + 2 * hidden),
                         2 * rows * (8 * c + 2 * hidden)),
            "attention": (4 * rows * n * c, 2 * rows * 4 * c),
            "row passes": (0, 2 * rows * 8 * c)}


def grid_fwd_work(rows, c, n):
    """The same for a bf16 grid attention forward: the qkv and proj
    products, the attention and the gather."""
    return {"products": (2 * rows * c * 4 * c, 2 * rows * 6 * c),
            "attention": (4 * rows * n * c, 2 * rows * 4 * c),
            "row passes": (0, 2 * rows * 2 * c)}


def window_work(rows, c, n):
    """The same for a bf16 fused window attention: the qkv and proj
    products and the attention (no gather: its windows come partitioned)."""
    work = grid_fwd_work(rows, c, n)
    return {"products": work["products"], "attention": work["attention"],
            "row passes": (0, 0)}


def fwd_class(key):
    """A forward kernel's class by its name: the products (``*gemm*``),
    the attention (``*attn*``) or the row passes (the rest)."""
    return ("products" if "gemm" in key else
            "attention" if "attn" in key else "row passes")


def class_breakdown(fn, work, classify=fwd_class, reps=3, detail=None):
    """Device time of one launch by class: torch.profiler (CPU and CUDA
    activity) over ``reps`` launches after one warm-up launch in the
    profiler's warm-up step (a profile without one was seen to miss
    kernels late in this script), each kernel's class from ``classify``
    (its name -> a key of ``work``), each class with its rate from
    ``work`` (class -> FLOP, bytes); beside the total, the launch's time by
    CUDA events, so that a profile that missed kernels shows (one whose
    device time is under a quarter of that time is taken again, up to
    three times: late in this script a profile was seen to come back
    empty, or with a few of the launch's kernels only; a wrapper's host
    time keeps some launches' device time under half their events'
    time).  With
    ``detail`` a class, its kernels follow, each with its launches and
    device time a launch of ``fn``, slowest first."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    events_ms = time_ms(fn, reps)
    for _ in range(3):   # a profile right after another was seen to be empty
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps,
                                       repeat=1)) as prof:
            for _ in range(1 + reps):
                fn()
                torch.cuda.synchronize()
                prof.step()
        ms = {k: 0.0 for k in work}
        listed = []
        for e in prof.key_averages():
            t = e.self_device_time_total / 1e3 / reps
            # a step's annotation spans its kernels on the device timeline
            if (e.device_type != torch.autograd.DeviceType.CUDA or t == 0.0
                    or getattr(e, "is_user_annotation", False)
                    or e.key.startswith("ProfilerStep")):
                continue
            ms[classify(e.key)] += t
            if classify(e.key) == detail:
                listed.append((t, e.count / reps, e.key))
        if sum(ms.values()) >= 0.25 * events_ms:
            break
    parts = []
    for k, t in ms.items():
        flops, byts = work[k]
        rate = (f"{flops / t / 1e9:.1f} TFLOP/s" if flops else
                f"{byts / t / 1e6:.0f} GB/s") if t else "not run"
        parts.append(f"{k} {t:.3f} ms ({rate})")
    out = (f"{sum(ms.values()):.3f} ms of device time ({events_ms:.3f}"
           f" ms a launch by CUDA events): " + "; ".join(parts))
    for t, n, key in sorted(listed, reverse=True):
        out += f"\n  {detail}: {n:g} x {key[:72]} {t:.3f} ms"
    return out


def down_work(rows0, rows1, c):
    """(FLOP, bytes) of a bf16 DownSample launch by class, over every
    storage row (the kernel's work, pad rows included): the product (cat
    and the weight in, out) and the gather + LayerNorm pass (x in, cat
    out)."""
    return {"products": (2 * rows1 * 4 * c * 2 * c,
                         2 * (rows1 * 4 * c + 8 * c * c + rows1 * 2 * c)),
            "row passes": (0, 2 * (rows0 * c + rows1 * 4 * c))}


def up_work(rows2, rows3, c_in, c_out):
    """The same for a bf16 UpSample launch: the expand product (x in, e
    out) and the mix product (y in, out), the gather + LayerNorm pass (a
    C' slice of e in, y out)."""
    return {"products": (2 * rows2 * c_in * 4 * c_out
                         + 2 * rows3 * c_out * c_out,
                         2 * (rows2 * (c_in + 4 * c_out) + 2 * rows3 * c_out
                              + 4 * c_in * c_out + c_out * c_out)),
            "row passes": (0, 2 * 2 * rows3 * c_out)}


def tail_work(rows, c, hidden):
    """(FLOP, bytes) of a bf16 block tail launch by class, each input read
    once and each output written once: the two products (x1 in, h; h in,
    y) and the two LayerNorm-residual passes (a, s in, x1; y, x1 in,
    out)."""
    return {"products": (4 * rows * c * hidden, 2 * rows * (2 * c + 2 * hidden)),
            "row passes": (0, 2 * rows * 6 * c)}


def recovery_work(rows, c, fu, fs, field_elems):
    """The same for a bf16 recovery backward launch over ``rows`` storage
    rows (the products run over every storage row of the pair): the
    relayout (the fields in, dF_wm and [Ku | Ks] out), the token-cotangent
    product (dF_wm in, d_skip and d_dec out), the weight gradients (skip,
    dec and dF_wm in, the float32 split partials out) and the split sum."""
    f = fu + fs
    part = -(-rows // 4096) * (2 * c + 1) * f * 4
    return {"relayout": (0, 2 * field_elems + 2 * rows * f + 4 * 2 * c * f),
            "token-cotangent product": (2 * rows * f * 2 * c,
                                        2 * rows * f + 2 * 2 * rows * c),
            "weight gradient": (2 * rows * (2 * c + 1) * f,
                                2 * 2 * rows * c + 2 * rows * f + part),
            "split sum": (0, part + 4 * (2 * c + 1) * f)}


def recovery_class(key):
    """A bf16 recovery backward kernel's class by its name."""
    if "mma_gemm_kernel<false, true" in key:
        return "token-cotangent product"
    if "mma_gemm_kernel<true, false" in key:
        return "weight gradient"
    if "head_sum" in key:
        return "split sum"
    return "relayout"


def edge_work(flops, nbytes_):
    """(FLOP, bytes) of a bf16 transition or recovery launch by class: the
    gather of the pair's rows, the product and the epilogue are one kernel
    (the tensor-core route's ``edge_mma_kernel``, the first version's
    ``edge_gemm_bf16``), so one class holds the launch's work."""
    return {"gather + product + epilogue": (flops, nbytes_)}


def edge_class(key):
    """The class of a transition or recovery kernel (one)."""
    return "gather + product + epilogue"


def embed_work(flops, field, const_h, st, plane0, upper):
    """(FLOP, bytes) of a bf16 embed wrapper by class, each input read once:
    the prepass (the field normalised: read and written once; the surface
    token plane written), the upper product (the normalised field and
    const_h in, the upper planes' storage out) and the plane-0 copy (the
    surface token plane in, plane 0's storage out)."""
    return {"prepass": (0, 2 * field + st),
            "upper product": (flops, field + const_h + upper),
            "plane-0 copy": (0, st + plane0)}


def embed_class(key):
    """The class of a kernel the embed wrapper launches: the upper product
    (``edge_mma_kernel``, the first version's ``edge_gemm_bf16``), the
    plane-0 copy, or the PyTorch prepass (the rest)."""
    if "edge_mma_kernel" in key or "edge_gemm" in key:
        return "upper product"
    if "embed_plane0" in key or "embed_surface_kernel" in key:
        return "plane-0 copy"
    return "prepass"


def dw_work(rows, k, c, field, const_h):
    """(FLOP, bytes) of a bf16 upper embed weight-gradient wrapper by class
    (``field`` and ``const_h`` in elements), each input read once: the
    PyTorch prepass (the float32 field and const_h read, their bf16 copies
    written), the relayout (those in, the patch matrix A out: ``rows``
    storage rows of k + 8 values), the product over every storage row (A
    and the cotangent in, the float32 split partials out) and the split
    sum."""
    part = -(-rows // 4096) * (k + 1) * c * 4
    return {"prepass": (0, 6 * (field + const_h)),
            "relayout": (0, 2 * (field + const_h) + 2 * rows * (k + 8)),
            "product": (2 * rows * (k + 1) * c,
                        2 * rows * (k + 8 + c) + part),
            "split sum": (0, part + 4 * (k + 1) * c)}


def dw_class(key):
    """The class of a kernel the weight-gradient wrapper launches: the
    relayout, the product (``mma_gemm_kernel``; the first version's
    ``xgemm_bf16_kernel``, gathers included), the split sum, or the PyTorch
    prepass (the rest)."""
    if "mma_gemm_kernel" in key or "xgemm" in key:
        return "product"
    if "patch_rows" in key:
        return "relayout"
    if "split_sum" in key:
        return "split sum"
    return "prepass"


def embed_dw_library(dxs, un, const_h, cfg):
    """The library yardstick of the upper embed's weight gradient: cuDNN's
    weight and bias gradient of the equivalent Conv3d (kernel and stride the
    patch), ``torch.ops.aten.convolution_backward``, which takes the field
    padded to whole patches with const_h as its last channel and the
    cotangent's upper planes in the canonical channels-first layout.
    Returns ``(relayout, library)``: ``relayout()`` builds those two inputs
    from the port's (the wm cotangent ``dxs``, the normalised field ``un``,
    const_h); ``library(x6, dy)`` returns (dK, db) in the port's layout
    (dK in ONNX row order, db), in the dtype of ``dxs``.  Never on a path of
    the port."""
    from pangu_tpu_torch.ops.earth_block_wm import from_window_major
    g = cfg.stage(0)
    c, b = dxs.shape[-1], dxs.shape[0]
    weight = torch.empty((c, un.shape[1] + 1, *cfg.patch), dtype=dxs.dtype,
                         device=dxs.device)

    def relayout():
        x6 = torch.cat([un, const_h[None, None].expand(b, 1, *const_h.shape)],
                       1)
        x6 = torch.nn.functional.pad(
            x6, (0, 0, 0, cfg.lat_padded - cfg.lat,
                 0, cfg.levels_padded - cfg.levels))
        dy = from_window_major(dxs, g.window)[:, 1:, :cfg.h_tokens]
        return x6, dy.permute(0, 4, 1, 2, 3).contiguous()

    def library(x6, dy):
        _, dw, db = torch.ops.aten.convolution_backward(
            dy, x6, weight, [c], list(cfg.patch), [0, 0, 0], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, True])
        return dw.reshape(c, -1).T, db

    return relayout, library


def bound(flops, nbytes_, dtype):
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    # set before the allocator starts: empty_cache can then hand back what
    # earlier phases cached, which phases 12-13's worlds of ranks need
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pangu_tpu_torch import _build, ops
    from pangu_tpu_torch.config import PANGU_24, _pick_gh
    from pangu_tpu_torch.data.constants import (denorm_data, norm_data,
                                                synthetic_constants, to_device)
    from pangu_tpu_torch.engine.rollout import (make_hierarchical_rollout,
                                                make_rollout, single_step)
    from pangu_tpu_torch.engine.transition_wm import (
        apply_transition_wm, apply_transition_wm_plain, build_transition_wm)
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.models import layers as L
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_canon,
                                                    block_wm_canon_plain,
                                                    block_wm_group,
                                                    block_wm_plain,
                                                    from_window_major,
                                                    pad_rows_zeroed,
                                                    to_window_major,
                                                    wm_to_canonical)
    from pangu_tpu_torch.ops.embed_wm import embed_wm, embed_wm_plain
    from pangu_tpu_torch.ops.recovery_wm import (recovery_wm,
                                                 recovery_wm_surface,
                                                 recovery_wm_surface_plain,
                                                 recovery_wm_upper,
                                                 recovery_wm_upper_plain)
    from pangu_tpu_torch.ops.updown import (down_sample, down_sample_plain,
                                            up_sample, up_sample_plain)
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
    print("clocks, power:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip().splitlines()[0])
    done("environment", t0)

    # ---- 2. build ---------------------------------------------------------
    t0 = phase("build")
    lib_path = _build.build()
    lib = _build.library()
    print(f"built {os.path.relpath(lib_path)}")
    ptxas = _build.ptxas_report()
    for line in (sdpa_report(ptxas, lib) + tc_report(ptxas) + fwd_report(ptxas)
                 + tail_recovery_report(ptxas) + updown_report(ptxas)
                 + edge_report(ptxas) + dw_up_report(ptxas)
                 + window_report(ptxas)):
        print(line)
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

    def storage(geom, dtype, batch=1, g=None):
        wz, wh, ww = geom.window
        shape = (batch, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                 wz * wh * ww, geom.dim)
        return torch.randn(shape, generator=g or gen, device=dev).to(dtype)

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
    c0 = g0.dim
    valid0 = g0.z * g0.h * g0.w                  # real stage-0 token rows
    upper_rows = (g0.z - 1) * g0.h * g0.w        # of them, upper-plane rows
    field_u = 5 * PANGU_24.levels * PANGU_24.lat * PANGU_24.lon
    field_s = 4 * PANGU_24.lat * PANGU_24.lon
    cases = []  # (name, label, dtype, flops, bytes, kernel, plain, view, record)
    for dtype in (torch.float32, torch.bfloat16):
        tanh = dtype == torch.bfloat16
        isz = torch.tensor([], dtype=dtype).element_size()
        pdt = to_dtype({"s0": params["stages"][0]["blocks"][1],
                        "s1": params["stages"][1]["blocks"][1],
                        "down": params["downsample"],
                        "up": params["upsample"],
                        "patch_embed": params["patch_embed"],
                        "patch_recovery": params["patch_recovery"]}, dtype)
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
                lambda out: out, label == "stage 0 shifted"))
            if geom is g1:   # the grouped block on the same input
                gh = _pick_gh(g1.h_padded // g1.window[1], perf.lat_group)
                for glabel, gd, gc, gi in (
                        (f"stage 1 unshifted, gh {gh}", (0, 0, 0), 0, None),
                        (f"stage 1 shifted, gh {gh}", delta, canon, ids)):
                    cases.append((
                        "block_wm_group", glabel, dtype, flops, byts,
                        lambda bp=bp, xs=xs, d=gd, c=gc, i=gi, t=tanh, gh=gh:
                            block_wm_group(bp, xs, g1, d, c, i, t, gh),
                        lambda bp=bp, xs=xs, d=gd, c=gc, i=gi, t=tanh:
                            block_wm_plain(bp, xs, g1, d, c, i, t),
                        lambda out: out, gd == delta))
        for geom, bp in ((g0, pdt["s0"]), (g1, pdt["s1"])):
            # the stage end-points: the unshifted first block reads the
            # canonical grid, the shifted last block writes it
            grid = torch.randn((1, geom.z, geom.h_padded, geom.w, geom.dim),
                               generator=gen, device=dev).to(dtype)
            xs = storage(geom, dtype)
            ids = ids_of(geom)
            flops, byts = block_cost(bp, xs, ids)
            st = "stage 0" if geom is g0 else "stage 1"
            for label, x, delta, canon, i, lin, lout in (
                    (f"{st} canon in", grid, (0, 0, 0), 0, None, "canon", "wm"),
                    (f"{st} canon out, shifted", xs, half, 3, ids, "wm",
                     "canon")):
                cases.append((
                    "block_wm_canon", label, dtype, flops, byts,
                    lambda bp=bp, x=x, g=geom, d=delta, c=canon, i=i, t=tanh,
                    a=lin, o=lout:
                        block_wm_canon(bp, x, g, d, c, i, t, in_layout=a,
                                       out_layout=o),
                    lambda bp=bp, x=x, g=geom, d=delta, c=canon, i=i, t=tanh,
                    a=lin, o=lout:
                        block_wm_canon_plain(bp, x, g, d, c, i, t, a, o),
                    lambda out: out, label == "stage 0 canon out, shifted"))
        xs = storage(g0, dtype)
        c = g0.dim
        cases.append((       # work: the valid stage-1 rows; bytes: in + out
            "down_sample_wm", "stage 0 -> 1, off (1, 3, 6)", dtype,
            2 * (g1.z * g1.h * g1.w) * 4 * c * 2 * c,
            nbytes(xs) + rows(g1) * 2 * c * isz + weight_bytes(pdt["down"], dtype),
            lambda xs=xs, p=pdt["down"]: down_sample_wm(p, xs, g0, g1, half),
            lambda xs=xs, p=pdt["down"]: down_sample_wm_plain(p, xs, g0, g1, half),
            lambda out: out, True))
        xs = storage(g2, dtype)
        c_in, c_out = g2.dim, g3.dim
        cases.append((       # work: the input rows that feed valid output rows
            "up_sample_wm", "stage 2 -> 3, off (1, 3, 6), valid rows", dtype,
            2 * (g2.z * -(-g3.h // 2) * g2.w) * c_in * 4 * c_out
            + 2 * (g3.z * g3.h * g3.w) * c_out * c_out,
            nbytes(xs) + rows(g3) * c_out * isz + weight_bytes(pdt["up"], dtype),
            lambda xs=xs, p=pdt["up"]: up_sample_wm(p, xs, g2, g3, half),
            lambda xs=xs, p=pdt["up"]: up_sample_wm_plain(p, xs, g2, g3, half),
            lambda out: from_window_major(out, g3.window)[:, :, :g3.h], True))
        # the canonical pair on the canonical grids of the taps forward
        x = torch.randn((1, g0.z, g0.h, g0.w, c0), generator=gen,
                        device=dev).to(dtype)
        cases.append((       # work: the output rows; bytes: in + out
            "down_sample", "stage 0 -> 1, canonical grid", dtype,
            2 * (g1.z * g1.h * g1.w) * 4 * c0 * 2 * c0,
            nbytes(x) + g1.z * g1.h * g1.w * 2 * c0 * isz
            + weight_bytes(pdt["down"], dtype),
            lambda x=x, p=pdt["down"]: down_sample(p, x),
            lambda x=x, p=pdt["down"]: down_sample_plain(p, x),
            lambda out: out, True))
        x = torch.randn((1, g2.z, g2.h, g2.w, c_in), generator=gen,
                        device=dev).to(dtype)
        cases.append((       # work: every input row feeds a kept output row
            "up_sample", "stage 2 -> 3, canonical grid", dtype,
            2 * (g2.z * g2.h * g2.w) * c_in * 4 * c_out
            + 2 * (g3.z * g3.h * g3.w) * c_out * c_out,
            nbytes(x) + g3.z * g3.h * g3.w * c_out * isz
            + weight_bytes(pdt["up"], dtype),
            lambda x=x, p=pdt["up"]: up_sample(p, x, g3.h),
            lambda x=x, p=pdt["up"]: up_sample_plain(p, x, g3.h),
            lambda out: out, True))

        # the edge kernels, on the compute-dtype state the served paths give
        ecfg = dataclasses.replace(
            PANGU_24, compute_dtype="bfloat16" if tanh else "float32")
        pe, pr = pdt["patch_embed"], pdt["patch_recovery"]
        ud, sd = u0.to(dtype), s0.to(dtype)
        k_up = pe["upper"]["kernel"].shape[0]
        cases.append((       # work: the upper-plane rows; bytes: fields in, wm out
            "embed_wm", "full width", dtype,
            2 * upper_rows * k_up * c0,
            nbytes(ud, sd) + consts_dev["const_h"].numel() * isz
            + weight_bytes(pe, dtype) + rows(g0) * c0 * isz,
            lambda p=pe, u=ud, s=sd, cf=ecfg: embed_wm(p, u, s, consts_dev, cf),
            lambda p=pe, u=ud, s=sd, cf=ecfg: embed_wm_plain(p, u, s, consts_dev,
                                                             cf),
            lambda out: out, True))
        tp = build_transition_wm(pdt, consts_dev, ecfg)
        mats_bytes = 6 * 2 * c0 * c0 * isz
        skip, dec = storage(g0, dtype), storage(g0, dtype)
        for off in ((0, 0, 0), half):
            cases.append((   # work and reads: the valid rows; the whole output
                "transition_wm", f"off {off}", dtype,
                2 * valid0 * 2 * c0 * c0,
                3 * valid0 * c0 * isz + mats_bytes + rows(g0) * c0 * isz,
                lambda tp=tp, a=skip, b=dec, o=off:
                    apply_transition_wm(tp, a, b, g0, o),
                lambda tp=tp, a=skip, b=dec, o=off:
                    apply_transition_wm_plain(tp, a, b, g0, o),
                lambda out: out, off == half))
            cases.append((   # the upper planes' valid rows of the pair
                "recovery_wm_upper", f"off {off}", dtype,
                2 * upper_rows * 2 * c0 * 160,
                2 * upper_rows * c0 * isz + weight_bytes(pr["upper"], dtype)
                + field_u * isz,
                lambda p=pr, a=skip, b=dec, o=off, cf=ecfg:
                    recovery_wm_upper(p, a, b, o, cf),
                lambda p=pr, a=skip, b=dec, o=off, cf=ecfg:
                    recovery_wm_upper_plain(p, a, b, o, cf),
                lambda out: out, off == half))
            cases.append((   # plane 0's valid rows of the pair
                "recovery_wm_surface", f"off {off}", dtype,
                2 * g0.h * g0.w * 2 * c0 * 64,
                2 * g0.h * g0.w * c0 * isz + weight_bytes(pr["surface"], dtype)
                + field_s * isz,
                lambda p=pr, a=skip, b=dec, o=off, cf=ecfg:
                    recovery_wm_surface(p, a, b, o, cf),
                lambda p=pr, a=skip, b=dec, o=off, cf=ecfg:
                    recovery_wm_surface_plain(p, a, b, o, cf),
                lambda out: out, off == half))

    records = {}
    ungrouped = {}     # bf16 block_wm outputs, held against block_wm_group
    for name, label, dtype, flops, byts, kern, plain, view, record in cases:
        got, want = view(kern()), view(plain())
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        del want
        note = ""
        if dtype == torch.bfloat16 and (name.startswith("block_wm")
                                        or name in BIT_IDENTICAL_FWD):
            if not torch.equal(got, view(kern())):
                raise AssertionError(f"{name} {label}: two bf16 runs differ")
            note = "  bit-identical in two runs"
            key = label.split(", gh")[0]
            if name == "block_wm" and label.startswith("stage 1"):
                ungrouped[key] = got
            elif name == "block_wm_group" and key in ungrouped:
                if not torch.equal(got, ungrouped.pop(key)):
                    raise AssertionError(f"{label}: bf16 block_wm_group "
                                         "differs from block_wm")
                note += ", equal to block_wm"
        if dtype == torch.float32:
            note += f32_as_before(name, label, err, rel)
        del got
        ms = time_ms(kern, 3)
        plain_ms = time_ms(plain, 2)
        bound_ms, bound_by = bound(flops, byts, dtype)
        ok = rel <= TOL[dtype]
        was = previous_ms(name, label) if dtype == torch.bfloat16 else None
        print(f"{name:19s} {label:38s} {str(dtype):15s} max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol {TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}  "
              f"kernel {ms:.3f} ms{f' (was {was} ms)' if was else ''}  plain "
              f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms ({bound_by})"
              f"{note}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} {dtype}: rel err {rel:.3e}")
        if dtype == torch.bfloat16 and record:
            records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "at": f"{label}, bf16"}
    del cases, tp, skip, dec, xs, x, grid, ungrouped
    torch.cuda.empty_cache()

    # one stage-0 bf16 forward block and grid attention by class of kernel
    from pangu_tpu_torch.ops.window_attention import grid_attention
    gsplit = torch.Generator(device=dev).manual_seed(SEED + 7)
    wz, wh, ww = g0.window
    bp0, ids0 = params["stages"][0]["blocks"][1], ids_of(g0)
    xs = torch.randn((1, g0.z // wz, g0.h_padded // wh, g0.w // ww,
                      g0.window_tokens, c0), generator=gsplit,
                     device=dev).to(torch.bfloat16)
    m0 = xs.numel() // c0
    print("block_wm stage 0 shifted bf16 by class (torch.profiler): "
          + class_breakdown(lambda: block_wm(bp0, xs, g0, half, 3, ids0, True),
                            block_fwd_work(m0, c0, 4 * c0, g0.window_tokens)))
    x = xs.reshape(1, g0.z, g0.h_padded, g0.w, c0)
    at = bp0["attn"]
    w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
         at["proj"]["bias"], at["bias_table"])
    print("grid_attention stage 0, region ids bf16 by class (torch.profiler): "
          + class_breakdown(lambda: grid_attention(x, *w, g0.window, ids0),
                            grid_fwd_work(m0, c0, g0.window_tokens)))
    del xs, x

    # bf16 DownSample and UpSample: by class of kernel; junk on the input's
    # latitude-pad rows (storage latitude s holds canonical (s + 1) % hp at
    # off (1, 3, 6)) must leave the output bit-equal, whose pad rows are
    # zeros.  Inputs from a generator of their own (here and in the batch-8
    # DownSample), so that the later phases' inputs, which F32_BEFORE's
    # lines depend on, stay as they were drawn
    gud = torch.Generator(device=dev).manual_seed(SEED + 9)
    pb = to_dtype({"down": params["downsample"], "up": params["upsample"]},
                  torch.bfloat16)
    for name, fn, p, gin, gout, work in (
            ("down_sample_wm", down_sample_wm, pb["down"], g0, g1,
             down_work(rows(g0), rows(g1), g0.dim)),
            ("up_sample_wm", up_sample_wm, pb["up"], g2, g3,
             up_work(rows(g2), rows(g3), g2.dim, g3.dim))):
        xs = storage(gin, torch.bfloat16, g=gud)
        print(f"{name} bf16 by class (torch.profiler): " + class_breakdown(
            lambda fn=fn, p=p, xs=xs, gin=gin, gout=gout:
                fn(p, xs, gin, gout, half), work))
        grid = from_window_major(xs, gin.window)
        kept = pad_rows_zeroed(grid, gin, half[1])
        junk = to_window_major(kept + 50 * (grid - kept),
                               gin.window).contiguous()
        got, with_junk = fn(p, xs, gin, gout, half), fn(p, junk, gin, gout, half)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, with_junk))
        zeros = not from_window_major(got, gout.window)[:, :, gout.h:].any()
        print(f"{name} bf16, junk (50x) on the input's latitude-pad rows: "
              f"output bit-equal {same}; output pad rows zero {zeros}")
        if not (same and zeros):
            raise AssertionError(f"{name}: pad rows reach the output")
    del xs, grid, kept, junk, got, with_junk, pb

    # bf16 transition and both recovery branches, at the served offset: by
    # class of kernel (gather, product and epilogue are one kernel); junk on
    # the rolled pair's latitude-pad rows, which none reads, must leave
    # their outputs bit-equal.  Inputs from a generator of their own
    gedge = torch.Generator(device=dev).manual_seed(SEED + 11)
    skip, dec = (storage(g0, torch.bfloat16, g=gedge) for _ in range(2))
    tp = build_transition_wm(params, consts_dev, perf)
    pr = params["patch_recovery"]
    edge_fns = {
        "transition_wm": lambda a, b: apply_transition_wm(tp, a, b, g0, half),
        "recovery_wm_upper": lambda a, b: recovery_wm_upper(pr, a, b, half,
                                                            perf),
        "recovery_wm_surface": lambda a, b: recovery_wm_surface(pr, a, b, half,
                                                                perf)}
    edge_cost = {      # phase 3's work and bytes of the three
        "transition_wm": (2 * valid0 * 2 * c0 * c0,
                          3 * valid0 * c0 * 2 + 6 * 2 * c0 * c0 * 2
                          + rows(g0) * c0 * 2),
        "recovery_wm_upper": (2 * upper_rows * 2 * c0 * 160,
                              2 * upper_rows * c0 * 2
                              + weight_bytes(pr["upper"], torch.bfloat16)
                              + field_u * 2),
        "recovery_wm_surface": (2 * g0.h * g0.w * 2 * c0 * 64,
                                2 * g0.h * g0.w * c0 * 2
                                + weight_bytes(pr["surface"], torch.bfloat16)
                                + field_s * 2)}
    junk = []
    for t in (skip, dec):
        grid = from_window_major(t, g0.window)
        kept = pad_rows_zeroed(grid, g0, half[1])
        junk.append(to_window_major(kept + 50 * (grid - kept),
                                    g0.window).contiguous())
    for name, fn in edge_fns.items():
        print(f"{name} bf16 by class (torch.profiler): " + class_breakdown(
            lambda fn=fn: fn(skip, dec), edge_work(*edge_cost[name]),
            edge_class))
        got, with_junk = fn(skip, dec), fn(*junk)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, with_junk))
        print(f"{name} bf16, junk (50x) on the pair's latitude-pad rows: "
              f"output bit-equal {same}")
        if not same:
            raise AssertionError(f"{name}: the pair's pad rows reach the "
                                 "output")
    del skip, dec, grid, kept, junk, got, with_junk
    # the bf16 embed wrapper by prepass, upper product and plane-0 copy, on
    # the bf16 state of its phase-3 line
    pe, ub, sb = params["patch_embed"], u0.to(torch.bfloat16), \
        s0.to(torch.bfloat16)
    plane_bytes = g0.h_padded * g0.w * c0 * 2
    print("embed_wm bf16 by class (torch.profiler): " + class_breakdown(
        lambda: embed_wm(pe, ub, sb, consts_dev, perf),
        embed_work(2 * upper_rows * pe["upper"]["kernel"].shape[0] * c0,
                   nbytes(ub), consts_dev["const_h"].numel() * 2,
                   g0.h * g0.w * c0 * 2, plane_bytes,
                   (g0.z - 1) * plane_bytes), embed_class, detail="prepass"))
    del ub, sb

    # a batch of 8, the last sample against a batch-1 launch: at stage 0
    # 8 x 535,680 rows, 33,480 row tiles of the 128-row tensor-core
    # products (66,960 of the first version's 64-row tiles), and a batch
    # of 16 through UpSample, whose mix product then has 66,960 row tiles,
    # more than a grid's y dimension holds
    s0b, ids0 = params["stages"][0]["blocks"][1], ids_of(g0)
    x8 = storage(g0, torch.bfloat16, batch=8)
    got = block_wm(s0b, x8, g0, half, 3, ids0, True)[7]
    want = block_wm(s0b, x8[7:].contiguous(), g0, half, 3, ids0, True)[0]
    torch.cuda.synchronize()
    b8 = [("block_wm stage 0 shifted", 8, got, want)]
    del x8
    x8 = storage(g0, torch.bfloat16, batch=8, g=gud)
    got = down_sample_wm(params["downsample"], x8, g0, g1, half)[7]
    want = down_sample_wm(params["downsample"], x8[7:].contiguous(), g0, g1,
                          half)[0]
    torch.cuda.synchronize()
    b8.append(("down_sample_wm", 8, got, want))
    del x8
    x8 = storage(g2, torch.bfloat16, batch=8)
    got = up_sample_wm(params["upsample"], x8, g2, g3, half)[7]
    want = up_sample_wm(params["upsample"], x8[7:].contiguous(), g2, g3,
                        half)[0]
    torch.cuda.synchronize()
    b8.append(("up_sample_wm", 8, got, want))
    del x8
    x8 = storage(g2, torch.bfloat16, batch=16, g=gud)
    got = up_sample_wm(params["upsample"], x8, g2, g3, half)[15]
    want = up_sample_wm(params["upsample"], x8[15:].contiguous(), g2, g3,
                        half)[0]
    torch.cuda.synchronize()
    b8.append(("up_sample_wm", 16, got, want))
    del x8
    x8 = torch.randn((8, g2.z, g2.h, g2.w, g2.dim), generator=gud,
                     device=dev).to(torch.bfloat16)
    got = up_sample(params["upsample"], x8, g3.h)[7]
    want = up_sample(params["upsample"], x8[7:].contiguous(), g3.h)[0]
    torch.cuda.synchronize()
    b8.append(("up_sample", 8, got, want))
    del x8
    # the canonical DownSample: batch 8, its first sample by class and, at
    # offset (0, 0, 0) on the same grid with zero pad rows, the window-major
    # DownSample's real rows bit-equal to it
    x8 = torch.randn((8, g0.z, g0.h, g0.w, c0), generator=gud,
                     device=dev).to(torch.bfloat16)
    got = down_sample(params["downsample"], x8)[7]
    want = down_sample(params["downsample"], x8[7:].contiguous())[0]
    torch.cuda.synchronize()
    b8.append(("down_sample", 8, got, want))
    x1 = x8[:1].contiguous()
    print("down_sample bf16 by class (torch.profiler): " + class_breakdown(
        lambda: down_sample(params["downsample"], x1),
        down_work(g0.z * g0.h * g0.w, g1.z * g1.h * g1.w, c0)))
    grid = torch.nn.functional.pad(x1, (0, 0, 0, 0, 0, g0.h_padded - g0.h))
    wm = from_window_major(down_sample_wm(
        params["downsample"], to_window_major(grid, g0.window).contiguous(),
        g0, g1, (0, 0, 0)), g1.window)[:, :, :g1.h]
    same = bool(torch.equal(wm, down_sample(params["downsample"], x1)))
    print(f"down_sample_wm bf16 at off (0, 0, 0) on the canonical grid: its "
          f"real rows bit-equal to down_sample {same}")
    if not same:
        raise AssertionError("the window-major and canonical DownSample "
                             "differ on the same tokens")
    del x8, x1, grid, wm
    s8, d8 = (storage(g0, torch.bfloat16, batch=8, g=gedge) for _ in range(2))
    for name, fn in edge_fns.items():
        got = fn(s8, d8)[7]
        want = fn(s8[7:].contiguous(), d8[7:].contiguous())[0]
        torch.cuda.synchronize()
        b8.append((name, 8, got, want))
    del s8, d8, tp, edge_fns
    u8 = (consts_dev["upper_mean"][None] + consts_dev["upper_std"][None]
          * torch.randn((8, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                        generator=gedge, device=dev)).to(torch.bfloat16)
    s8 = (consts_dev["surface_mean"][None] + consts_dev["surface_std"][None]
          * torch.randn((8, 4, PANGU_24.lat, PANGU_24.lon), generator=gedge,
                        device=dev)).to(torch.bfloat16)
    got = embed_wm(pe, u8, s8, consts_dev, perf)[7]
    want = embed_wm(pe, u8[7:].contiguous(), s8[7:].contiguous(), consts_dev,
                    perf)[0]
    torch.cuda.synchronize()
    b8.append(("embed_wm", 8, got, want))
    del u8, s8
    for label, batch, got, want in b8:
        err, rel = rel_err(got, want)
        same = bool(torch.equal(got, want))
        print(f"batch {batch}, sample {batch - 1} vs batch 1: {label} bf16 "
              f"max_abs_err {err:.3e} rel {rel:.3e} bit-equal {same} (tol "
              f"{TOL[torch.bfloat16]:.1e})")
        if rel > TOL[torch.bfloat16]:
            raise AssertionError(f"batch {batch} {label}: rel err {rel:.3e}")
        if label in BIT_IDENTICAL_FWD and not same:
            raise AssertionError(f"batch {batch} {label}: the last sample "
                                 "differs from a batch-1 launch")
    del got, want, b8
    torch.cuda.empty_cache()

    params32 = to_dtype(params, torch.float32)
    cfg32 = dataclasses.replace(PANGU_24, gelu="erf")
    for label, cfg in (("float32", cfg32),
                       ("float32 edge kernels",
                        dataclasses.replace(cfg32, edge_kernels=True))):
        got = pangu.forward(params32, u0, s0, consts_dev, cfg, device=dev)
        want = pangu.forward(params32, u0, s0, consts_dev, cfg, device=dev,
                             kernels=False)
        for part, a, b in zip(("upper", "surface"), got, want):
            err, rel = rel_err(a, b)
            print(f"forward {label} {part}: max_abs_err {err:.3e} rel "
                  f"{rel:.3e} (tol {TOL_FORWARD[torch.float32]:.1e})")
            if rel > TOL_FORWARD[torch.float32]:
                raise AssertionError(f"{label} forward {part}: rel err {rel:.3e}")
        del got, want
    del params32
    torch.cuda.empty_cache()
    done("kernels vs plain versions, full width", t0)

    # per trunk at lat_group 2: stages 0 and 3 (nlat 31, gh 1) through
    # block_wm, the 12 blocks of stages 1-2 (nlat 16, gh 2) grouped
    trunk_counts = {"block_wm": perf.depths[0] + perf.depths[3],
                    "block_wm_group": perf.depths[1] + perf.depths[2],
                    "down_sample_wm": 1, "up_sample_wm": 1}
    path_counts = {}

    # ---- 4a. main path: a chained full-step rollout -----------------------
    t0 = phase(f"{STEPS}-step rollout, Pangu-24 perf config")
    rollout = make_rollout(perf, consts, STEPS, return_trajectory=True,
                           device=dev)
    rollout(params, u0, s0)                     # warm the allocator
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_run = time.perf_counter()
    _, (ut, st) = rollout(params, u0, s0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_run) * 1e3 / STEPS
    counts = ops.launches()
    path_counts["full-step rollout"] = counts
    peak = torch.cuda.max_memory_allocated()
    print(f"launches {counts}")
    want_counts = {**{name: 0 for name in counts},
                   **{k: STEPS * v for k, v in trunk_counts.items()}}
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
          f"peak memory {peak / 2**30:.2f} GiB, of which {held / 2**30:.2f} "
          "GiB held before the rollout")
    del rollout, ut, st, pu, ps
    done(f"{STEPS}-step rollout, Pangu-24 perf config", t0)

    # ---- 4b. main path: the token-space chained rollout -------------------
    t0 = phase(f"{TOKEN_STEPS}-step token-space rollout, edge kernels")
    perf_edge = dataclasses.replace(perf, edge_kernels=True)

    def timed(fn):
        fn(params, u0, s0)                      # warm the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t_run = time.perf_counter()
        out = fn(params, u0, s0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_run) * 1e3 / TOKEN_STEPS
        return out, ms, ops.launches(), torch.cuda.max_memory_allocated()

    (tu, ts), tok_ms, tok_counts, tok_peak = timed(make_rollout(
        perf_edge, consts, TOKEN_STEPS, token_space=True, device=dev))
    print(f"launches {tok_counts}")
    path_counts["token-space rollout"] = tok_counts
    want_counts = {**{name: 0 for name in tok_counts},
                   **{k: TOKEN_STEPS * v for k, v in trunk_counts.items()},
                   "embed_wm": 1, "transition_wm": TOKEN_STEPS - 1,
                   "recovery_wm_upper": 1, "recovery_wm_surface": 1}
    if tok_counts != want_counts:
        raise AssertionError(f"launch counts {tok_counts} != {want_counts}")
    if tu.shape != (1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon) \
            or ts.shape != (1, 4, PANGU_24.lat, PANGU_24.lon):
        raise AssertionError(f"final state shapes {tu.shape} {ts.shape}")
    if not (torch.isfinite(tu).all() and torch.isfinite(ts).all()):
        raise AssertionError("token-space rollout output is not finite")
    (fu, fs), full_ms, _, full_peak = timed(make_rollout(
        perf, consts, TOKEN_STEPS, device=dev))
    # the JAX package's default served step: the full step with the edge
    # kernels, embed and both recoveries every step
    (eu, es), edge_ms, edge_counts, edge_peak = timed(make_rollout(
        perf_edge, consts, TOKEN_STEPS, device=dev))
    print(f"launches, full-step rollout with edge kernels {edge_counts}")
    path_counts["full-step rollout, edge kernels"] = edge_counts
    want_counts = {**{name: 0 for name in edge_counts},
                   **{k: TOKEN_STEPS * v for k, v in trunk_counts.items()},
                   "embed_wm": TOKEN_STEPS, "recovery_wm_upper": TOKEN_STEPS,
                   "recovery_wm_surface": TOKEN_STEPS}
    if edge_counts != want_counts:
        raise AssertionError(f"launch counts {edge_counts} != {want_counts}")
    plain_u, plain_s = make_rollout(perf_edge, consts, TOKEN_STEPS,
                                    token_space=True, device=dev,
                                    kernels=False)(params, u0, s0)
    plain_eu, plain_es = make_rollout(perf_edge, consts, TOKEN_STEPS,
                                      device=dev, kernels=False)(params, u0, s0)
    failed = []
    for what, (xu, xs_), other, (ou, os_) in (
            ("token-space", (tu, ts), "plain versions", (plain_u, plain_s)),
            ("token-space", (tu, ts), "full-step rollout", (fu, fs)),
            ("full-step with edge kernels", (eu, es), "plain versions",
             (plain_eu, plain_es))):
        for part, a, b in zip(("upper", "surface"),
                              norm_data(xu, xs_, consts_dev),
                              norm_data(ou, os_, consts_dev)):
            err, rel = rel_err(a, b)
            mean = float((a - b).abs().mean())
            print(f"final state bf16 {what} {part} vs {other}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} mean_abs_err "
                  f"{mean:.3e} (tol {TOL_FORWARD[torch.bfloat16]:.1e})")
            if rel > TOL_FORWARD[torch.bfloat16]:
                failed.append(f"{what} {part} vs {other}: rel err {rel:.3e}")
    if failed:
        raise AssertionError("final states: " + "; ".join(failed))

    # not gates: the bf16 rollouts against the full-step rollout in float32
    # (perf config otherwise) after 3 and 7 chained steps, and the
    # token-space rollout against the bf16 full-step one; also the
    # token-space rollout without the edge kernels (plain embed and
    # recovery, transition kernel between steps)
    perf32 = dataclasses.replace(perf, param_dtype="float32",
                                 compute_dtype="float32")
    _, ref = make_rollout(perf32, consts, DRIFT_STEPS[-1],
                          return_trajectory=True, device=dev)(
        to_dtype(params, torch.float32), u0, s0)
    _, full = make_rollout(perf, consts, DRIFT_STEPS[-1],
                           return_trajectory=True, device=dev)(params, u0, s0)
    for n in DRIFT_STEPS:
        runs = {"full-step": (full[0][n - 1], full[1][n - 1]),
                "token-space": (tu, ts) if n == TOKEN_STEPS else make_rollout(
                    perf_edge, consts, n, token_space=True, device=dev)(
                        params, u0, s0),
                "token-space without edge kernels": make_rollout(
                    perf, consts, n, token_space=True, device=dev)(
                        params, u0, s0)}
        refs = {"float32 full-step": (ref[0][n - 1], ref[1][n - 1]),
                "bf16 full-step": runs["full-step"]}
        for name, (xu, xs_) in runs.items():
            for other, (ou, os_) in refs.items():
                if other == "bf16 full-step" and name == "full-step":
                    continue
                for part, a, b in zip(("upper", "surface"),
                                      norm_data(xu, xs_, consts_dev),
                                      norm_data(ou, os_, consts_dev)):
                    err, rel = rel_err(a, b)
                    mean = float((a - b).abs().mean())
                    print(f"drift (not a gate) {n} steps: bf16 {name} {part} "
                          f"vs {other}: max_abs_err {err:.3e} rel {rel:.3e} "
                          f"mean_abs_err {mean:.3e}")
        del runs, refs
    del ref, full
    print(f"token-space rollout: {tok_ms:.1f} ms per step ({TOKEN_STEPS} "
          f"steps, batch 1, bf16), peak memory {tok_peak / 2**30:.2f} GiB")
    print(f"full-step rollout:   {full_ms:.1f} ms per step ({TOKEN_STEPS} "
          f"steps, batch 1, bf16), peak memory {full_peak / 2**30:.2f} GiB")
    print(f"full-step rollout with edge kernels: {edge_ms:.1f} ms per step "
          f"({TOKEN_STEPS} steps, batch 1, bf16), peak memory "
          f"{edge_peak / 2**30:.2f} GiB")
    _, g1_ms, _, _ = timed(make_rollout(dataclasses.replace(perf, lat_group=1),
                                        consts, TOKEN_STEPS, device=dev))
    print(f"full-step rollout at lat_group 1 (not a gate): {g1_ms:.1f} ms per "
          f"step ({TOKEN_STEPS} steps, batch 1, bf16)")
    del tu, ts, fu, fs, eu, es, plain_u, plain_s, plain_eu, plain_es
    torch.cuda.empty_cache()
    done(f"{TOKEN_STEPS}-step token-space rollout, edge kernels", t0)

    # ---- 4c. main path: the hierarchical rollout ----------------------------
    t0 = phase(f"hierarchical rollout, {HIER_HORIZON} h from {HIER_MODELS} h "
               "models")
    params_by_h = {HIER_MODELS[0]: params,
                   HIER_MODELS[1]: pangu.init_params(
                       torch.Generator().manual_seed(SEED + 1), perf,
                       device=dev)}
    hier = {}
    for name, cfg, token in (("full-step", perf, False),
                             ("token-space", perf_edge, True)):
        fn, schedule = make_hierarchical_rollout(
            cfg, consts, HIER_HORIZON, HIER_MODELS, token_space=token,
            device=dev)
        fn(params_by_h, u0, s0)                 # warm the allocator
        torch.cuda.synchronize()
        ops.reset_launches()
        t_run = time.perf_counter()
        out = fn(params_by_h, u0, s0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_run) * 1e3 / len(schedule)
        counts = ops.launches()
        path_counts[f"hierarchical {name} rollout"] = counts
        steps = len(schedule)
        want_counts = {**{k: 0 for k in counts},
                       **{k: steps * v for k, v in trunk_counts.items()}}
        if token:
            want_counts.update({"embed_wm": 1, "transition_wm": steps - 1,
                                "recovery_wm_upper": 1,
                                "recovery_wm_surface": 1})
        print(f"{name}: schedule {schedule}, {ms:.1f} ms per step, "
              f"launches {counts}")
        if schedule != [24, 6] or counts != want_counts:
            raise AssertionError(f"hierarchical {name}: schedule {schedule}, "
                                 f"launch counts {counts} != {want_counts}")
        plain = make_hierarchical_rollout(
            cfg, consts, HIER_HORIZON, HIER_MODELS, token_space=token,
            device=dev, kernels=False)[0](params_by_h, u0, s0)
        hier[name] = out
        checks = [("plain path", plain)]
        if token:
            checks.append(("full-step hierarchical rollout", hier["full-step"]))
        for other, ref in checks:
            for part, a, b in zip(("upper", "surface"),
                                  norm_data(*out, consts_dev),
                                  norm_data(*ref, consts_dev)):
                err, rel = rel_err(a, b)
                print(f"hierarchical {name} final bf16 {part} vs {other}: "
                      f"max_abs_err {err:.3e} rel {rel:.3e} "
                      f"(tol {TOL_FORWARD[torch.bfloat16]:.1e})")
                if rel > TOL_FORWARD[torch.bfloat16]:
                    raise AssertionError(f"hierarchical {name} {part} vs "
                                         f"{other}: rel err {rel:.3e}")
        del plain
    del params_by_h, hier, out
    torch.cuda.empty_cache()
    done(f"hierarchical rollout, {HIER_HORIZON} h from {HIER_MODELS} h models",
         t0)

    # ---- 4d. main path: forward(taps={}), the canonical-layout trunk ------
    t0 = phase("forward with taps, float32")
    params32 = to_dtype(params, torch.float32)
    taps, plain_taps = {}, {}
    ops.reset_launches()
    got = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev,
                        taps=taps)
    torch.cuda.synchronize()
    counts = ops.launches()
    path_counts["forward with taps"] = counts
    print(f"launches {counts}")
    # per stage two end-point blocks, the rest of stages 1 and 2 grouped
    want_counts = {**{k: 0 for k in counts},
                   "block_wm_canon": 8, "block_wm": sum(
                       d - 2 for d in (perf.depths[0], perf.depths[3])),
                   "block_wm_group": sum(d - 2 for d in perf.depths[1:3]),
                   "down_sample": 1, "up_sample": 1}
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts} != {want_counts}")
    want = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev,
                         taps=plain_taps, kernels=False)
    wm = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev)
    checks = [(f"output {part} vs {other}", a, b)
              for other, ref in (("window-major forward", wm),
                                 ("plain path", want))
              for part, a, b in zip(("upper", "surface"), got, ref)]
    checks += [(f"tap {name} vs plain path", taps[name], plain_taps[name])
               for name in plain_taps]
    for label, a, b in checks:
        err, rel = rel_err(a, b)
        print(f"taps forward float32 {label}: max_abs_err {err:.3e} rel "
              f"{rel:.3e} (tol {TOL_FORWARD[torch.float32]:.1e})")
        if rel > TOL_FORWARD[torch.float32]:
            raise AssertionError(f"taps forward {label}: rel err {rel:.3e}")
    if sorted(taps) != sorted(["embed", "stage0", "downsample", "stage1",
                               "stage2", "upsample", "stage3"]):
        raise AssertionError(f"taps {sorted(taps)}")
    for label, kw in (("with taps", {"taps": {}}), ("window-major", {})):
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev, **kw)
        torch.cuda.synchronize()
        print(f"forward float32 {label}: "
              f"{(time.perf_counter() - t_run) * 1e3:.1f} ms (batch 1)")
    del params32, taps, plain_taps, got, want, wm, checks
    torch.cuda.empty_cache()
    done("forward with taps, float32", t0)

    # ---- 5. where the time goes --------------------------------------------
    t0 = phase("step breakdown (CUDA events, 3 reps each)")
    g = perf.stage(0)
    cdt = torch.bfloat16
    uc, sc = u0.to(cdt), s0.to(cdt)

    def embed():
        x = L.patch_embed(params["patch_embed"], uc, sc, consts_dev, perf)
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

    tp = build_transition_wm(params, consts_dev, perf_edge)
    full = {"embed + to_window_major": time_ms(embed, 3),
            "trunk (16 blocks, down, up)": time_ms(trunk, 3),
            "canonicalise + recovery + denorm": time_ms(recover, 3)}
    token = {"trunk (16 blocks, down, up)": full["trunk (16 blocks, down, up)"],
             "transition_wm": time_ms(
                 lambda: apply_transition_wm(tp, skip, dec, g, off), 3)}
    once = {"embed_wm": time_ms(
                lambda: embed_wm(params["patch_embed"], uc, sc, consts_dev,
                                 perf_edge), 3),
            "recovery_wm + denorm": time_ms(
                lambda: denorm_data(*recovery_wm(params["patch_recovery"], skip,
                                                 dec, off, perf_edge),
                                    consts_dev), 3),
            "build_transition_wm": time_ms(
                lambda: build_transition_wm(params, consts_dev, perf_edge), 3)}
    for title, parts in (("full step", full),
                         ("token-space chained step", token),
                         ("token-space, once per rollout", once)):
        total = sum(parts.values())
        print(f"{title}: {total:.3f} ms")
        for part, ms in parts.items():
            print(f"  {part:34s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    # inside one stage-1 block, ungrouped and grouped: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    g1 = perf.stage(1)
    xs1, ids1 = storage(g1, cdt), ids_of(g1)
    bp1 = params["stages"][1]["blocks"][1]
    gh = _pick_gh(g1.h_padded // g1.window[1], perf.lat_group)
    for label, fn in (
            ("block_wm", lambda: block_wm(bp1, xs1, g1, half, 3, ids1, True)),
            (f"block_wm_group (gh {gh})",
             lambda: block_wm_group(bp1, xs1, g1, half, 3, ids1, True, gh))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 3e3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        total = sum(ms for _, ms in rows)
        print(f"stage-1 shifted block, {label}: device time {total:.3f} ms "
              "per block by kernel (torch.profiler)"
              if rows else f"{label}: profiler saw no device time")
        for key, ms in rows:
            print(f"  {key[:60]:60s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")
    del xs1
    done("step breakdown (CUDA events, 3 reps each)", t0)

    del xs, skip, dec, uc, sc, tp, trunk
    torch.cuda.empty_cache()

    # ---- 6. the training step -------------------------------------------
    t0 = phase("training step, Pangu-24 full width")
    train_phase(params, perf, consts, consts_dev, state, storage, ids_of,
                block_cost, weight_bytes, records, path_counts)
    done("training step, Pangu-24 full width", t0)

    # ---- 7. the block_layout="v2" trunk ---------------------------------
    t0 = phase('block_layout="v2": kernels, forward, rollouts, training')
    v2 = v2_phase(params, perf, consts_dev, state, ids_of, weight_bytes,
                  records, path_counts)
    done('block_layout="v2": kernels, forward, rollouts, training', t0)

    # ---- 8. the per-block path and LoRA ----------------------------------
    t0 = phase("per-block path and LoRA: kernels, served step, training")
    per_block = per_block_phase(params, perf, consts_dev, state, ids_of,
                                weight_bytes, records, path_counts)
    done("per-block path and LoRA: kernels, served step, training", t0)

    # ---- 9. the last kernel sites, the canonical route and attn_impl -----
    t0 = phase("fused window attention, canonical training route, "
               'attn_impl="xla"')
    canon = canon_phase(params, perf, consts_dev, state, storage, ids_of,
                        block_cost, weight_bytes, records, path_counts)
    done("fused window attention, canonical training route, "
         'attn_impl="xla"', t0)

    import tempfile
    with tempfile.TemporaryDirectory(prefix="pangu_cli_") as tmp:
        # ---- 10. the command lines -----------------------------------------
        t0 = phase("command lines: forecast and score, Pangu-24 full width")
        kept = {}
        cli = cli_phase(smi, trunk_counts, path_counts, tmp, kept)
        done("command lines: forecast and score, Pangu-24 full width", t0)

        # ---- 11. the sharded serving path ----------------------------------
        t0 = phase(f"sharded serving: row 5z, a world of {WORLD} ranks, "
                   f"mesh {WORLD_MESH}")
        sharded = sharded_phase(smi, records, path_counts, tmp, kept)
        done("sharded serving", t0)

        # ---- 12. sharded training ----------------------------------------
        t0 = phase(f"sharded training: a world of {WORLD} ranks, meshes "
                   f"{[m[0] for m in TRAIN_MESHES]}")
        sharded_train = sharded_train_phase(smi, path_counts, tmp)
        done("sharded training", t0)

        # ---- 13. the canonical-layout route under a mesh ------------------
        t0 = phase(f"canonical route under a mesh: shard kernels, a world of "
                   f"{WORLD} ranks, meshes {CANON_MESH}, "
                   f"{CANON_REFUSED_MESH}, {CANON_TRAIN_MESH}")
        canon_sharded = canon_world_phase(smi, path_counts, tmp)
        done("canonical route under a mesh", t0)

    sources = {"block_wm": ("pangu_tpu_torch/csrc/block_wm.cu",
                            "pangu_tpu/ops/earth_block_wm.py:358"),
               "block_wm_group": ("pangu_tpu_torch/csrc/block_wm.cu",
                                  "pangu_tpu/ops/earth_block_wm.py:848"),
               "block_wm_canon": ("pangu_tpu_torch/csrc/block_wm.cu",
                                  "pangu_tpu/ops/earth_block_wm.py:358"),
               "down_sample_wm": ("pangu_tpu_torch/csrc/updown_wm.cu",
                                  "pangu_tpu/ops/updown_wm.py:169"),
               "up_sample_wm": ("pangu_tpu_torch/csrc/updown_wm.cu",
                                "pangu_tpu/ops/updown_wm.py:305"),
               "embed_wm": ("pangu_tpu_torch/csrc/embed_wm.cu",
                            "pangu_tpu/ops/embed_wm.py:195"),
               "transition_wm": ("pangu_tpu_torch/csrc/transition_wm.cu",
                                 "pangu_tpu/engine/transition_wm.py:244"),
               "recovery_wm_upper": ("pangu_tpu_torch/csrc/recovery_wm.cu",
                                     "pangu_tpu/ops/recovery_wm.py:231"),
               "recovery_wm_surface": ("pangu_tpu_torch/csrc/recovery_wm.cu",
                                       "pangu_tpu/ops/recovery_wm.py:272"),
               "down_sample": ("pangu_tpu_torch/csrc/updown.cu",
                               "pangu_tpu/ops/updown.py:93"),
               "up_sample": ("pangu_tpu_torch/csrc/updown.cu",
                             "pangu_tpu/ops/updown.py:193"),
               "block_bwd": ("pangu_tpu_torch/csrc/block_bwd.cu",
                             "pangu_tpu/ops/earth_block_bwd.py:555"),
               "block_bwd_canon": ("pangu_tpu_torch/csrc/block_bwd.cu",
                                   "pangu_tpu/ops/earth_block_bwd.py:555"),
               "embed_dw_upper": ("pangu_tpu_torch/csrc/embed_dw.cu",
                                  "pangu_tpu/ops/embed_wm.py:323"),
               "recovery_bwd": ("pangu_tpu_torch/csrc/recovery_bwd.cu",
                                "pangu_tpu/ops/recovery_wm.py:502"),
               "block_v2": ("pangu_tpu_torch/csrc/block_wm.cu",
                            "pangu_tpu/ops/earth_block_fused.py:300"),
               "grid_attention": ("pangu_tpu_torch/csrc/grid_attn.cu",
                                  "pangu_tpu/ops/window_attention.py:502"),
               "grid_attention_bwd": ("pangu_tpu_torch/csrc/grid_attn.cu",
                                      "pangu_tpu/ops/window_attention.py:725"),
               "sdpa": ("pangu_tpu_torch/csrc/sdpa.cu",
                        "pangu_tpu/ops/window_attention.py:95"),
               "sdpa_bwd": ("pangu_tpu_torch/csrc/sdpa.cu",
                            "pangu_tpu/ops/window_attention.py:190"),
               "block_noroll_fused": ("pangu_tpu_torch/csrc/block_wm.cu",
                                      "pangu_tpu/ops/window_attention.py:882"),
               "fused_block_tail": ("pangu_tpu_torch/csrc/block_tail.cu",
                                    "pangu_tpu/ops/block_tail.py:130"),
               "window_attention_pallas": (
                   "pangu_tpu_torch/csrc/window_attn.cu",
                   "pangu_tpu/ops/window_attention.py:294"),
               "transition_wm_z": ("pangu_tpu_torch/csrc/transition_wm.cu",
                                   "pangu_tpu/engine/transition_wm.py:244")}
    # launches: each kernel's count on the main path that runs it most
    launches = {name: max(c.get(name, 0) for c in path_counts.values())
                for name in sources}
    unlaunched = [name for name, n in launches.items() if n == 0]
    if unlaunched or set(sources) != set(ops.launches()):
        raise AssertionError(f"kernels no main path launched: {unlaunched}")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "library_ms": None,
                **records[name]}
               for name, (src, rep) in sources.items()]
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"rollout": {"ms_per_step": step_ms, "steps": STEPS,
                                  "batch": 1, "peak_bytes": peak},
                      "token_space_rollout": {
                          "ms_per_step": tok_ms, "steps": TOKEN_STEPS,
                          "batch": 1, "peak_bytes": tok_peak,
                          "full_step_ms_per_step": full_ms,
                          "full_step_edge_kernels_ms_per_step": edge_ms},
                      "v2": v2, "per_block": per_block, "canon": canon,
                      "cli": cli, "sharded": sharded,
                      "sharded_train": sharded_train,
                      "canon_sharded": canon_sharded}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def tree_errs(got, want, path=""):
    """(path, max abs error, error relative to max |want|) of every leaf of
    two nested dict / list trees."""
    if isinstance(want, dict):
        return [e for k in want for e in tree_errs(got[k], want[k],
                                                   f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        return [e for i, w in enumerate(want)
                for e in tree_errs(got[i], w, f"{path}/{i}")]
    return [(path, *rel_err(got, want))]


def float32_train_steps(params, fields, tgt, consts_dev, runs, pairs, label):
    """Float32 train steps at full width from the same parameters and
    stochastic-depth scales, each run ``(name, cfg, kernels)`` or ``(name,
    cfg, kernels, tree)`` (its own parameter tree) back-propagating the first
    run's loss cotangent; then each pair ``(a, b)`` of names is held to the
    gates: loss within 1e-4 relative, every gradient leaf of b within 1e-3
    of its max (the leaves the two trees share)."""
    from pangu_tpu_torch.config import PANGU_24, TrainConfig
    from pangu_tpu_torch.engine.train import weighted_l1_loss
    from pangu_tpu_torch.models import pangu

    dev = torch.device("cuda")
    drops = pangu.draw_drops(
        PANGU_24, torch.Generator(device=dev).manual_seed(SEED + 4), 1)
    res, d_out = {}, None
    for name, cfg, kernels, *tree in runs:
        p32 = to_dtype(tree[0] if tree else params, torch.float32)
        for t in leaves(p32):
            t.requires_grad_(True)
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        outs = pangu.forward(p32, *fields, consts_dev, cfg, device=dev,
                             kernels=kernels, deterministic=False, drops=drops)
        loss = weighted_l1_loss(*outs, *tgt, TrainConfig())[0]
        if d_out is None:
            d_out = torch.autograd.grad(loss, outs, retain_graph=True)
        torch.autograd.backward(outs, d_out)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_run) * 1e3
        print(f"{label}float32 train step, {name}: loss "
              f"{float(loss.detach()):.6f}, {ms:.1f} ms")
        res[name] = (float(loss.detach()),
                     {k: t.grad for k, t in named_leaves(p32)})
        del p32, outs, loss
    for a, b in pairs:
        (la, ga), (lb, gb) = res[a], res[b]
        rel = abs(la - lb) / abs(lb)
        errs = tree_errs(ga, gb)
        worst = max(errs, key=lambda e: e[2])
        print(f"{label}float32 train step {a} vs {b}: loss rel {rel:.3e} (tol "
              f"1.0e-4); gradients ({len(errs)} leaves, the same loss "
              f"cotangent): worst {worst[0]} max_abs_err {worst[1]:.3e} rel "
              f"{worst[2]:.3e} (tol 1.0e-3)")
        if rel > 1e-4 or worst[2] > 1e-3:
            raise AssertionError(f"{label}float32 train step {a} vs {b}: "
                                 f"loss rel {rel:.3e}, gradient {worst}")
    del res, d_out
    torch.cuda.empty_cache()


# the bf16 units held to two runs agreeing bit for bit (phase 3 holds the
# block_wm entries there)
BIT_IDENTICAL = ("block_bwd", "block_bwd_canon", "grid_attention_bwd",
                 "block_wm drop", "block_v2", "grid_attention",
                 "block_noroll_fused", "block_wm_group", "fused_block_tail",
                 "recovery_bwd", "embed_dw_upper", "window_attention_pallas")


def flat(tree):
    """The tensors of a nested dict / list / tuple tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat(v)]
    return [tree]


def check_kernels(cases, dtype, records):
    """Each case ``(name, label, flops, bytes, kernel, plain, (reps,
    plain_reps))``: the kernel's result (a tensor or a tree of them) against
    its plain version (the worst leaf, relative to its max), the kernel's and
    the plain version's ms over that many launches and the bound; a case out
    of tolerance raises.  The bf16 backward units (``BIT_IDENTICAL``) run
    twice more and must agree bit for bit.  A kernel's first bf16 case at
    stage 0, an offset or full width is its record.  Returns each case's
    numbers."""
    from pangu_tpu_torch import ops
    lines = []
    for name, label, flops, byts, kern, plain, (reps, plain_reps) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs = tree_errs(got, want)
        del want
        same = ""
        if dtype == torch.bfloat16 and name in BIT_IDENTICAL:
            again = kern()
            if not all(torch.equal(a, b) for a, b in zip(flat(got),
                                                         flat(again))):
                raise AssertionError(f"{name} {label}: two bf16 runs differ")
            same = "  bit-identical in two runs"
            del again
        del got
        err = max(e[1] for e in errs)
        rel = max(e[2] for e in errs)
        worst = max(errs, key=lambda e: e[2])[0]
        if dtype == torch.float32:
            same += f32_as_before(name, label, err, rel)
        ms = time_ms(kern, reps)
        plain_ms = time_ms(plain, plain_reps)
        bound_ms, bound_by = bound(flops, byts, dtype)
        ok = rel <= TOL[dtype]
        was = previous_ms(name, label) if dtype == torch.bfloat16 else None
        print(f"{name:18s} {label:36s} {str(dtype):15s} max_abs_err "
              f"{err:.3e} rel {rel:.3e} (worst {worst or 'out'}, tol "
              f"{TOL[dtype]:.1e}) {'ok' if ok else 'FAIL'}  kernel "
              f"{ms:.3f} ms{f' (was {was} ms)' if was else ''}  plain "
              f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms ({bound_by})"
              f"{same}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label} {dtype}: rel err {rel:.3e}")
        if (dtype == torch.bfloat16 and name in ops.kernels()
                and name not in records
                and label.startswith(("stage 0", "off", "full"))):
            records[name] = {"max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "at": f"{label}, bf16"}
        lines.append({"name": name, "label": label, "max_abs_err": err,
                      "rel": rel, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
    return lines


def adam_steps(cfg, params, batch, consts_dev, step_counts, path_counts,
               label):
    """bf16 training in ``cfg``: two runs of one step's gradient (they must
    agree bit for bit), TRAIN_STEPS Adam steps with the launch counters read
    per step (they must equal ``step_counts``), then one step in parts
    (forward + loss, backward, Adam; host clock and memory after each) and
    device time by kernel over one more step (torch.profiler).  Returns
    (ms per step, peak bytes, losses)."""
    from torch.profiler import ProfilerActivity, profile

    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.data.constants import norm_data
    from pangu_tpu_torch.engine.train import (create_train_state,
                                              loss_and_grads, make_optimizer,
                                              make_train_step,
                                              weighted_l1_loss)
    from pangu_tpu_torch.models import pangu

    dev = torch.device("cuda")
    tcfg = TrainConfig()
    # copies (bf16 -> float32 -> bf16 is exact): the steps update in place
    ptrain = to_dtype(to_dtype(params, torch.float32), torch.bfloat16)
    opt = make_optimizer(tcfg)
    state_ = create_train_state(ptrain, opt)
    # two runs of one step's gradient on the same input and seed
    runs = [[t.clone() for t in leaves(loss_and_grads(
        ptrain, batch, consts_dev, cfg, tcfg, device=dev,
        seed=SEED + 5)[2])] for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"{label}bf16 gradient, two runs of one step: bit-identical {same}")
    if not same:
        raise AssertionError(f"{label}bf16 gradients differ between two runs")
    del runs
    step = make_train_step(cfg, tcfg, consts_dev, opt, device=dev)
    losses, norms, total = [], [], {k: 0 for k in ops.launches()}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    for i in range(TRAIN_STEPS):
        ops.reset_launches()
        state_, metrics = step(state_, batch, SEED + 10 + i)
        counts = ops.launches()
        want = {**{k: 0 for k in counts}, **step_counts}
        if counts != want:
            raise AssertionError(f"{label}train step {i}: launch counts "
                                 f"{counts} != {want}")
        for k, v in counts.items():
            total[k] += v
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t_run) * 1e3 / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    norms = [float(v) for v in norms]
    path_counts[f"{TRAIN_STEPS} {label}train steps"] = total
    print(f"{label}launches per train step {step_counts}")
    print(f"{label}train steps (bf16, batch 1, Adam): losses {losses}, grad "
          f"norms {norms}")
    print(f"{label}train step: {train_ms:.1f} ms per step ({TRAIN_STEPS} "
          f"steps, batch 1, bf16), peak memory {peak / 2**30:.2f} GiB, of "
          f"which {held / 2**30:.2f} GiB held before the steps (params, Adam "
          f"state, gradients, inputs)")
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{label}train steps: losses {losses}, norms "
                             f"{norms}")

    # where a step's time and memory go: forward + loss, backward, Adam
    for t in leaves(ptrain):
        t.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    outs = pangu.forward(ptrain, batch["upper"], batch["surface"], consts_dev,
                         cfg, device=dev, deterministic=False,
                         gen=torch.Generator(device=dev).manual_seed(SEED + 30))
    loss = weighted_l1_loss(*outs, *norm_data(batch["target_upper"],
                                              batch["target_surface"],
                                              consts_dev), tcfg)[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak_fwd, held = (torch.cuda.max_memory_allocated(),
                      torch.cuda.memory_allocated())
    loss.backward()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak_bwd = torch.cuda.max_memory_allocated()
    opt.apply(state_.opt_state)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    del outs, loss
    gib = 2.0 ** 30
    print(f"{label}train step parts (bf16, host clock): forward + loss "
          f"{(t2 - t1) * 1e3:.1f} ms, backward {(t3 - t2) * 1e3:.1f} ms, Adam "
          f"{(t4 - t3) * 1e3:.1f} ms; memory: before {base / gib:.2f} GiB, "
          f"peak in forward {peak_fwd / gib:.2f} GiB, held for backward "
          f"{held / gib:.2f} GiB, peak in backward {peak_bwd / gib:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state_, _ = step(state_, batch, SEED + 31)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total_ms = sum(ms for _, ms in rows)
    print(f"{label}train step device time by kernel (torch.profiler): "
          f"{total_ms:.1f} ms")
    for key, ms in rows[:25]:
        print(f"  {key[:70]:70s} {ms:9.3f} ms  {100 * ms / total_ms:5.1f}%")
    del state_, step, ptrain
    torch.cuda.empty_cache()
    return train_ms, peak, losses


def train_phase(params, perf, consts, consts_dev, state, storage, ids_of,
                block_cost, weight_bytes, records, path_counts):
    """Phase 6: the training kernels against their plain versions, the
    float32 train step against the plain path, 3 bf16 Adam steps."""
    from pangu_tpu_torch.config import PANGU_24, TrainConfig
    from pangu_tpu_torch.data.constants import norm_data
    from pangu_tpu_torch.engine.train import weighted_l1_loss
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.ops.earth_block_bwd import block_bwd, block_bwd_plain
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_plain,
                                                    from_window_major,
                                                    to_window_major)
    from pangu_tpu_torch.ops.embed_wm import (embed_dw_operands,
                                              embed_dw_upper,
                                              embed_dw_upper_plain)
    from pangu_tpu_torch.ops.recovery_wm import (recovery_bwd,
                                                 recovery_bwd_plain)

    dev = torch.device("cuda")
    half = (1, 3, 6)
    g0, g1 = PANGU_24.stage(0), PANGU_24.stage(1)
    u0, s0 = state(SEED + 2)
    u1, s1 = state(SEED + 3)                    # the targets
    field_u, field_s = u0.numel(), s0.numel()
    cfg = PANGU_24
    rows_all_0 = g0.z * g0.h_padded * g0.w     # stage-0 storage rows

    def kernels_vs_plain():
        # ---- 6a. the training kernels against their plain versions -----------
        for dtype in (torch.float32, torch.bfloat16):
            tanh = dtype == torch.bfloat16
            isz = torch.tensor([], dtype=dtype).element_size()
            pdt = to_dtype({"s0": params["stages"][0]["blocks"][1],
                            "s1": params["stages"][1]["blocks"][1],
                            "pr": params["patch_recovery"]}, dtype)
            ecfg = dataclasses.replace(cfg, compute_dtype="float32" if not tanh
                                       else "bfloat16")
            cases = []  # (name, label, flops, bytes, kernel, plain, reps)
            for label, geom, bp, drop in (
                    ("stage 0 shifted, scales (0.8, 1.25)", g0, pdt["s0"],
                     [[0.8, 1.25]]),
                    ("stage 1 shifted, scales (1.25, 0)", g1, pdt["s1"],
                     [[1.25, 0.0]]),
                    ("stage 0 shifted, no scales", g0, pdt["s0"], None),
                    ("stage 1 shifted, no scales", g1, pdt["s1"], None)):
                drop = None if drop is None else torch.tensor(drop, device=dev)
                xs, gx, ids = storage(geom, dtype), storage(geom, dtype), ids_of(geom)
                flops, byts = block_cost(bp, xs, ids)
                if drop is not None:
                    cases.append((
                        "block_wm drop", label, flops, byts,
                        lambda bp=bp, xs=xs, geom=geom, i=ids, d=drop, t=tanh:
                            block_wm(bp, xs, geom, half, 3, i, t, d),
                        lambda bp=bp, xs=xs, geom=geom, i=ids, d=drop, t=tanh:
                            block_wm_plain(bp, xs, geom, half, 3, i, t, d),
                        (2, 1)))
                # three times the forward's operations (recompute, data and
                # weight gradients); x, g read and dx written, the table read
                # and its float32 gradient written, the weights and their
                # float32 gradients
                nw = sum(t.numel() for t in leaves(bp) if t.dim() < 4)
                cases.append((
                    "block_bwd", label, 3 * flops,
                    3 * nbytes(xs) + nbytes(bp["attn"]["bias_table"])
                    + bp["attn"]["bias_table"].numel() * 4 + nbytes(ids)
                    + weight_bytes(bp, dtype) + 4 * nw,
                    lambda bp=bp, xs=xs, gx=gx, geom=geom, i=ids, d=drop, t=tanh:
                        block_bwd(bp, xs, gx, geom, half, half, 3, i, d, t),
                    lambda bp=bp, xs=xs, gx=gx, geom=geom, i=ids, d=drop, t=tanh:
                        block_bwd_plain(bp, xs, gx, geom, half, half, 3, i, d, t),
                    (2, 1)))
            skip, dec = storage(g0, dtype), storage(g0, dtype)
            du, ds = u1.to(dtype), s1.to(dtype)      # field-shaped cotangents
            c0 = g0.dim
            rows_all = g0.z * g0.h_padded * g0.w
            rows_real = g0.z * g0.h * g0.w
            kf = 5 * 32 * (g0.z - 1) * g0.h * g0.w + 4 * 16 * g0.h * g0.w
            for off in (half, (0, 0, 0)):  # the record first: (1, 3, 6)
                cases.append((  # token cotangents of every row, head gradients
                    "recovery_bwd", f"off {off}",
                    2 * rows_all * 160 * 2 * c0 + 2 * kf * 2 * c0,
                    (field_u + field_s) * isz + 2 * nbytes(skip)
                    + weight_bytes(pdt["pr"], dtype) + 2 * rows_all * c0 * isz
                    + 4 * (2 * c0 + 1) * (160 + 64),
                    lambda a=skip, b=dec, u=du, v=ds, p=pdt["pr"], cf=ecfg,
                    o=off: recovery_bwd(p, a, b, u, v, o, cf),
                    lambda a=skip, b=dec, u=du, v=ds, p=pdt["pr"], cf=ecfg,
                    o=off: recovery_bwd_plain(p, a, b, u, v, o, cf), (2, 1)))
            dxs = storage(g0, dtype)
            upper_rows = (g0.z - 1) * g0.h * g0.w
            cases.append((     # the upper rows of the cotangent, the field
                "embed_dw_upper", "full width",
                2 * upper_rows * 193 * c0,
                upper_rows * c0 * isz + field_u * 4
                + consts_dev["const_h"].numel() * 4 + 193 * c0 * 4,
                lambda d=dxs, cf=ecfg: embed_dw_upper(d, u0, consts_dev, cf),
                lambda d=dxs, cf=ecfg: embed_dw_upper_plain(d, u0, consts_dev, cf),
                (2, 1)))
            check_kernels(cases, dtype, records)
            if dtype == torch.bfloat16:   # one stage-0 launch by class
                kern = next(c[4] for c in cases if c[0] == "block_bwd")
                hidden = params["stages"][0]["blocks"][1]["mlp"]["fc1"][
                    "kernel"].shape[-1]
                print("block_bwd stage 0 bf16 by class (torch.profiler): "
                      + class_breakdown(kern, bwd_work(
                          g0.z * g0.h_padded * g0.w, c0, hidden,
                          g0.window_tokens), bwd_class), flush=True)
                kern = next(c[4] for c in cases if c[0] == "recovery_bwd")
                print("recovery_bwd off (1, 3, 6) bf16 by class "
                      "(torch.profiler): " + class_breakdown(
                          kern, recovery_work(rows_all, c0, 160, 64,
                                              field_u + field_s),
                          recovery_class), flush=True)
                embed_dw_checks(dxs, ecfg)
            del cases, skip, dec, dxs, du, ds
            torch.cuda.empty_cache()

    def embed_dw_checks(dxs, ecfg):
        # the bf16 upper embed weight gradient by class; junk (50x) on the
        # cotangent's token-lat pad rows and other values on plane 0's rows
        # must leave dK and db bit-equal (neither is summed); the library
        # yardstick, cuDNN's Conv3d weight gradient, on its own layout
        k = cfg.upper_patch_features
        print("embed_dw_upper full width bf16 by class (torch.profiler): "
              + class_breakdown(
                  lambda: embed_dw_upper(dxs, u0, consts_dev, ecfg),
                  dw_work(rows_all_0, k, g0.dim, field_u,
                          consts_dev["const_h"].numel()), dw_class),
              flush=True)
        grid = from_window_major(dxs, g0.window).clone()
        grid[:, :, g0.h:] = 50 * grid[:, :, g0.h:] + 7
        grid[:, 0] = -3 * grid[:, 0] + 1
        junk = to_window_major(grid, g0.window).contiguous()
        got = embed_dw_upper(dxs, u0, consts_dev, ecfg)
        same = all(torch.equal(a, b) for a, b in zip(
            got, embed_dw_upper(junk, u0, consts_dev, ecfg)))
        print(f"embed_dw_upper bf16, junk (50x) on the cotangent's token-lat "
              f"pad rows and other values on plane 0's rows: dK, db "
              f"bit-equal {same}", flush=True)
        if not same:
            raise AssertionError("embed_dw_upper: the cotangent's pad rows or "
                                 "plane 0 reach dK or db")
        _, un, ch = embed_dw_operands(dxs, u0, consts_dev, ecfg)
        relayout, library = embed_dw_library(dxs, un, ch, ecfg)
        x6, dy = relayout()
        rel = max(e[2] for e in tree_errs(
            library(x6, dy), embed_dw_upper_plain(dxs, u0, consts_dev, ecfg)))
        lib_ms = time_ms(lambda: library(x6, dy), 2)
        relayout_ms = time_ms(relayout, 2)
        records["embed_dw_upper"]["library_ms"] = lib_ms
        print(f"library (embed_dw_upper full width, bf16): cuDNN "
              f"convolution_backward (weight and bias of the equivalent "
              f"Conv3d, canonical layout) {lib_ms:.3f} ms, rel {rel:.3e} "
              f"against the plain version (its outputs bf16); the relayout "
              f"into that layout {relayout_ms:.3f} ms apart", flush=True)
        del grid, junk, got, un, ch, x6, dy

    def float32_step():
        # ---- 6b. the float32 train step, kernels against plain versions -------
        # The weighted L1 loss has a kink at every output equal to its target:
        # where the two paths' outputs (equal to float32 rounding) fall on
        # either side of a target, their loss cotangents differ in sign.  Two
        # gates: (1) both paths back-propagate the kernel path's loss
        # cotangent, every leaf within 1e-3; (2) each path back-propagates its
        # own, at most FLIPS_MAX outputs flip, and every leaf within 1e-3 plus
        # what the flips alone move it (the plain path's gradient under the
        # two cotangents): leaves the flips move by at most 1e-4 are held to
        # 1e-3 itself.
        cfg32 = dataclasses.replace(cfg, edge_kernels=True)
        tgt = norm_data(u1, s1, consts_dev)
        res = {}
        d_out = None
        for kernels in (True, False):
            p32 = to_dtype(params, torch.float32)
            for t in leaves(p32):
                t.requires_grad_(True)
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            outs = pangu.forward(p32, u0, s0, consts_dev, cfg32, device=dev,
                                 kernels=kernels, deterministic=False, drops=drops)
            loss = weighted_l1_loss(*outs, *tgt, tcfg)[0]
            if d_out is None:
                d_out = torch.autograd.grad(loss, outs, retain_graph=True)
            torch.autograd.backward(outs, d_out, retain_graph=not kernels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_run) * 1e3
            shared = {k: t.grad.clone() for k, t in named_leaves(p32)}
            own = shared
            if not kernels:
                for t in leaves(p32):
                    t.grad = None
                loss.backward()
                own = {k: t.grad for k, t in named_leaves(p32)}
            signs = [torch.sign(o.detach().float() - t) for o, t in zip(outs, tgt)]
            print(f"float32 train step, {'kernels' if kernels else 'plain'}: "
                  f"loss {float(loss.detach()):.6f}, {ms:.1f} ms")
            res[kernels] = (float(loss.detach()), shared, own, signs)
            del p32, outs, loss
        (lk, gk, _, sk), (lp, gps, gpo, sp) = res[True], res[False]
        n_out = sum(t.numel() for t in sk)
        flips = sum(int((a != b).sum()) for a, b in zip(sk, sp))
        rel = abs(lk - lp) / abs(lp)
        errs = tree_errs(gk, gps)
        worst = max(errs, key=lambda e: e[2])
        print(f"float32 train step kernels vs plain: loss rel {rel:.3e} (tol "
              f"1.0e-4); gradients ({len(errs)} leaves, the same loss cotangent): "
              f"worst {worst[0]} max_abs_err {worst[1]:.3e} rel {worst[2]:.3e} "
              f"(tol 1.0e-3)")
        # (path, own-cotangent error, the flips' own effect on the plain path)
        own = [(e[0], e[2], f[2]) for e, f in zip(tree_errs(gk, gpo),
                                                  tree_errs(gps, gpo))]
        moved = [o for o in own if o[2] > 1e-4]
        held = [o for o in own if o[2] <= 1e-4]
        bad = ([o for o in held if o[1] > 1e-3]
               + [o for o in moved if o[1] > 1e-3 + o[2]])
        w_held = max(held, key=lambda o: o[1])
        print(f"float32 train step, each path's own loss cotangent: {flips} of "
              f"{n_out} outputs on the other side of their target (tol "
              f"{FLIPS_MAX}); {len(held)} leaves the flips move by <= 1e-4, "
              f"worst {w_held[0]} rel {w_held[1]:.3e} (tol 1.0e-3); "
              f"{len(moved)} leaves they move more, tol 1e-3 + that move:")
        for p, e, f in sorted(moved, key=lambda o: -o[2]):
            print(f"  {p:45s} rel {e:.3e}, moved by the flips {f:.3e}")
        if rel > 1e-4 or worst[2] > 1e-3 or flips > FLIPS_MAX or bad:
            raise AssertionError(f"float32 train step: loss rel {rel:.3e}, "
                                 f"gradient {worst}, {flips} flips, own "
                                 f"cotangent {bad}")
        del res, gk, gps, gpo
        torch.cuda.empty_cache()

    def bf16_steps():
        # ---- 6c. Adam steps in the perf config ---------------------------------
        step_counts = {"block_wm": 16, "block_bwd": 16, "down_sample_wm": 1,
                       "up_sample_wm": 1, "embed_wm": 1, "embed_dw_upper": 1,
                       "recovery_wm_upper": 1, "recovery_wm_surface": 1,
                       "recovery_bwd": 1}
        train_ms, peak, losses = adam_steps(
            dataclasses.replace(perf, edge_kernels=True), params, batch,
            consts_dev, step_counts, path_counts, "")
        print(json.dumps({"train_step": {"ms_per_step": train_ms,
                                         "steps": TRAIN_STEPS, "batch": 1,
                                         "peak_bytes": peak, "losses": losses}}))

    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    tcfg = TrainConfig()
    rates = cfg.drop_path_rates()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    drops = [pangu._stage_drops(cfg.depths[i], rates, sum(cfg.depths[:i]),
                                gen, 1) for i in range(4)]
    print("stochastic-depth scales: "
          + " ".join(f"{float(d[0, 0]):.3f}/{float(d[0, 1]):.3f}"
                     for st in drops for d in st))
    kernels_vs_plain()
    float32_step()
    bf16_steps()


def v2_phase(params, perf, consts_dev, state, ids_of, weight_bytes, records,
             path_counts):
    """Phase 7: the rolled-coordinate ``block_layout="v2"`` trunk: its three
    kernels against their plain versions, its float32 forward, its served
    rollouts and its training step.  Returns the numbers of its JSON line."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.data.constants import norm_data
    from pangu_tpu_torch.engine.rollout import make_rollout, single_step
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    from pangu_tpu_torch.ops.window_attention import (
        grid_attention, grid_attention_bwd, grid_attention_bwd_plain,
        grid_attention_plain)

    dev = torch.device("cuda")
    half, neg = (1, 3, 6), (-1, -3, -6)
    g0, g1 = PANGU_24.stage(0), PANGU_24.stage(1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    u0, s0 = state(SEED + 2)
    u1, s1 = state(SEED + 3)                    # the training targets
    v2 = dataclasses.replace(perf, block_layout="v2")
    out = {}

    def grid(geom, dtype):
        return torch.randn((1, geom.z, geom.h_padded, geom.w, geom.dim),
                           generator=gen, device=dev).to(dtype)

    # ---- 7a. the v2 kernels against their plain versions --------------------
    for dtype in (torch.float32, torch.bfloat16):
        tanh = dtype == torch.bfloat16
        pdt = to_dtype({"s0": params["stages"][0]["blocks"][1],
                        "s1": params["stages"][1]["blocks"][1]}, dtype)
        cases = []  # (name, label, flops, bytes, kernel, plain, timing reps)
        for label, geom, bp, delta, canon, shifted, drop in (
                ("stage 0 shifted", g0, pdt["s0"], half, 3, True, None),
                ("stage 0 -half, scales (0.8, 1.25)", g0, pdt["s0"], neg, 0,
                 False, [[0.8, 1.25]]),
                ("stage 1 shifted, scales (1.25, 0)", g1, pdt["s1"], half, 3,
                 True, [[1.25, 0.0]]),
                ("stage 1 -half", g1, pdt["s1"], neg, 0, False, None)):
            x = grid(geom, dtype)
            ids = ids_of(geom) if shifted else None
            d = None if drop is None else torch.tensor(drop, device=dev)
            c, n = geom.dim, geom.window_tokens
            rows = x.numel() // c
            byts = (2 * nbytes(x) + nbytes(bp["attn"]["bias_table"])
                    + weight_bytes(bp, dtype)
                    + (nbytes(ids) if ids is not None else 0))
            cases.append((
                "block_v2", label, 2 * rows * c * (12 * c + 2 * n), byts,
                lambda bp=bp, x=x, g=geom, dl=delta, ca=canon, i=ids, d=d,
                t=tanh: block_v2(bp, x, g, dl, ca, i, t, d),
                lambda bp=bp, x=x, g=geom, dl=delta, ca=canon, i=ids, d=d,
                t=tanh: block_v2_plain(bp, x, g, dl, ca, i, t, d), (3, 2)))
        for label, geom, bp, masked in (("stage 0, region ids", g0, pdt["s0"],
                                         True),
                                        ("stage 1, no ids", g1, pdt["s1"],
                                         False)):
            x, gy = grid(geom, dtype), grid(geom, dtype)
            ids = ids_of(geom) if masked else None
            at = bp["attn"]
            w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
                 at["proj"]["bias"])
            table = at["bias_table"]
            c, n = geom.dim, geom.window_tokens
            rows = x.numel() // c
            idb = nbytes(ids) if ids is not None else 0
            cases.append((   # qkv, q.k, p.v, proj; x in, out, weights, table
                "grid_attention", label, 2 * rows * c * (4 * c + 2 * n),
                2 * nbytes(x) + nbytes(*w, table) + idb,
                lambda x=x, w=w, tb=table, g=geom, i=ids:
                    grid_attention(x, *w, tb, g.window, i),
                lambda x=x, w=w, tb=table, g=geom, i=ids:
                    grid_attention_plain(x, *w, tb, g.window, i), (3, 2)))
            # multiply-adds per row: recompute qkv 3C^2, dWp C^2, da C^2,
            # dWqkv 3C^2, dx 3C^2; q.k, p.v, dV, dP, dQ, dK N*C each;
            # x, g read, dx written, weights and table read, their float32
            # gradients written
            cases.append((
                "grid_attention_bwd", label, 2 * rows * (11 * c * c + 6 * n * c),
                3 * nbytes(x) + nbytes(*w[:3], table) + idb
                + 4 * (sum(t.numel() for t in w) + table.numel()),
                lambda x=x, gy=gy, w=w, tb=table, g=geom, i=ids:
                    grid_attention_bwd(x, gy, *w[:3], tb, g.window, i),
                lambda x=x, gy=gy, w=w, tb=table, g=geom, i=ids:
                    grid_attention_bwd_plain(x, gy, *w[:3], tb, g.window, i),
                (2, 1)))
        check_kernels(cases, dtype, records)
        del cases, x, gy
        torch.cuda.empty_cache()

    # ---- 7b. the float32 v2 forward ----------------------------------------
    params32 = to_dtype(params, torch.float32)
    cfg32 = dataclasses.replace(PANGU_24, gelu="erf")
    v2_32 = dataclasses.replace(cfg32, block_layout="v2")
    trunk_counts = {"block_v2": sum(perf.depths), "down_sample": 1,
                    "up_sample": 1}
    ops.reset_launches()
    got = pangu.forward(params32, u0, s0, consts_dev, v2_32, device=dev)
    torch.cuda.synchronize()
    counts = ops.launches()
    if counts != {**{k: 0 for k in counts}, **trunk_counts}:
        raise AssertionError(f"v2 forward launch counts {counts}")
    want = pangu.forward(params32, u0, s0, consts_dev, v2_32, device=dev,
                         kernels=False)
    wm = pangu.forward(params32, u0, s0, consts_dev, cfg32, device=dev)
    for other, ref in (("plain path", want), ("window-major forward", wm)):
        for part, a, b in zip(("upper", "surface"), got, ref):
            err, rel = rel_err(a, b)
            print(f"v2 forward float32 {part} vs {other}: max_abs_err "
                  f"{err:.3e} rel {rel:.3e} (tol "
                  f"{TOL_FORWARD[torch.float32]:.1e})")
            if rel > TOL_FORWARD[torch.float32]:
                raise AssertionError(f"v2 forward {part} vs {other}: rel "
                                     f"err {rel:.3e}")
    del got, want, wm, ref, a, b, params32
    torch.cuda.empty_cache()

    # ---- 7c, 7d. the served v2 rollouts ------------------------------------
    def timed(fn, steps):
        fn(params, u0, s0)                      # warm the allocator
        torch.cuda.synchronize()
        print(f"held before the v2 rollout: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t_run = time.perf_counter()
        res = fn(params, u0, s0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_run) * 1e3 / steps
        counts = ops.launches()
        want = {**{k: 0 for k in counts},
                **{k: steps * v for k, v in trunk_counts.items()}}
        if counts != want:
            raise AssertionError(f"v2 launch counts {counts} != {want}")
        return res, ms, counts, torch.cuda.max_memory_allocated()

    (_, (ut, st)), step_ms, counts, peak = timed(
        make_rollout(v2, consts_dev, STEPS, return_trajectory=True,
                     device=dev), STEPS)
    path_counts["v2 full-step rollout"] = counts
    print(f"v2 full-step rollout launches {counts}")
    if not (torch.isfinite(ut).all() and torch.isfinite(st).all()):
        raise AssertionError("v2 rollout output is not finite")
    pu, ps = single_step(params, u0, s0, consts_dev, v2, device=dev,
                         kernels=False)
    for part, a, b in zip(("upper", "surface"),
                          norm_data(ut[0], st[0], consts_dev),
                          norm_data(pu, ps, consts_dev)):
        err, rel = rel_err(a, b)
        print(f"v2 step 1 bf16 {part} vs plain path: max_abs_err {err:.3e} "
              f"rel {rel:.3e} (tol {TOL_FORWARD[torch.bfloat16]:.1e})")
        if rel > TOL_FORWARD[torch.bfloat16]:
            raise AssertionError(f"v2 bf16 step 1 {part}: rel err {rel:.3e}")
    del ut, st, pu, ps
    (tu, ts), tok_ms, tok_counts, tok_peak = timed(
        make_rollout(v2, consts_dev, TOKEN_STEPS, token_space=True,
                     device=dev), TOKEN_STEPS)
    path_counts["v2 token-space rollout"] = tok_counts
    print(f"v2 token-space rollout launches {tok_counts}")
    (fu, fs), full_ms, _, full_peak = timed(
        make_rollout(v2, consts_dev, TOKEN_STEPS, device=dev), TOKEN_STEPS)
    for part, a, b in zip(("upper", "surface"), norm_data(tu, ts, consts_dev),
                          norm_data(fu, fs, consts_dev)):
        err, rel = rel_err(a, b)
        print(f"v2 final state bf16 token-space {part} vs full-step: "
              f"max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tol {TOL_FORWARD[torch.bfloat16]:.1e})")
        if rel > TOL_FORWARD[torch.bfloat16]:
            raise AssertionError(f"v2 token-space {part}: rel err {rel:.3e}")
    del tu, ts, fu, fs
    print(f"v2 full-step rollout: {step_ms:.1f} ms per step ({STEPS} steps, "
          f"batch 1, bf16), peak memory {peak / 2**30:.2f} GiB; "
          f"{full_ms:.1f} ms per step over {TOKEN_STEPS} steps")
    print(f"v2 token-space rollout: {tok_ms:.1f} ms per step ({TOKEN_STEPS} "
          f"steps, batch 1, bf16), peak memory {tok_peak / 2**30:.2f} GiB")
    out.update(rollout_ms_per_step=step_ms, rollout_peak_bytes=peak,
               token_space_ms_per_step=tok_ms, token_space_peak_bytes=tok_peak)
    torch.cuda.empty_cache()

    # ---- 7e. the float32 v2 train step, kernels against plain versions ------
    cfg = dataclasses.replace(PANGU_24, block_layout="v2")
    float32_train_steps(params, (u0, s0), norm_data(u1, s1, consts_dev),
                        consts_dev, [("kernels", cfg, True),
                                     ("plain", cfg, False)],
                        [("kernels", "plain")], "v2 ")

    # ---- 7f. Adam steps in the perf config ---------------------------------
    n = sum(perf.depths)
    step_counts = {"block_v2": n, "grid_attention": n,
                   "grid_attention_bwd": n, "down_sample": 1, "up_sample": 1}
    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    train_ms, peak, losses = adam_steps(v2, params, batch, consts_dev,
                                        step_counts, path_counts, "v2 ")
    out.update(train_ms_per_step=train_ms, train_peak_bytes=peak,
               train_losses=losses)
    return out


def per_block_phase(params, perf, consts_dev, state, ids_of, weight_bytes,
                    records, path_counts):
    """Phase 8: the per-block path (``L.earth_block``) and LoRA: the four
    kernels against their plain versions, the served per-block step, the
    per-block train step under both grid attention backwards, a v2 step
    with the "xla" backward and the LoRA fine-tuning steps.  Returns the
    numbers of its JSON line."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import PANGU_24, TrainConfig
    from pangu_tpu_torch.data.constants import norm_data
    from pangu_tpu_torch.engine.train import (attach_lora, create_train_state,
                                              loss_and_grads, make_train_step)
    from pangu_tpu_torch.models import lora, pangu
    from pangu_tpu_torch.ops.block_tail import (fused_block_tail,
                                                fused_block_tail_plain)
    from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                      block_noroll_plain,
                                                      sdpa, sdpa_bwd,
                                                      sdpa_bwd_plain,
                                                      sdpa_plain)

    dev = torch.device("cuda")
    F = torch.nn.functional
    g0, g1 = PANGU_24.stage(0), PANGU_24.stage(1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    u0, s0 = state(SEED + 2)
    u1, s1 = state(SEED + 3)                    # the training targets
    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    tgt = norm_data(u1, s1, consts_dev)
    out = {}

    # ---- 8a. the kernels against their plain versions -----------------------
    def sdpa_inputs(geom, dtype, masked):
        nwin, ntype, heads = geom.w // geom.window[2], geom.num_window_types, \
            geom.heads
        hd, n = geom.dim // heads, geom.window_tokens
        qkv = torch.randn((nwin, ntype, 3, heads, hd, n), generator=gen,
                          device=dev).to(dtype)
        g = torch.randn((nwin, ntype, heads, hd, n), generator=gen,
                        device=dev).to(dtype)
        bp = params["stages"][0 if geom is g0 else 1]["blocks"][0]
        bias = bp["attn"]["bias_table"].float()
        if masked:
            ids = ids_of(geom)
            bias = bias + torch.where(ids[:, None, :] != ids[:, :, None],
                                      -100.0, 0.0)[:, None]
        return qkv, bias.contiguous(), g

    for dtype in (torch.float32, torch.bfloat16):
        tanh = dtype == torch.bfloat16
        pdt = to_dtype({"s0": params["stages"][0]["blocks"][0],
                        "s1": params["stages"][1]["blocks"][0]}, dtype)
        cases = []  # (name, label, flops, bytes, kernel, plain, timing reps)
        for label, geom, bp in (("stage 0", g0, pdt["s0"]),
                                ("stage 1", g1, pdt["s1"])):
            c, n = geom.dim, geom.window_tokens
            hidden = bp["mlp"]["fc1"]["kernel"].shape[-1]
            xg = torch.randn((1, geom.z, geom.h_padded, geom.w, c),
                             generator=gen, device=dev).to(dtype)
            xg[:, :, geom.h:] = 0                   # the caller's zero pad
            rows = xg.numel() // c
            cases.append((
                "block_noroll_fused", f"{label}, padded grid",
                2 * rows * c * (12 * c + 2 * n),
                2 * nbytes(xg) + nbytes(bp["attn"]["bias_table"])
                + weight_bytes(bp, dtype),
                lambda bp=bp, x=xg, g=geom, t=tanh:
                    block_noroll_fused(bp, x, g, t)[:, :, :g.h],
                lambda bp=bp, x=xg, g=geom, t=tanh:
                    block_noroll_plain(bp, x, g, t)[:, :, :g.h], (3, 2)))
            a = torch.randn((1, geom.z, geom.h, geom.w, c), generator=gen,
                            device=dev).to(dtype)
            sc = torch.randn(a.shape, generator=gen, device=dev).to(dtype)
            tail = {k: bp[k] for k in ("norm1", "norm2", "mlp")}
            rows = a.numel() // c
            # bf16: the perf config's tanh GELU (the record), then erf
            forms = [(tanh, "")] + ([(False, ", erf GELU")] if tanh else [])
            for t, form in forms:
                cases.append((
                    "fused_block_tail", f"{label}, cropped grid{form}",
                    4 * rows * c * hidden,
                    3 * nbytes(a) + weight_bytes(tail, dtype),
                    lambda p=tail, a=a, s=sc, t=t: fused_block_tail(p, a, s, t),
                    lambda p=tail, a=a, s=sc, t=t:
                        fused_block_tail_plain(p, a, s, t), (3, 2)))
            for masked in (True, False):
                qkv, bias, gy = sdpa_inputs(geom, dtype, masked)
                nwh = qkv.shape[0] * qkv.shape[1] * qkv.shape[3]
                hd = qkv.shape[4]
                m = "folded mask" if masked else "no mask"
                cases.append((
                    "sdpa", f"{label}, {m}", 4 * nwh * n * n * hd,
                    nbytes(qkv, bias) + nbytes(gy),
                    lambda q=qkv, b=bias: sdpa(q, b),
                    lambda q=qkv, b=bias: sdpa_plain(q, b), (3, 2)))
                # s, dV, dP, dQ, dK: 2 N^2 hd multiply-adds each; qkv, bias,
                # g read, dqkv and the float32 dbias written
                cases.append((
                    "sdpa_bwd", f"{label}, {m}", 10 * nwh * n * n * hd,
                    2 * nbytes(qkv) + 2 * nbytes(bias) + nbytes(gy),
                    lambda q=qkv, b=bias, g=gy: sdpa_bwd(q, b, g),
                    lambda q=qkv, b=bias, g=gy: sdpa_bwd_plain(q, b, g),
                    (2, 1)))
        check_kernels(cases, dtype, records)
        if dtype == torch.bfloat16:       # one stage-0 tail by class
            kern = next(c[4] for c in cases if c[0] == "fused_block_tail")
            print("fused_block_tail stage 0 bf16 by class (torch.profiler): "
                  + class_breakdown(kern, tail_work(
                      g0.z * g0.h * g0.w, g0.dim, 4 * g0.dim)), flush=True)
        del cases
        torch.cuda.empty_cache()

    # two bf16 runs of each sdpa kernel on the same stage-0 input agree bit
    # for bit; then the library column: scaled_dot_product_attention on the
    # same inputs in its own (batch, heads, N, hd) layout, the float bias as
    # attn_mask, beside the kernels' times again, stages 0 and 1
    for label, geom in (("stage 0", g0), ("stage 1", g1)):
        qkv, bias, gy = sdpa_inputs(geom, torch.bfloat16, True)
        if geom is g0:
            same = (torch.equal(sdpa(qkv, bias), sdpa(qkv, bias))
                    and all(torch.equal(a, b) for a, b in zip(
                        sdpa_bwd(qkv, bias, gy), sdpa_bwd(qkv, bias, gy))))
            print(f"sdpa and sdpa_bwd bit-identical in two runs (stage 0, "
                  f"bf16, folded mask): {same}")
            if not same:
                raise AssertionError("sdpa / sdpa_bwd differ between runs")
        nwin, ntype, _, heads, hd, n = qkv.shape
        q, k, v = (qkv[:, :, i].reshape(nwin * ntype, heads, hd, n)
                   .transpose(-1, -2).contiguous() for i in range(3))
        mask = bias.to(torch.bfloat16)[None].expand(nwin, -1, -1, -1, -1) \
            .reshape(nwin * ntype, heads, n, n)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), 3)
        go = gy.reshape(nwin * ntype, heads, hd, n).transpose(-1, -2) \
            .contiguous()
        try:
            leaves_ = [t.detach().requires_grad_(True) for t in (q, k, v)]
            mask_g = mask.detach().clone().requires_grad_(True)
            o = F.scaled_dot_product_attention(*leaves_, attn_mask=mask_g)
            bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                o, leaves_ + [mask_g], go, retain_graph=True), 2)
            del o
        except RuntimeError as e:           # no gradient of a float mask here
            print(f"scaled_dot_product_attention backward with a float "
                  f"mask: {e}")
            bwd_lib_ms = None
        ms = time_ms(lambda: sdpa(qkv, bias), 3)
        bwd_ms = time_ms(lambda: sdpa_bwd(qkv, bias, gy), 2)
        if geom is g0:
            records["sdpa"]["library_ms"] = lib_ms
            records["sdpa_bwd"]["library_ms"] = bwd_lib_ms
        print(f"library ({label}, bf16, folded mask): "
              f"scaled_dot_product_attention {lib_ms:.3f} ms against sdpa "
              f"{ms:.3f} ms; its backward with the mask's gradient "
              f"{bwd_lib_ms} ms against sdpa_bwd {bwd_ms:.3f} ms")
        del q, k, v, mask, go, qkv, bias, gy
        torch.cuda.empty_cache()

    # ---- 8b. the served per-block step: adapters on each stage's first block
    tree = lora.init_lora(gen, params, rank=16, alpha=16.0)
    for sp in tree["stages"]:
        sp["blocks"] = [sp["blocks"][0]] + [lora.strip_lora(bp)
                                            for bp in sp["blocks"][1:]]
    tree["downsample"] = lora.strip_lora(tree["downsample"])
    tree["upsample"] = lora.strip_lora(tree["upsample"])
    for bp in (sp["blocks"][0] for sp in tree["stages"]):
        for site in (bp["attn"]["qkv"], bp["attn"]["proj"], bp["mlp"]["fc1"],
                     bp["mlp"]["fc2"]):
            site["lora_b"] = (0.02 * torch.randn(
                site["lora_b"].shape, generator=gen, device=dev)).to(
                    site["lora_b"].dtype)
    served = {"block_noroll_fused": 4, "grid_attention": 8,
              "fused_block_tail": 8, "down_sample": 1, "up_sample": 1}
    cfg_pb = dataclasses.replace(perf, lora_fused=False)
    with torch.no_grad():
        pangu.forward(tree, u0, s0, consts_dev, cfg_pb, device=dev)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t_run = time.perf_counter()
        got = pangu.forward(tree, u0, s0, consts_dev, cfg_pb, device=dev)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_run) * 1e3
        counts = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        if counts != {**{k: 0 for k in counts}, **served}:
            raise AssertionError(f"served per-block launch counts {counts}")
        path_counts["served per-block step"] = counts
        print(f"served per-block step launches {counts}")
        pangu.forward(tree, u0, s0, consts_dev, perf, device=dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        t_run = time.perf_counter()
        merged_bf16 = pangu.forward(tree, u0, s0, consts_dev, perf,
                                    device=dev)
        torch.cuda.synchronize()
        merged_ms = (time.perf_counter() - t_run) * 1e3
        print(f"merged (lora_fused=True) step launches {ops.launches()}")
        print(f"served per-block step (bf16, batch 1, partial adapters): "
              f"{step_ms:.1f} ms, peak {peak / 2**30:.2f} GiB ({held / 2**30:.2f}"
              f" held before); the merged window-major step {merged_ms:.1f} ms "
              f"(each after one warm-up call)")
        want = pangu.forward(tree, u0, s0, consts_dev, cfg_pb, device=dev,
                             kernels=False)
        checks = [("bf16 vs kernels=False", got, want, torch.bfloat16)]
        tree32 = to_dtype(tree, torch.float32)
        cfg32 = dataclasses.replace(PANGU_24, gelu="erf", lora_fused=False)
        got32 = pangu.forward(tree32, u0, s0, consts_dev, cfg32, device=dev)
        checks += [
            ("float32 vs merged", got32, pangu.forward(
                tree32, u0, s0, consts_dev,
                dataclasses.replace(cfg32, lora_fused=True), device=dev),
             torch.float32),
            ("float32 vs kernels=False", got32, pangu.forward(
                tree32, u0, s0, consts_dev, cfg32, device=dev, kernels=False),
             torch.float32)]
        for label, a_, b_, dt in checks:
            for part, x, y in zip(("upper", "surface"), a_, b_):
                err, rel = rel_err(x, y)
                print(f"served per-block {label} {part}: max_abs_err "
                      f"{err:.3e} rel {rel:.3e} (tol {TOL_FORWARD[dt]:.1e})")
                if rel > TOL_FORWARD[dt]:
                    raise AssertionError(f"served per-block {label} {part}: "
                                         f"rel err {rel:.3e}")
        del got, want, got32, tree32, merged_bf16, checks
    out.update(served_ms_per_step=step_ms, served_peak_bytes=peak,
               merged_ms_per_step=merged_ms)
    torch.cuda.empty_cache()

    # ---- 8c. the per-block train step ---------------------------------------
    tcfg = TrainConfig()
    per_block = dataclasses.replace(PANGU_24, train_fused=False)
    float32_train_steps(
        params, (u0, s0), tgt, consts_dev,
        [("fused", PANGU_24, True), ("per-block pallas", per_block, True),
         ("per-block xla", dataclasses.replace(per_block, grid_bwd="xla"),
          True)],
        [("per-block pallas", "fused"), ("per-block xla", "per-block pallas")],
        "")
    n = sum(perf.depths)
    for grid_bwd, bwd_counts in (("pallas", {"grid_attention_bwd": n}),
                                 ("xla", {"sdpa": n, "sdpa_bwd": n})):
        cfg = dataclasses.replace(perf, train_fused=False, remat=True,
                                  grid_bwd=grid_bwd)
        # forward and the remat recompute each run the grid attention
        step_counts = {"grid_attention": 2 * n, "down_sample": 1,
                       "up_sample": 1, **bwd_counts}
        ms, peak_, losses = adam_steps(cfg, params, batch, consts_dev,
                                       step_counts, path_counts,
                                       f"per-block {grid_bwd} ")
        out[f"train_{grid_bwd}_ms_per_step"] = ms
        out[f"train_{grid_bwd}_peak_bytes"] = peak_
        out[f"train_{grid_bwd}_losses"] = losses

    # ---- 8d. a v2 train step with the "xla" grid attention backward ---------
    v2x = dataclasses.replace(perf, block_layout="v2", grid_bwd="xla")
    p2 = to_dtype(to_dtype(params, torch.float32), torch.bfloat16)
    for t in leaves(p2):
        t.requires_grad_(True)
    ops.reset_launches()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    loss, _, grads = loss_and_grads(p2, batch, consts_dev, v2x, tcfg,
                                    device=dev, seed=SEED + 12)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_run) * 1e3
    counts = ops.launches()
    path_counts["v2 xla train step"] = counts
    want = {"block_v2": n, "grid_attention": n, "sdpa": n, "sdpa_bwd": n,
            "down_sample": 1, "up_sample": 1}
    finite = all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    print(f"v2 train step, grid_bwd='xla' (bf16): loss {float(loss):.6f}, "
          f"{ms:.1f} ms, launches {counts}, gradients finite {finite}")
    if counts != {**{k: 0 for k in counts}, **want} or not finite:
        raise AssertionError(f"v2 xla train step: counts {counts}, finite "
                             f"{finite}")
    out["v2_xla_train_ms"] = ms
    del p2, grads, loss
    torch.cuda.empty_cache()

    # ---- 8e. LoRA fine-tuning as cli/lora_tune.py sets it up ----------------
    for mode, rate in (("element", 0.1), ("feature", 0.1), ("element", 0.0)):
        label = f"LoRA {mode} dropout {rate}"
        ltcfg = dataclasses.replace(tcfg, lora_dropout=rate,
                                    lora_dropout_mode=mode)
        base = to_dtype(to_dtype(params, torch.float32), torch.bfloat16)
        ltree, opt = attach_lora(torch.Generator(device=dev).manual_seed(
            SEED + 60), base, ltcfg)
        before = to_dtype(ltree, torch.float32)
        st = create_train_state(ltree, opt)
        step = make_train_step(perf, ltcfg, consts_dev, opt, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, counts = [], None
        t_run = time.perf_counter()
        for i in range(2):
            ops.reset_launches()
            st, metrics = step(st, batch, SEED + 70 + i)
            counts = ops.launches()
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_run) * 1e3 / 2
        peak_ = torch.cuda.max_memory_allocated()
        report = lora.audit(before, st.params)
        wrong = [k for k in report["updated"]
                 if not (k.endswith(("lora_a", "lora_b"))
                         or k.startswith("patch_recovery"))]
        n_b = sum(k.endswith("lora_b") for k in report["updated"])
        path_counts[label] = counts
        print(f"{label}: {ms:.1f} ms per step (2 steps, bf16, batch 1), peak "
              f"{peak_ / 2**30:.2f} GiB, losses {losses}, launches per step "
              f"{ {k: v for k, v in counts.items() if v} }; audit: "
              f"{len(report['updated'])} updated ({n_b} lora_b), "
              f"{len(report['frozen'])} frozen, updated outside LoRA and "
              f"patch_recovery: {wrong}")
        if wrong or not n_b or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: audit {wrong}, losses {losses}")
        out[f"lora_{mode}_{rate}_ms_per_step"] = ms
        out[f"lora_{mode}_{rate}_peak_bytes"] = peak_
        del st, step, ltree, before, base, opt
        torch.cuda.empty_cache()
    return out


def canon_phase(params, perf, consts_dev, state, storage, ids_of, block_cost,
                weight_bytes, records, path_counts):
    """Phase 9: the last three kernel sites and ``attn_impl``: the fused
    window attention (B13) forward and its drop-in's every gradient, the
    block backward with canonical ends (B7-canon) and the grouped block with
    branch scales (B6g) against their plain versions; the drop-in on the
    embedded state; the canonical training route (adapters at Down/UpSample
    only): the float32 gate against the wm trunk, 3 bf16 Adam steps;
    ``attn_impl="xla"`` served against "pallas" and trained, no kernel
    launched.  Returns the numbers of its JSON line."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import PANGU_24, TrainConfig, _pick_gh
    from pangu_tpu_torch.data.constants import norm_data
    from pangu_tpu_torch.engine.train import loss_and_grads
    from pangu_tpu_torch.models import layers as L
    from pangu_tpu_torch.models import lora, pangu
    from pangu_tpu_torch.ops.earth_block_bwd import (block_bwd_canon,
                                                     block_bwd_plain)
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm_group,
                                                    block_wm_plain)
    from pangu_tpu_torch.ops.window_attention import (window_attention_fused,
                                                      window_attention_pallas,
                                                      window_attention_plain)

    dev = torch.device("cuda")
    F = torch.nn.functional
    half = (1, 3, 6)
    g0, g1 = PANGU_24.stage(0), PANGU_24.stage(1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    u0, s0 = state(SEED + 2)
    u1, s1 = state(SEED + 3)                    # the training targets
    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    tgt = norm_data(u1, s1, consts_dev)
    out = {}

    def grid(geom, dtype):
        return torch.randn((1, geom.z, geom.h_padded, geom.w, geom.dim),
                           generator=gen, device=dev).to(dtype)

    def folded(table, ids):
        bias = table.float()
        if ids is not None:
            bias = bias + torch.where(ids[:, None, :] != ids[:, :, None],
                                      -100.0, 0.0)[:, None]
        return bias.contiguous()

    def attn_tree(leaves):
        return {"qkv": {"kernel": leaves[0], "bias": leaves[1]},
                "proj": {"kernel": leaves[2], "bias": leaves[3]},
                "bias_table": leaves[4]}

    def attn_grads(at, x, ids, dy, heads, kernels):
        leaves = [t.detach().requires_grad_(True) for t in (
            x, at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
            at["proj"]["bias"], at["bias_table"])]
        y = window_attention_pallas(attn_tree(leaves[1:]), leaves[0], heads,
                                    ids, kernels=kernels)
        return list(torch.autograd.grad(y, leaves, dy))

    # ---- 9a. the three kernel sites against their plain versions -----------
    for dtype in (torch.float32, torch.bfloat16):
        tanh = dtype == torch.bfloat16
        pdt = to_dtype({"s0": params["stages"][0]["blocks"][1],
                        "s1": params["stages"][1]["blocks"][1]}, dtype)
        cases = []  # (name, label, flops, bytes, kernel, plain, timing reps)
        for st, geom, bp in (("stage 0", g0, pdt["s0"]),
                             ("stage 1", g1, pdt["s1"])):
            c, n, at = geom.dim, geom.window_tokens, bp["attn"]
            x = L.window_partition(grid(geom, dtype), geom.window).contiguous()
            rows = x.numel() // c
            w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
                 at["proj"]["bias"])
            for ids in (ids_of(geom), None):
                bias = folded(at["bias_table"], ids)
                m = "region ids" if ids is not None else "no ids"
                cases.append((   # qkv, attention, proj; x, bias in, out
                    "window_attention_pallas",
                    f"{st} windows {tuple(x.shape)}, {m}",
                    2 * rows * c * (4 * c + 2 * n),
                    2 * nbytes(x) + nbytes(bias) + weight_bytes(at, dtype),
                    lambda x=x, w=w, b=bias: window_attention_fused(x, *w, b),
                    lambda x=x, w=w, b=bias: window_attention_plain(x, *w, b),
                    (3, 2)))
            if geom is g0:
                ids = ids_of(geom)
                dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
                nw = sum(t.numel() for t in w)
                cases.append((   # the kernel forward, the composition's
                    # recompute (qkv, sdpa, proj) and its gradients
                    "window_attention_pallas backward",
                    f"{st}, region ids, every gradient",
                    rows * (32 * c * c + 18 * n * c),
                    3 * nbytes(x) + 2 * nbytes(folded(at["bias_table"], ids))
                    + weight_bytes(at, dtype) + 4 * nw,
                    lambda at=at, x=x, i=ids, d=dy, h=geom.heads:
                        attn_grads(at, x, i, d, h, True),
                    lambda at=at, x=x, i=ids, d=dy, h=geom.heads:
                        attn_grads(at, x, i, d, h, False), (2, 1)))
            # the block backward with a canonical end, scales (0.8, 1.25)
            drop = torch.tensor([[0.8, 1.25]], device=dev)
            xs, xg = storage(geom, dtype), grid(geom, dtype)
            gs, gg = storage(geom, dtype), grid(geom, dtype)
            ids = ids_of(geom)
            flops, byts = block_cost(bp, xs, ids)
            nw = sum(t.numel() for t in leaves(bp) if t.dim() < 4)
            bbytes = (3 * nbytes(xs) + nbytes(bp["attn"]["bias_table"])
                      + bp["attn"]["bias_table"].numel() * 4 + nbytes(ids)
                      + weight_bytes(bp, dtype) + 4 * nw)
            for label, xa, ga, args, xl, gl, dr in (
                    (f"{st} canon x, first block", xg, gs,
                     ((0, 0, 0), (-1, -3, -6), 0, None), "canon", "wm", drop),
                    (f"{st} canon g, last block shifted", xs, gg,
                     (half, (0, 0, 0), 3, ids), "wm", "canon", drop),
                    (f"{st} canon x, first block", xg, gs,
                     ((0, 0, 0), (-1, -3, -6), 0, None), "canon", "wm",
                     None)):
                scales = "scales (0.8, 1.25)" if dr is not None else "no scales"
                cases.append((
                    "block_bwd_canon", f"{label}, {scales}",
                    3 * flops, bbytes,
                    lambda bp=bp, x=xa, g=ga, geom=geom, a=args, d=dr,
                    t=tanh, xl=xl, gl=gl:
                        block_bwd_canon(bp, x, g, geom, *a, d, t,
                                        x_layout=xl, g_layout=gl),
                    lambda bp=bp, x=xa, g=ga, geom=geom, a=args, d=dr,
                    t=tanh, xl=xl, gl=gl:
                        block_bwd_plain(bp, x, g, geom, *a, d, t, xl, gl),
                    (2, 1)))
            if geom is g1:   # the grouped block with branch scales
                gh = _pick_gh(g1.h_padded // g1.window[1], perf.lat_group)
                drop = torch.tensor([[1.25, 0.0]], device=dev)
                cases.append((
                    "block_wm_group", f"stage 1 shifted, gh {gh}, scales "
                    "(1.25, 0)", flops, block_cost(bp, xs, ids)[1],
                    lambda bp=bp, xs=xs, i=ids, t=tanh, gh=gh, d=drop:
                        block_wm_group(bp, xs, g1, half, 3, i, t, gh, d),
                    lambda bp=bp, xs=xs, i=ids, t=tanh, d=drop:
                        block_wm_plain(bp, xs, g1, half, 3, i, t, d),
                    (3, 2)))
        check_kernels(cases, dtype, records)
        del cases
        torch.cuda.empty_cache()

    # the bf16 fused window attention at stage 0 with region ids: each
    # sample of a batch of 2 bit-equal to it run alone, one launch by class
    # (inputs from a generator of their own, so that gen's draws stay)
    g2w = torch.Generator(device=dev).manual_seed(SEED + 81)
    at = to_dtype(params["stages"][0]["blocks"][1]["attn"], torch.bfloat16)
    w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
         at["proj"]["bias"])
    bias = folded(at["bias_table"], ids_of(g0))
    x2 = L.window_partition(torch.randn(
        (2, g0.z, g0.h_padded, g0.w, g0.dim), generator=g2w,
        device=dev).to(torch.bfloat16), g0.window).contiguous()
    got = window_attention_fused(x2, *w, bias)
    for b in range(2):
        alone = window_attention_fused(x2[b:b + 1].contiguous(), *w, bias)
        torch.cuda.synchronize()
        same = bool(torch.equal(got[b:b + 1], alone))
        print(f"batch 2, sample {b} vs batch 1: window_attention_pallas "
              f"stage 0, region ids bf16 bit-equal {same}")
        if not same:
            raise AssertionError(f"window_attention_pallas batch 2: sample "
                                 f"{b} differs from a batch-1 launch")
    x1 = x2[:1].contiguous()
    print("window_attention_pallas stage 0, region ids bf16 by class "
          "(torch.profiler): " + class_breakdown(
              lambda: window_attention_fused(x1, *w, bias),
              window_work(x1.numel() // g0.dim, g0.dim, g0.window_tokens)))
    del x2, x1, got, alone, bias
    torch.cuda.empty_cache()

    # ---- 9b. the drop-in on the embedded state: a path of its own ----------
    at = params["stages"][0]["blocks"][0]["attn"]
    xe = L.patch_embed(params["patch_embed"], u0.to(torch.bfloat16),
                       s0.to(torch.bfloat16), consts_dev, perf)
    win = L.window_partition(F.pad(xe, (0, 0, 0, 0, 0, g0.h_padded - g0.h)),
                             g0.window).contiguous()
    dy = torch.randn(win.shape, generator=gen, device=dev).to(torch.bfloat16)
    attn_grads(at, win, None, dy, g0.heads, True)      # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t_run = time.perf_counter()
    got = attn_grads(at, win, None, dy, g0.heads, True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_run) * 1e3
    counts = ops.launches()
    want_counts = {"window_attention_pallas": 1, "sdpa": 1, "sdpa_bwd": 1}
    path_counts["drop-in window attention, embedded state"] = counts
    want = attn_grads(at, win, None, dy, g0.heads, False)
    errs = [rel_err(a, b)[1] for a, b in zip(got, want)]
    print(f"drop-in window attention (stage-0 windows of the embedded state, "
          f"bf16, forward and every gradient): {ms:.1f} ms, launches "
          f"{ {k: v for k, v in counts.items() if v} }, gradients against "
          f"kernels=False: worst rel {max(errs):.3e} (tol "
          f"{TOL[torch.bfloat16]:.1e})")
    if (counts != {**{k: 0 for k in counts}, **want_counts}
            or max(errs) > TOL[torch.bfloat16]):
        raise AssertionError(f"drop-in window attention: counts {counts}, "
                             f"errors {errs}")
    out["drop_in_window_attention_ms"] = ms
    del got, want, win, xe, dy
    torch.cuda.empty_cache()

    # ---- 9c. the canonical training route ----------------------------------
    # adapters only at reduce / expand / mix, unmerged: wm_core_supported is
    # false and every stage trains through run_stage_train_wm(io canon)
    tree = lora.init_lora(gen, params, rank=16, alpha=16.0)
    tree["stages"] = lora.strip_lora({"s": tree["stages"]})["s"]
    canon_cfg = dataclasses.replace(PANGU_24, lora_fused=False)
    if pangu.wm_core_supported(tree, canon_cfg):
        raise AssertionError("the adapter tree took the window-major trunk")
    float32_train_steps(
        params, (u0, s0), tgt, consts_dev,
        [("canonical route", canon_cfg, True, tree),
         ("wm trunk", PANGU_24, True)], [("canonical route", "wm trunk")],
        "")
    nb = sum(perf.depths)
    ends = 6          # the first and last block of stages 0, 1 + 2 and 3
    step_counts = {"block_wm": nb - ends, "block_wm_canon": ends,
                   "block_bwd": nb - ends, "block_bwd_canon": ends}
    ms, peak, losses = adam_steps(
        dataclasses.replace(perf, lora_fused=False), tree, batch, consts_dev,
        step_counts, path_counts, "canonical route ")
    print(f"canonical route: {ends} of {nb} block backwards per step read or "
          f"write the canonical grid (block_bwd_canon); no relayout of the "
          f"trunk's ends")
    out.update(canon_train_ms_per_step=ms, canon_train_peak_bytes=peak,
               canon_train_losses=losses)
    del tree
    torch.cuda.empty_cache()

    # ---- 9d. attn_impl="xla" -----------------------------------------------
    params32 = to_dtype(params, torch.float32)
    cfg32 = dataclasses.replace(PANGU_24, gelu="erf")
    with torch.no_grad():
        for label, cfg, p, dt in (("bf16", perf, params, torch.bfloat16),
                                  ("float32", cfg32, params32,
                                   torch.float32)):
            xla = dataclasses.replace(cfg, attn_impl="xla")
            pangu.forward(p, u0, s0, consts_dev, xla, device=dev)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t_run = time.perf_counter()
            got = pangu.forward(p, u0, s0, consts_dev, xla, device=dev)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t_run) * 1e3
            peak = torch.cuda.max_memory_allocated()
            counts = ops.launches()
            path_counts[f"attn_impl xla served step, {label}"] = counts
            want = pangu.forward(p, u0, s0, consts_dev, cfg, device=dev)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            print(f'attn_impl="xla" served step ({label}, batch 1): {ms:.1f} '
                  f"ms, peak {peak / 2**30:.2f} GiB ({held / 2**30:.2f} held "
                  f"before), kernel launches {sum(counts.values())}; against "
                  f'"pallas": upper rel {errs[0][1]:.3e}, surface rel '
                  f"{errs[1][1]:.3e} (tol {TOL_FORWARD[dt]:.1e})")
            if any(counts.values()) or max(e[1] for e in errs) > TOL_FORWARD[dt]:
                raise AssertionError(f"attn_impl xla served {label}: counts "
                                     f"{counts}, errors {errs}")
            out[f"xla_served_{label}_ms"] = ms
            del got, want
    del params32
    torch.cuda.empty_cache()
    xla = dataclasses.replace(perf, attn_impl="xla")
    p2 = to_dtype(to_dtype(params, torch.float32), torch.bfloat16)
    for t in leaves(p2):
        t.requires_grad_(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_run = time.perf_counter()
    loss, _, grads = loss_and_grads(p2, batch, consts_dev, xla, TrainConfig(),
                                    device=dev, seed=SEED + 13)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_run) * 1e3
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launches()
    path_counts["attn_impl xla train step"] = counts
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(g).all()) for g in leaves(grads))
    print(f'attn_impl="xla" train step (bf16, batch 1, remat): loss '
          f"{float(loss):.6f}, {ms:.1f} ms, peak {peak / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} held before), kernel launches "
          f"{sum(counts.values())}, gradients finite {finite}")
    if any(counts.values()) or not finite:
        raise AssertionError(f"attn_impl xla train step: counts {counts}, "
                             f"finite {finite}")
    out.update(xla_train_ms=ms, xla_train_peak_bytes=peak)
    del p2, grads, loss
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 10. the command lines
# ---------------------------------------------------------------------------

# the test windows of phase 10: two samples each, at 48 h and at 24 h
CLI_WINDOW_48 = ("data.test_start=20180103", "data.test_end=20180106",
                 "data.test_freq=24h")
CLI_WINDOW_24 = ("data.test_start=20180103", "data.test_end=20180105",
                 "data.test_freq=24h")
CLI_SAMPLES, CLI_HORIZON = 2, 48
F32_SCORE_TOL, BF16_SCORE_TOL, NUMPY_SCORE_TOL = 1e-3, 2.0 ** -4, 1e-5


def read_scores(csv_dir):
    """{table: (header, {row key: float64 values})} of a run's 12 CSVs."""
    import csv
    out = {}
    for name in sorted(os.listdir(csv_dir)):
        with open(os.path.join(csv_dir, name), newline="") as f:
            rows = list(csv.reader(f))
        out[name[:-4]] = (rows[0], {r[0]: [float(v) for v in r[1:]]
                                    for r in rows[1:]})
    return out


def check_scores(tables, keys, levels):
    """12 tables, each with a row per target time, 13 level columns or 4
    surface ones, every value finite, every ACC in [-1, 1]."""
    if len(tables) != 12:
        raise AssertionError(f"{len(tables)} CSVs, not 12")
    for name, (header, rows) in tables.items():
        width = 4 if name.endswith("surface") else levels
        if len(header) != width + 1 or list(rows) != keys:
            raise AssertionError(f"{name}: header {header}, rows {list(rows)}"
                                 f", want {width} columns and rows {keys}")
        for key, vals in rows.items():
            if len(vals) != width or not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"{name} {key}: {vals}")
            if name.startswith("acc") and not all(-1 <= v <= 1 for v in vals):
                raise AssertionError(f"{name} {key}: ACC outside [-1, 1]")


def cli_timing(log_path):
    """The last ``timing {json}`` line a command line logged."""
    with open(log_path) as f:
        lines = [ln for ln in f if " : timing " in ln]
    return json.loads(lines[-1].split(" : timing ", 1)[1])


def score_gap(got, want, rmse_tol, acc_tol):
    """max relative RMSE and absolute ACC differences over every table;
    raises past the tolerances."""
    rmse = max(float(((got[n] - want[n]).abs() / want[n].abs()).max())
               for n in want if n.startswith("rmse"))
    acc = max(float((got[n] - want[n]).abs().max())
              for n in want if n.startswith("acc"))
    if not (rmse <= rmse_tol and acc <= acc_tol):
        raise AssertionError(f"scores: rmse rel {rmse:.3e} (tol {rmse_tol:.1e})"
                             f", acc abs {acc:.3e} (tol {acc_tol:.1e})")
    return rmse, acc


def numpy_scores(pu, ps, tu, ts, consts):
    """The RMSE / ACC formula in float64 numpy on the same fields: the
    reference's weights (3.1416, float32 latitudes) widened to float64."""
    import numpy as np

    def weights(n):
        lat = 90.0 - np.arange(n, dtype=np.float32) * 180.0 / (n - 1)
        cos = np.cos(np.float64(3.1416 / 180.0) * lat.astype(np.float64))
        return (n * cos / cos.sum())[:, None]

    host = lambda t: t.double().cpu().numpy()[0]     # noqa: E731
    pu, ps, tu, ts = (host(t) for t in (pu, ps, tu, ts))
    um = consts["upper_mean"].double().cpu().numpy()
    sm = consts["surface_mean"].double().cpu().numpy()
    w = weights(pu.shape[-2])

    def rmse(p, t):
        return np.sqrt((w * (p - t) ** 2).mean(axis=(-1, -2)))

    def acc(p, t):
        return ((w * p * t).sum(axis=(-1, -2))
                / np.sqrt((w * p * p).sum(axis=(-1, -2))
                          * (w * t * t).sum(axis=(-1, -2))))

    out = {}
    for i, v in enumerate("zqtuv"):
        out[f"rmse_upper_{v}"] = rmse(pu[i], tu[i])
        out[f"acc_upper_{v}"] = acc(pu[i] - um[i], tu[i] - um[i])
    out["rmse_surface"] = rmse(ps, ts)
    out["acc_surface"] = acc(ps - sm, ts - sm)
    return out


def cli_phase(smi, trunk_counts, path_counts, tmp, kept):
    """Phase 10: the command lines, Pangu-24 at full width: the reference
    checkpoint's conversion, full-step and token-space inference, the
    evaluation sweep twice, the score step with kernels against plain
    versions and the score functions against float64 numpy.  Returns the
    numbers of its JSON line; leaves the weights file in ``tmp`` and puts
    its path and the token-space run's scores in ``kept`` (phase 11)."""
    import argparse
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.cli import common
    from pangu_tpu_torch.cli import convert_weights as cli_convert
    from pangu_tpu_torch.cli import evaluate as cli_evaluate
    from pangu_tpu_torch.cli import inference as cli_inference
    from pangu_tpu_torch.config import PANGU_24, Config, load_config
    from pangu_tpu_torch.data import era5, fastpack
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine.evaluate import make_score_step
    from pangu_tpu_torch.models import convert, pangu
    from pangu_tpu_torch.utils.checkpoint import load_params

    dev = torch.device("cuda")
    out = {"fastpack": fastpack.route()}
    print(f"fastpack route: {out['fastpack']}")
    print("card:", smi)
    # a. the reference checkpoint -> the port's params file
    t0 = time.perf_counter()
    params32 = pangu.init_params(torch.Generator().manual_seed(SEED),
                                 PANGU_24, device="cpu")
    n = pangu.param_count(params32)
    size = sum(t.numel() * t.element_size() for t in leaves(params32))
    if n != 276_659_936:
        raise AssertionError(f"Pangu-24 has {n:,} parameters")
    pth, pfile = (os.path.join(tmp, name)
                  for name in ("pangu_weather_24_torch.pth", "pangu24.pt"))
    torch.save({"model": convert.export_torch_state_dict(params32,
                                                         PANGU_24)}, pth)
    t1 = time.perf_counter()
    if cli_convert.main(["--input", pth, "--output", pfile,
                         "--dtype", "bfloat16"]) != 0:
        raise AssertionError("convert_weights failed")
    t2 = time.perf_counter()
    os.unlink(pth)
    loaded = load_params(pfile, device=dev)
    for a, b in zip(leaves(loaded), leaves(params32), strict=True):
        if a.dtype != torch.bfloat16 or not torch.equal(
                a.view(torch.int16), b.to(dev, torch.bfloat16)
                .view(torch.int16)):
            raise AssertionError("a converted leaf is not the bf16 cast "
                                 "of the original")
    print(f"weights: {n:,} parameters ({size / 2**30:.2f} GiB float32), "
          f"export + torch.save {t1 - t0:.2f} s, convert_weights "
          f"{t2 - t1:.2f} s, every leaf the bf16 cast bit for bit")
    out["convert_s"] = t2 - t1
    del loaded

    common_args = ["--bf16", "--pallas", "--set", "model.gelu=tanh",
                   "--synthetic", "--pretrained", pfile,
                   "--set", f"output_path={tmp}"]
    window48 = [a for item in CLI_WINDOW_48 for a in ("--set", item)]
    window24 = [a for item in CLI_WINDOW_24 for a in ("--set", item)]
    keys48 = ["2018010500", "2018010600"]
    keys24 = ["2018010400", "2018010500"]
    per_sample = CLI_SAMPLES * CLI_HORIZON // 24
    runs = {
        # b. full-step inference: per step the trunk only
        "inference": (cli_inference, ["--horizon", str(CLI_HORIZON),
                                      "--limit", str(CLI_SAMPLES),
                                      *window48],
                      {k: per_sample * v for k, v in trunk_counts.items()},
                      keys48, CLI_HORIZON),
        # c. token space with the edge kernels (the JAX CLI's --pallas):
        # per sample one embed, one transition, one recovery
        "inference_token_space": (
            cli_inference, ["--horizon", str(CLI_HORIZON), "--limit",
                            str(CLI_SAMPLES), "--token-space", "--set",
                            "model.edge_kernels=true", *window48],
            {**{k: per_sample * v for k, v in trunk_counts.items()},
             "embed_wm": CLI_SAMPLES, "transition_wm": CLI_SAMPLES,
             "recovery_wm_upper": CLI_SAMPLES,
             "recovery_wm_surface": CLI_SAMPLES},
            keys48, CLI_HORIZON),
        # d. the evaluation sweep, twice
        **{name: (cli_evaluate, ["--limit", str(CLI_SAMPLES), "--no-viz",
                                 *window24],
                  {k: CLI_SAMPLES * v for k, v in trunk_counts.items()},
                  keys24, 24)
           for name in ("evaluate", "evaluate_again")},
    }
    csvs = {}
    for name, (cli, argv, want, keys, horizon) in runs.items():
        ops.reset_launches()
        t_run = time.perf_counter()
        if cli.main(common_args + ["--type_net", name] + argv) != 0:
            raise AssertionError(f"{name} failed")
        wall = time.perf_counter() - t_run
        counts = ops.launches()
        path_counts[f"cli {name}"] = counts
        want = {**{k: 0 for k in counts}, **want}
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} != {want}")
        run_dir = os.path.join(tmp, name, str(horizon))
        scores = read_scores(os.path.join(run_dir, "csv"))
        check_scores(scores, keys, PANGU_24.levels)
        kept[name] = scores
        csvs[name] = {f: open(os.path.join(run_dir, "csv", f), "rb").read()
                      for f in sorted(os.listdir(os.path.join(run_dir,
                                                              "csv")))}
        tm = cli_timing(os.path.join(run_dir, f"{name}.log"))
        print(f"cli {name}: {tm['samples']} samples, wall "
              f"{tm['wall_s_per_sample']:.3f} s per sample (host loading "
              f"{tm['load_s_per_sample']:.3f}, device "
              f"{tm['device_s_per_sample']:.3f}), the whole command "
              f"{wall:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        out[name] = {**tm, "command_s": wall}
    if csvs["evaluate"] != csvs["evaluate_again"]:
        raise AssertionError("two evaluate runs wrote different CSVs")
    print("evaluate twice: the 12 CSVs byte-identical")

    # d. the score step, kernels against plain versions, first batch
    batch = era5.make_dataset(load_config(None, CLI_WINDOW_24).data,
                              "test", PANGU_24,
                              synthetic=True)[0].as_batch()
    fields = [torch.from_numpy(batch[k]).to(dev) for k in
              ("upper", "surface", "target_upper", "target_surface")]
    consts = synthetic_constants(PANGU_24, seed=SEED)
    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    params16 = common.load_params(
        argparse.Namespace(device="cuda", pretrained=pfile),
        Config(model=perf))
    params32 = to_dtype(params32, dev)        # Tensor.to: a device too
    for label, cfg, p, tol in (
            ("float32", PANGU_24, params32, F32_SCORE_TOL),
            ("bf16", perf, params16, BF16_SCORE_TOL)):
        got, (pu, ps) = make_score_step(cfg, consts, device=dev)(p, *fields)
        want, _ = make_score_step(cfg, consts, device=dev,
                                  kernels=False)(p, *fields)
        rmse, acc = score_gap(got, want, tol, tol)
        print(f"score step {label}, kernels vs plain: rmse rel "
              f"{rmse:.3e}, acc abs {acc:.3e} (tol {tol:.1e})")
        out[f"score_step_{label}"] = {"rmse_rel": rmse, "acc_abs": acc}
    # the score functions on the card against float64 numpy on the
    # same (bf16 step's) outputs
    ref = numpy_scores(pu, ps, fields[2], fields[3],
                       to_device(consts, dev))
    rmse = max(float(abs(got[n].double().cpu().numpy()[0] - ref[n]).max()
                     / abs(ref[n]).min()) for n in ref if "rmse" in n)
    acc = max(float(abs(got[n].double().cpu().numpy()[0] - ref[n]).max())
              for n in ref if "acc" in n)
    print(f"score functions vs float64 numpy: rmse rel {rmse:.3e}, acc "
          f"abs {acc:.3e} (tol {NUMPY_SCORE_TOL:.0e}; ACC's range is 1)")
    if not (rmse <= NUMPY_SCORE_TOL and acc <= NUMPY_SCORE_TOL):
        raise AssertionError("score functions differ from float64 numpy")
    out["scores_vs_numpy"] = {"rmse_rel": rmse, "acc_abs": acc}
    kept["weights"], kept["window48"] = pfile, window48
    del params32, params16
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# 11. the sharded serving path
# ---------------------------------------------------------------------------

WORLD, WORLD_MESH = 6, (1, 3, 2)       # (dp, sp, tp): both halos
WORLD_TIMEOUT_S = 480
WORLD_STEPS = 2
WORLD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -4}
# per rank, one trunk of the sharded forward
WORLD_TRUNK = {"block_wm": 4, "block_wm_group": 12, "down_sample_wm": 1,
               "up_sample_wm": 1}


def world_runs():
    """(label, config, dtype) of phase 11's float32 and bf16 runs."""
    from pangu_tpu_torch.config import PANGU_24
    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    return (("float32", PANGU_24, torch.float32),
            ("bf16", perf, torch.bfloat16))


def digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def sharded_rank(path, cli_argv):
    """One rank of phase 11's world: the sharded ``forward`` and 2-step
    token-space rollout, float32 and bf16, with the rank's launch counts,
    halo exchanges and wall seconds per step; then ``cli.inference`` in the
    same world.  Rank 0 also returns the outputs."""
    import torch.distributed as dist
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.cli import inference as cli_inference
    from pangu_tpu_torch.config import MeshConfig
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine.rollout import make_rollout
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.parallel import mesh as M
    from pangu_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.build_mesh(MeshConfig(*WORLD_MESH))
    dev = mesh.device
    blob = torch.load(path, mmap=True, weights_only=False)
    cfg0 = world_runs()[0][1]
    consts = to_device(synthetic_constants(cfg0, seed=SEED), dev)
    u, s = blob["upper"].to(dev), blob["surface"].to(dev)
    rank = M.world()[0]
    out = {"rank": rank, "coords": mesh.coords, "backend": dist.get_backend(),
           "host_staged": mesh.host_staged, "device": str(dev), "runs": {}}
    params32 = to_dtype(blob["params"], dev)
    for label, cfg, dtype in world_runs():
        params = to_dtype(params32, dtype)
        for run, steps, fn in (
                ("forward", 1, lambda: pangu.forward(params, u, s, consts,
                                                     cfg)),
                ("rollout", WORLD_STEPS, lambda: make_rollout(
                    cfg, consts, WORLD_STEPS, token_space=True)(params, u, s))):
            ops.reset_launches()
            mesh.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with sharding.use_mesh(mesh):
                res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = {"counts": ops.launches(), "exchanges": mesh.exchanges,
                   "bytes": mesh.exchange_bytes, "s_per_step": wall / steps,
                   "steps": steps, "digest": digest(res)}
            if rank == 0:
                rec["result"] = [t.cpu() for t in res]
            out["runs"][f"{run} {label}"] = rec
            del res
        del params
    del params32
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    if cli_inference.main(cli_argv) != 0:
        raise AssertionError(f"rank {rank}: cli.inference failed")
    out["cli"] = {"counts": ops.launches(), "s": time.perf_counter() - t0}
    return out


def row_5z(params32, consts_dev, records):
    """Phase 11a: the transition on tp z shards (row 5z) against its plain
    version and, put together, against row 5's kernel on the whole pair;
    the launches that must raise."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.engine.transition_wm import (
        apply_transition_wm, apply_transition_wm_plain, build_transition_wm)
    dev = torch.device("cuda")
    g0 = PANGU_24.stage(0)
    wz, wh, ww = g0.window
    nz, nlat, nlon = g0.z // wz, g0.h_padded // wh, g0.w // ww
    c = g0.dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for label, cfg, dtype in world_runs():
        isz = torch.tensor([], dtype=dtype).element_size()
        edge = to_dtype(to_dtype({k: params32[k] for k in (
            "patch_embed", "patch_recovery")}, dev), dtype)
        tp = build_transition_wm(edge, consts_dev, cfg)
        shape = (1, nz, nlat, nlon, wz * wh * ww, c)
        skip, dec = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
        for off in ((0, 3, 6), (0, 0, 0)):
            whole = apply_transition_wm(tp, skip, dec, g0, off)
            cuts = ((2, 1), (4, 1)) + (((2, 3),) if off[2] == 0 else ())
            for tpn, spn in cuts:
                nzl, nll = nz // tpn, nlon // spn
                planes = []
                for zi in range(tpn):
                    row = []
                    for li in range(spn):
                        def cut(t, zi=zi, li=li):
                            return t[:, zi * nzl:(zi + 1) * nzl, :,
                                     li * nll:(li + 1) * nll].contiguous()
                        tpl = {**tp, "bias_field_wm": cut(tp["bias_field_wm"])}
                        a, b = cut(skip), cut(dec)
                        kw = dict(z_base=zi * nzl, nz_global=nz)

                        def kern(tpl=tpl, a=a, b=b, kw=kw):
                            return apply_transition_wm(tpl, a, b, g0, off, **kw)

                        def plain(tpl=tpl, a=a, b=b, kw=kw):
                            return apply_transition_wm_plain(tpl, a, b, g0,
                                                             off, **kw)
                        got = kern()
                        err, rel = rel_err(got, plain())
                        if rel > TOL[dtype]:
                            raise AssertionError(
                                f"5z {label} off {off} tp {tpn} sp {spn} "
                                f"shard ({zi}, {li}): rel err {rel:.3e}")
                        row.append(got)
                        if zi or li:
                            continue
                        valid = nzl * wz * g0.h * nll * ww
                        rows_ = nzl * wz * g0.h_padded * nll * ww
                        ms = time_ms(kern, 20)
                        plain_ms = time_ms(plain, 3)
                        bound_ms, bound_by = bound(
                            2 * valid * 2 * c * c,
                            3 * valid * c * isz + 6 * 2 * c * c * isz
                            + rows_ * c * isz, dtype)
                        key = f"{label} off {off} tp {tpn} sp {spn}"
                        out[key] = {"max_abs_err": err, "rel": rel, "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                                    "bound_by": bound_by,
                                    "shape": list(a.shape)}
                        print(f"transition_wm_z {key:34s} shard {tuple(a.shape)}"
                              f" max_abs_err {err:.3e} rel {rel:.3e} (tol "
                              f"{TOL[dtype]:.1e})  kernel {ms:.3f} ms  plain "
                              f"{plain_ms:.3f} ms  bound {bound_ms:.3f} ms "
                              f"({bound_by})", flush=True)
                        if (dtype == torch.bfloat16 and tpn == 2 and spn == 1
                                and off == (0, 3, 6)):
                            records["transition_wm_z"] = {
                                "max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by,
                                "at": f"{key} shard 0, bf16"}
                    planes.append(torch.cat(row, dim=3))
                joined = torch.cat(planes, dim=1)
                same = torch.equal(joined, whole)
                err, rel = rel_err(joined, whole)
                print(f"  {label} off {off} tp {tpn} sp {spn}: the {tpn * spn} "
                      f"shards put together against row 5 on the whole pair: "
                      f"{'bit-equal' if same else f'rel {rel:.3e}'}",
                      flush=True)
                if not same and rel > TOL[dtype]:
                    raise AssertionError(f"5z shards differ from row 5: {rel}")
                out[f"{label} off {off} tp {tpn} sp {spn}"]["bit_equal"] = same
        for bad, a, what in (
                ((1, 3, 6), skip[:, :nz // 2].contiguous(),
                 "a z offset under tp"),
                ((0, 3, 6), skip[:, :, :, :nlon // 3].contiguous(),
                 "a lon offset on a lon shard")):
            tpl = {**tp, "bias_field_wm": tp["bias_field_wm"][
                :, :a.shape[1], :, :a.shape[3]].contiguous()}
            try:
                apply_transition_wm(tpl, a, a, g0, bad, z_base=0,
                                    nz_global=nz)
            except ValueError as e:
                print(f"  {label} {what}: raises ({e})")
            else:
                raise AssertionError(f"5z with {what} did not raise")
        del tp, skip, dec, whole, joined
    torch.cuda.empty_cache()
    return out


def sharded_phase(smi, records, path_counts, tmp, kept):
    """Phase 11: row 5z alone, then a world of ``WORLD`` ranks on the one
    card serving the sharded forward, rollout and command line, against
    the single-device runs."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.engine.rollout import make_rollout
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    print("card:", smi)
    params32 = pangu.init_params(torch.Generator().manual_seed(SEED),
                                 PANGU_24, device="cpu")
    consts_dev = to_device(synthetic_constants(PANGU_24, seed=SEED), dev)
    out = {"row_5z": row_5z(params32, consts_dev, records)}

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    u = (consts_dev["upper_mean"][None] + consts_dev["upper_std"][None]
         * torch.randn((1, 5, PANGU_24.levels, PANGU_24.lat, PANGU_24.lon),
                       generator=g, device=dev))
    s = (consts_dev["surface_mean"][None] + consts_dev["surface_std"][None]
         * torch.randn((1, 4, PANGU_24.lat, PANGU_24.lon), generator=g,
                       device=dev))
    path = os.path.join(tmp, "world.pt")
    torch.save({"params": params32, "upper": u.cpu(), "surface": s.cpu()},
               path)
    refs = {}
    t0 = time.perf_counter()
    for label, cfg, dtype in world_runs():
        p = to_dtype(to_dtype(params32, dev), dtype)
        refs[f"forward {label}"] = pangu.forward(p, u, s, consts_dev, cfg)
        refs[f"rollout {label}"] = make_rollout(
            cfg, consts_dev, WORLD_STEPS, token_space=True)(p, u, s)
        del p
    torch.cuda.synchronize()
    print(f"single-device references: {time.perf_counter() - t0:.2f} s")
    del params32
    torch.cuda.empty_cache()

    cli_argv = ["--bf16", "--pallas", "--set", "model.gelu=tanh",
                "--synthetic", "--pretrained", kept["weights"], "--set",
                f"output_path={tmp}", "--type_net", "sharded", "--horizon",
                str(CLI_HORIZON), "--limit", "1", "--token-space",
                *kept["window48"]]
    t0 = time.perf_counter()
    ranks = launch.run(sharded_rank, WORLD, path, cli_argv, device="cuda",
                       timeout_s=WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"world of {WORLD} ranks, mesh (dp, sp, tp) {WORLD_MESH}: backend "
          f"{r0['backend']}, halos through host buffers "
          f"{r0['host_staged']}, the whole world {world_s:.1f} s (spawn, "
          f"loads, runs, command line)")
    out["world_s"] = world_s
    for label, cfg, dtype in world_runs():
        for run in ("forward", "rollout"):
            key = f"{run} {label}"
            digests = {r["runs"][key]["digest"] for r in ranks}
            if len(digests) != 1:
                raise AssertionError(f"{key}: the ranks' results differ")
            got, want = r0["runs"][key]["result"], refs[key]
            errs = [rel_err(a.to(dev), b) for a, b in zip(got, want)]
            rel = max(e[1] for e in errs)
            same = all(torch.equal(a.to(dev), b) for a, b in zip(got, want))
            n_trunks = 1 if run == "forward" else WORLD_STEPS
            want_counts = {k: n_trunks * v for k, v in WORLD_TRUNK.items()}
            if run == "rollout":
                want_counts.update(transition_wm=WORLD_STEPS - 1,
                                   transition_wm_z=WORLD_STEPS - 1)
            print(f"sharded {key:16s} vs one device: max_abs_err "
                  f"{max(e[0] for e in errs):.3e} rel {rel:.3e} (tol "
                  f"{WORLD_TOL[dtype]:.0e}) "
                  f"{'bit-equal' if same else 'not bit-equal'}", flush=True)
            if rel > WORLD_TOL[dtype]:
                raise AssertionError(f"sharded {key}: rel err {rel:.3e}")
            for r in ranks:
                rec = r["runs"][key]
                counts = rec["counts"]
                print(f"  rank {r['rank']} {r['coords']}: launches "
                      f"{ {k: v for k, v in counts.items() if v} }, halo "
                      f"exchanges {rec['exchanges'] / rec['steps']:.0f} and "
                      f"{rec['bytes'] / rec['steps'] / 2**20:.1f} MiB per "
                      f"step, wall {rec['s_per_step']:.3f} s per step")
                if counts != {**{k: 0 for k in counts}, **want_counts}:
                    raise AssertionError(f"rank {r['rank']} {key}: launches "
                                         f"{counts}, want {want_counts}")
            path_counts[f"sharded {key}"] = {
                k: sum(r["runs"][key]["counts"][k] for r in ranks)
                for k in r0["runs"][key]["counts"]}
            out[key] = {"rel": rel, "bit_equal": same, "s_per_step": [
                r["runs"][key]["s_per_step"] for r in ranks],
                "exchanges_per_step": r0["runs"][key]["exchanges"] / n_trunks,
                "bytes_per_step": r0["runs"][key]["bytes"] / n_trunks}

    # c. the command line in the same world: rank 0's CSVs
    run_dir = os.path.join(tmp, "sharded", str(CLI_HORIZON))
    scores = read_scores(os.path.join(run_dir, "csv"))
    key = "2018010500"
    check_scores(scores, [key], PANGU_24.levels)
    want = kept["inference_token_space"]
    rmse = max(abs(a - b) / abs(b) for n in scores if n.startswith("rmse")
               for a, b in zip(scores[n][1][key], want[n][1][key]))
    acc = max(abs(a - b) for n in scores if n.startswith("acc")
              for a, b in zip(scores[n][1][key], want[n][1][key]))
    tm = cli_timing(os.path.join(run_dir, "sharded.log"))
    print(f"cli.inference in the world: 12 CSVs by rank 0, against phase 10's "
          f"token-space run on {key}: rmse rel {rmse:.3e}, acc abs "
          f"{acc:.3e} (tol {BF16_SCORE_TOL:.1e}); wall "
          f"{tm['wall_s_per_sample']:.3f} s per sample (device "
          f"{tm['device_s_per_sample']:.3f}); launches per rank "
          f"{ {k: v for k, v in ranks[0]['cli']['counts'].items() if v} }")
    if not (rmse <= BF16_SCORE_TOL and acc <= BF16_SCORE_TOL):
        raise AssertionError("the sharded command line's scores differ")
    for r in ranks:
        if r["cli"]["counts"]["transition_wm_z"] != 1:
            raise AssertionError(f"rank {r['rank']}: cli launches "
                                 f"{r['cli']['counts']}")
    out["cli"] = {"rmse_rel": rmse, "acc_abs": acc, **tm}
    del refs
    torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------------------
# 12. sharded training
# ---------------------------------------------------------------------------

# (mesh (dp, sp, tp), batch, depths or None: the full depth, the dtypes of
# ``world_runs`` it trains in)
TRAIN_MESHES = (((1, 3, 2), 1, None, ("float32", "bf16")),
                ((2, 3, 1), 2, (2, 2, 2, 2), ("bf16",)))
TRAIN_WORLD_STEPS = 2
# phase 12c: the training command lines in the world, at the second mesh
TRAIN_CLI_MESH, TRAIN_CLI_BATCH, TRAIN_CLI_DEPTHS = (2, 3, 1), 2, (2, 2, 2, 2)
TRAIN_CLI_STEPS = 4                 # --smoke: 2 epochs of 2 steps
TRAIN_CLI_SERVED = 5                # 2 validations of 2 samples, 1 test
TRAIN_CLI_RUNS = (
    ("finetune", "finetune_fully", (), set()),
    ("lora_tune", "lora", ("train.lora_dropout_mode=feature",),
     {"lora_adapter", "merged"}))
# kernels no sharded training or serving path of the trunk launches
EDGE_KERNELS = ("embed_wm", "recovery_wm_upper", "recovery_wm_surface",
                "embed_dw_upper", "recovery_bwd")
TRAIN_WORLD_TIMEOUT_S = 600
TRAIN_LOSS_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-3}
TRAIN_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def checksum(tensors):
    """A digest of many tensors' bits computed on their device: per tensor,
    the int64 sums of its words (32-bit, or 16-bit for 2-byte dtypes) plain
    and weighted by position (a change of any one word changes the second
    sum), then sha256 of those sums.  The params' sha256 on the host
    (``digest``) would copy the whole tree off the card every step."""
    import hashlib
    sums = []
    for t in tensors:
        v = t.detach().reshape(-1)
        v = v.view(torch.int16 if v.element_size() == 2 else torch.int32)
        v = v.to(torch.int64)
        w = torch.arange(1, v.numel() + 1, device=v.device) % 1_000_003
        sums += [v.sum(), (v * w).sum()]
    h = hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def train_world_cfg(cfg, depths):
    return cfg if depths is None else dataclasses.replace(cfg, depths=depths)


def cut_depth(params, depths):
    """The tree of a depth-cut config: each stage's first blocks."""
    if depths is None:
        return params
    return {**params, "stages": [
        {"blocks": st["blocks"][:d]} for st, d in zip(params["stages"],
                                                      depths)]}


def train_steps(cfg, params32, dtype, batch, consts, dev, mesh=None,
                on_step=None):
    """TRAIN_WORLD_STEPS steps of ``make_train_step`` from ``params32`` in
    ``dtype`` (under ``mesh`` where given), step i seeded SEED + 40 + i;
    returns the losses and the first step's gradient (CPU).  ``on_step(i,
    seconds, params)`` after each step."""
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine import train as T
    from pangu_tpu_torch.parallel import sharding

    p = T._map(params32, lambda t: t.detach().to(dev, dtype, copy=True))
    tcfg = TrainConfig()
    opt = T.make_optimizer(tcfg)
    state = T.create_train_state(p, opt)
    step = T.make_train_step(cfg, tcfg, consts, opt, device=dev)
    losses, grads = [], None
    with sharding.use_mesh(mesh):
        for i in range(TRAIN_WORLD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, SEED + 40 + i)
            torch.cuda.synchronize()
            losses.append(float(metrics["loss"]))
            if i == 0:
                grads = to_dtype(T._map(p, lambda t: t.grad.detach()),
                                 torch.device("cpu"))
            if on_step is not None:
                on_step(i, time.perf_counter() - t0, p)
    del state, step, opt, p
    torch.cuda.empty_cache()
    return losses, grads


def train_world_runs():
    """(shape, batch, depths, label, cfg, dtype) of phase 12b's runs."""
    return [(shape, b, depths, label, cfg, dtype)
            for shape, b, depths, labels in TRAIN_MESHES
            for label, cfg, dtype in world_runs() if label in labels]


def train_cli_rank(runs):
    """Phase 12c on one rank of the world: each ``(module, argv)`` of
    ``runs`` ("{rank}" in an argument replaced by this rank's number): its
    return code, the validation losses ``train_loop`` returned, the launch
    counts and the wall seconds."""
    import importlib
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.engine import train as T
    from pangu_tpu_torch.parallel import mesh as M

    rank = str(M.world()[0])
    loop, histories, out = T.train_loop, [], []

    def recorded(*args, **kw):
        state, history = loop(*args, **kw)
        histories.append(history)
        return state, history

    T.train_loop = recorded
    try:
        for module, argv in runs:
            histories.clear()
            ops.reset_launches()
            t0 = time.perf_counter()
            rc = importlib.import_module(f"pangu_tpu_torch.cli.{module}").main(
                [a.replace("{rank}", rank) for a in argv])
            torch.cuda.synchronize()
            out.append({"rc": rc, "s": time.perf_counter() - t0,
                        "val_loss": [h["val_loss"] for h in histories],
                        "counts": ops.launches()})
    finally:
        T.train_loop = loop
    return out


def train_world_rank(path, cli_runs):
    """One rank of phase 12's world: each run of ``train_world_runs``, two
    sharded Adam steps; per step the launch counts, the exchanges by
    collective, the wall seconds and a digest of the params; rank 0 also
    returns the first step's gradient.  The rank's peak device memory over
    those runs.  Then the command lines of ``cli_runs`` (phase 12c)."""
    import torch.distributed as dist
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import MeshConfig
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.parallel import mesh as M

    from pangu_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    blob = torch.load(path, mmap=True, weights_only=False)
    rank = M.world()[0]
    out = {"rank": rank, "backend": None, "runs": {}}
    # the seconds of each step's gradient sum, timed around reduce_grads
    reduce_grads, sum_s = sharding.reduce_grads, []

    def timed_reduce(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = reduce_grads(*args)
        torch.cuda.synchronize()
        sum_s.append(time.perf_counter() - t0)
        return res

    sharding.reduce_grads = timed_reduce
    meshes = {}
    for shape, b, depths, label, cfg0, dtype in train_world_runs():
        if shape not in meshes:
            meshes[shape] = M.build_mesh(MeshConfig(*shape))
        mesh = meshes[shape]
        dev = mesh.device
        out["backend"], out["host_staged"] = dist.get_backend(), \
            mesh.host_staged
        batch = {k: v.to(dev) for k, v in blob[f"batch{b}"].items()}
        params32 = cut_depth(blob["params"], depths)
        cfg = train_world_cfg(cfg0, depths)
        consts = to_device(synthetic_constants(cfg, seed=SEED), dev)
        steps = []

        def on_step(i, sec, p):
            steps.append({"counts": ops.launches(), "s": sec,
                          "sum_s": sum_s.pop(),
                          "by_op": {k: list(v) for k, v in
                                    mesh.by_op.items()},
                          "digest": checksum(leaves(p))})
            ops.reset_launches()
            mesh.reset_counts()

        ops.reset_launches()
        mesh.reset_counts()
        losses, grads = train_steps(cfg, params32, dtype, batch, consts,
                                    dev, mesh, on_step)
        rec = {"losses": losses, "steps": steps, "coords": mesh.coords}
        if rank == 0:
            rec["grads"] = grads
        out["runs"][(shape, label)] = rec
        del grads
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del blob, batch, consts, mesh, meshes
    torch.cuda.empty_cache()
    sharding.reduce_grads = reduce_grads
    out["cli"] = train_cli_rank(cli_runs)
    return out


def block_bwd_shard(params32):
    """Phase 12a: ``block_bwd`` on a (tp 2, sp 3) shard of stage 0 with the
    rank's rows of the region ids and the bias table, against its plain
    version; a launch that would read across shards raises."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.earth_block_bwd import block_bwd, block_bwd_plain

    dev = torch.device("cuda")
    g0 = PANGU_24.stage(0)
    wz, wh, ww = g0.window
    nz, nlat, nlon = g0.z // wz, g0.h_padded // wh, g0.w // ww
    tpn, spn = 2, 3
    nzl, nll = nz // tpn, nlon // spn
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    ids = torch.as_tensor(window_region_ids(g0.z, g0.h_padded, g0.window),
                          device=dev)[:nzl * nlat]
    shape = (1, nzl, nlat, nll, wz * wh * ww, g0.dim)
    drop = torch.tensor([[1.25, 0.0]], device=dev)
    out = {}
    for label, cfg, dtype in world_runs():
        bp = to_dtype(to_dtype(params32["stages"][0]["blocks"][1], dev),
                      dtype)
        bp["attn"]["bias_table"] = bp["attn"]["bias_table"][:nzl * nlat]
        x, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        args = (bp, x, g, g0, (0, 3, 0), (0, 0, 0), 3, ids, drop,
                cfg.gelu_tanh)
        got, want = block_bwd(*args), block_bwd_plain(*args)
        errs = [("dx", *rel_err(got[0], want[0]))] + tree_errs(got[1],
                                                              want[1])
        worst = max(errs, key=lambda e: e[2])
        ms = time_ms(lambda: block_bwd(*args), 3)
        print(f"block_bwd {label} on a (tp {tpn}, sp {spn}) shard "
              f"{tuple(x.shape)}, table {tuple(bp['attn']['bias_table'].shape)}"
              f": worst {worst[0]} max_abs_err {worst[1]:.3e} rel "
              f"{worst[2]:.3e} (tol {TOL[dtype]:.1e}), {ms:.3f} ms",
              flush=True)
        if worst[2] > TOL[dtype]:
            raise AssertionError(f"block_bwd on a shard, {label}: {worst}")
        out[label] = {"worst": worst[0], "rel": worst[2], "ms": ms}
        for bad in ((1, 3, 0), (0, 3, 6)):
            try:
                block_bwd(bp, x, g, g0, bad, (0, 0, 0), 3, ids, drop,
                          cfg.gelu_tanh)
            except ValueError as e:
                print(f"  shift {bad} on the shard: raises ({e})")
            else:
                raise AssertionError(f"block_bwd with {bad} did not raise")
        del bp, x, g, got, want
    torch.cuda.empty_cache()
    return out


def sharded_train_phase(smi, path_counts, tmp):
    """Phase 12: ``block_bwd`` on a shard, then a world of ``WORLD`` ranks
    on the one card training two meshes, against one device's steps."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    print("card:", smi)
    t0 = time.perf_counter()
    params32 = pangu.init_params(torch.Generator().manual_seed(SEED),
                                 PANGU_24, device="cpu")
    out = {"block_bwd_shard": block_bwd_shard(params32)}
    print(f"params and 12a: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    consts_dev = to_device(synthetic_constants(PANGU_24, seed=SEED), dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 14)

    def state(b):
        u = (consts_dev["upper_mean"][None] + consts_dev["upper_std"][None]
             * torch.randn((b, 5, PANGU_24.levels, PANGU_24.lat,
                            PANGU_24.lon), generator=g, device=dev))
        s = (consts_dev["surface_mean"][None]
             + consts_dev["surface_std"][None]
             * torch.randn((b, 4, PANGU_24.lat, PANGU_24.lon), generator=g,
                           device=dev))
        return u, s

    # every batch the first samples of the largest
    b_max = max(m[1] for m in TRAIN_MESHES)
    (u, s), (tu, ts) = state(b_max), state(b_max)
    whole = {"upper": u, "surface": s, "target_upper": tu,
             "target_surface": ts}
    blob = {"params": params32}
    for b in sorted({m[1] for m in TRAIN_MESHES}):
        blob[f"batch{b}"] = {k: v[:b].cpu() for k, v in whole.items()}
    path = os.path.join(tmp, "train_world.pt")
    torch.save(blob, path)
    del consts_dev, whole, u, s, tu, ts
    print(f"inputs drawn and saved for the world: "
          f"{time.perf_counter() - t0:.2f} s")

    # one device's two steps of every run, in this process
    refs = {}
    t0 = time.perf_counter()
    for shape, b, depths, label, cfg0, dtype in train_world_runs():
        batch = {k: v.to(dev) for k, v in blob[f"batch{b}"].items()}
        cfg = train_world_cfg(cfg0, depths)
        consts = to_device(synthetic_constants(cfg, seed=SEED), dev)
        walls = []
        refs[(shape, label)] = train_steps(
            cfg, cut_depth(params32, depths), dtype, batch, consts, dev,
            on_step=lambda i, sec, p: walls.append(sec))
        print(f"one device, batch {b}, depths {cfg.depths}, {label}: "
              f"losses {refs[(shape, label)][0]}, wall per step "
              f"{[round(w, 3) for w in walls]} s", flush=True)
        del batch, consts
    torch.cuda.synchronize()
    print(f"single-device references: {time.perf_counter() - t0:.2f} s")
    del blob
    torch.cuda.empty_cache()

    print(f"this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB of the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
          f"reserved) while the world runs")
    # the ranks' allocators map what they use in growable segments: six
    # processes share the card, and a rank's freed-but-cached blocks are
    # memory the others cannot have
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    cli_root = os.path.join(tmp, "train_cli")
    cli_runs = [(module, train_cli_argv(cli_root, name, sets))
                for module, name, sets, _ in TRAIN_CLI_RUNS]
    t0 = time.perf_counter()
    try:
        ranks = launch.run(train_world_rank, WORLD, path, cli_runs,
                           device="cuda", timeout_s=TRAIN_WORLD_TIMEOUT_S)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"world of {WORLD} ranks: backend {r0['backend']}, exchanges "
          f"through host buffers {r0['host_staged']}, the whole world "
          f"{world_s:.1f} s (spawn, loads, {len(train_world_runs())} runs "
          f"of {TRAIN_WORLD_STEPS} steps, {len(cli_runs)} command lines); "
          f"six CUDA contexts share the one card and every exchange crosses "
          f"the host: no multi-card number")
    out["world_s"] = world_s
    out["peak_gib"] = [r["peak_bytes"] / 2 ** 30 for r in ranks]
    print("peak device memory per rank (GiB): "
          + ", ".join(f"{v:.2f}" for v in out["peak_gib"]))
    for shape, b, depths, label, cfg0, dtype in train_world_runs():
        n_blocks = sum(depths or PANGU_24.depths)
        want_counts = {"block_wm": n_blocks, "block_bwd": n_blocks,
                       "down_sample_wm": 1, "up_sample_wm": 1}
        key = (shape, label)
        name = (f"mesh {shape} batch {b} depths "
                f"{depths or PANGU_24.depths} {label}")
        want_losses, want_grads = refs.pop(key)
        got = r0["runs"][key]
        lrel = max(abs(a - w) / abs(w)
                   for a, w in zip(got["losses"], want_losses))
        errs = tree_errs(got["grads"], want_grads)
        worst = max(errs, key=lambda e: e[2])
        print(f"sharded train {name}: losses {got['losses']} vs one "
              f"device {want_losses} (rel {lrel:.3e}, tol "
              f"{TRAIN_LOSS_TOL[dtype]:.0e}); step-1 gradient "
              f"({len(errs)} leaves) worst {worst[0]} max_abs_err "
              f"{worst[1]:.3e} rel {worst[2]:.3e} (tol "
              f"{TRAIN_GRAD_TOL[dtype]:.0e})", flush=True)
        if (lrel > TRAIN_LOSS_TOL[dtype]
                or worst[2] > TRAIN_GRAD_TOL[dtype]):
            raise AssertionError(f"sharded train {name}: loss rel {lrel}"
                                 f", gradient {worst}")
        for i in range(TRAIN_WORLD_STEPS):
            digests = {r["runs"][key]["steps"][i]["digest"]
                       for r in ranks}
            if len(digests) != 1:
                raise AssertionError(f"sharded train {name} step {i}: "
                                     f"the ranks' params differ")
        print(f"  params bit-equal across the {WORLD} ranks after each "
              f"of the {TRAIN_WORLD_STEPS} steps")
        total = {}
        for r in ranks:
            for i, st in enumerate(r["runs"][key]["steps"]):
                counts = st["counts"]
                ops_ = st["by_op"]
                mib = {k: v[1] / 2 ** 20 for k, v in ops_.items()}
                print(f"  rank {r['rank']} {r['runs'][key]['coords']} "
                      f"step {i}: launches "
                      f"{ {k: v for k, v in counts.items() if v} }; "
                      f"halos {ops_.get('ppermute', [0])[0]} exchanges "
                      f"{mib.get('ppermute', 0):.1f} MiB, gathers "
                      f"{ops_.get('all_gather', [0])[0]} "
                      f"{mib.get('all_gather', 0):.1f} MiB, gradient "
                      f"sum {ops_.get('all_reduce', [0])[0]} "
                      f"{mib.get('all_reduce', 0):.1f} MiB; wall "
                      f"{st['s']:.3f} s, of which the gradient sum "
                      f"{st['sum_s']:.3f}")
                if counts != {**{k: 0 for k in counts}, **want_counts}:
                    raise AssertionError(
                        f"rank {r['rank']} {name} step {i}: launches "
                        f"{counts}, want {want_counts}")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
        walls = [st["s"] for r in ranks for st in r["runs"][key]["steps"]]
        sums = [st["sum_s"] for r in ranks
                for st in r["runs"][key]["steps"]]
        print(f"  over the {WORLD} ranks and {TRAIN_WORLD_STEPS} steps: wall "
              f"{min(walls):.3f}-{max(walls):.3f} s a step, of which the "
              f"gradient sum {min(sums):.3f}-{max(sums):.3f} s")
        path_counts[f"sharded train {name}"] = total
        out[name] = {"loss_rel": lrel, "grad_rel": worst[2],
                     "grad_worst": worst[0],
                     "s_per_step": [st["s"] for r in ranks
                                    for st in r["runs"][key]["steps"]],
                     "sum_s_per_step": [
                         st["sum_s"] for r in ranks
                         for st in r["runs"][key]["steps"]],
                     "by_op_step0": r0["runs"][key]["steps"][0]["by_op"]}
    out["cli"] = check_train_cli(ranks, cli_root, path_counts)
    del ranks
    torch.cuda.empty_cache()
    return out


def train_cli_argv(root, name, sets, mesh=TRAIN_CLI_MESH,
                   batch=TRAIN_CLI_BATCH):
    """Phase 12c's (and 13d's) arguments of one training command line:
    each rank writes under ``root/rank<r>`` (only rank 0 may create it)."""
    items = (f"model.depths={list(TRAIN_CLI_DEPTHS)}",
             f"train.batch_size={batch}",
             *(f"mesh.{a}={n}" for a, n in zip(("dp", "sp", "tp"), mesh)),
             "model.gelu=tanh", "data.test_start=20180103",
             "data.test_end=20180104", "data.test_freq=24h",
             "data.num_workers=1", "data.prefetch=1", *sets,
             f"output_path={os.path.join(root, 'rank{rank}')}")
    return ["--bf16", "--synthetic", "--smoke", "--type_net", name,
            *(a for item in items for a in ("--set", item))]


def check_train_cli(ranks, root, path_counts):
    """Phase 12c's checks on the world's command-line runs: every rank
    returned 0 and only rank 0 wrote; the validation losses are finite and
    the same on every rank; the launches of the training steps and of the
    served forwards, and no edge kernel."""
    from pangu_tpu_torch.config import DataConfig

    out = {}
    if sorted(os.listdir(root)) != ["rank0"]:
        raise AssertionError(f"12c: ranks other than 0 wrote: "
                             f"{sorted(os.listdir(root))}")
    n_blocks = sum(TRAIN_CLI_DEPTHS)
    for i, (module, name, _, extra) in enumerate(TRAIN_CLI_RUNS):
        runs = [r["cli"][i] for r in ranks]
        run_dir = os.path.join(root, "rank0", name,
                               str(DataConfig().horizon))
        models = set(os.listdir(os.path.join(run_dir, "models")))
        csvs = os.listdir(os.path.join(run_dir, "test", "csv"))
        with open(os.path.join(run_dir, f"{name}.log")) as f:
            log = f.read()
        vals = {tuple(r["val_loss"][0]) for r in runs}
        val = runs[0]["val_loss"][0]
        print(f"cli.{module} in the world, mesh {TRAIN_CLI_MESH} batch "
              f"{TRAIN_CLI_BATCH} depths {TRAIN_CLI_DEPTHS} bf16: return "
              f"codes {[r['rc'] for r in runs]}; rank 0 wrote models "
              f"{sorted(models)}, {len(csvs)} test CSVs and the log; "
              f"validation losses {val} on every rank "
              f"{len(vals) == 1}; wall {runs[0]['s']:.1f} s", flush=True)
        for r in ranks:
            c = r["cli"][i]["counts"]
            print(f"  rank {r['rank']}: launches "
                  f"{ {k: v for k, v in c.items() if v} }")
            # a train step: one block_wm and one block_bwd a block; a
            # served forward: its blocks, grouped or not
            trunks = TRAIN_CLI_STEPS + TRAIN_CLI_SERVED
            if (c["block_bwd"] != TRAIN_CLI_STEPS * n_blocks
                    or c["block_wm"] + c["block_wm_group"] != trunks * n_blocks
                    or c["down_sample_wm"] != trunks
                    or c["up_sample_wm"] != trunks
                    or any(c[k] for k in EDGE_KERNELS)):
                raise AssertionError(f"12c {module} rank {r['rank']}: "
                                     f"launches {c}")
        if (any(r["rc"] != 0 for r in runs) or len(vals) != 1
                or not val or not all(math.isfinite(v) for v in val)
                or "best.pt" not in models or not extra <= models
                or len(csvs) != 12 or "done; best val loss" not in log):
            raise AssertionError(f"12c {module}: codes "
                                 f"{[r['rc'] for r in runs]}, val losses "
                                 f"{vals}, models {models}, {len(csvs)} CSVs")
        path_counts[f"sharded train cli.{module}"] = {
            k: sum(r["cli"][i]["counts"][k] for r in ranks)
            for k in runs[0]["counts"]}
        out[module] = {"val_loss": val, "s": [r["s"] for r in runs]}
    return out


# ---------------------------------------------------------------------------
# 13. the canonical-layout route under a mesh
# ---------------------------------------------------------------------------

# 13a/b: sp 3 divides both stages' longitude windows (30, 15); the
# canonical route collapses tp, so the tp pairs replicate the work
CANON_MESH = (1, 3, 2)
# 13c: the window-major gate refuses it (sp 2 and stage 1's 15 windows, tp
# 3 and stage 0's 4 z windows); the canonical view collapses sp and tp
CANON_REFUSED_MESH = (1, 2, 3)
CANON_TRAIN_MESH, CANON_TRAIN_BATCH = (2, 3, 1), 2
CANON_TRAIN_DEPTHS = (2, 2, 2, 2)
# 13d's cli.lora_tune (element-mode dropout, block by block on the plain
# layers): a rank's step peaks at ~11-13 GiB, and six of them do not fit
# the card beside each other (they did not at (2, 3, 1) batch 2 nor at
# (1, 3, 2) batch 1); at (1, 3, 1) batch 1 three ranks compute the share
# each computes at (2, 3, 1), and the other three stay idle
CANON_CLI_MESH, CANON_CLI_BATCH = (1, 3, 1), 1
CANON_STEPS = 2
CANON_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -4}
CANON_GRAD_TOL = 1e-3
CANON_WORLD_TIMEOUT_S = 600
# the kernels of the canonical route's main path, by row of PERF.md
CANON_ROWS = {"block_v2": "12", "grid_attention": "16",
              "grid_attention_bwd": "17", "block_wm_canon": "1b",
              "block_wm_group": "2", "down_sample": "20", "up_sample": "21"}


def canon_cfgs():
    """(float32 wm, bf16 wm, float32 v2, bf16 v2) configs of phase 13."""
    from pangu_tpu_torch.config import PANGU_24
    perf = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                               compute_dtype="bfloat16", gelu="tanh")
    return (PANGU_24, perf,
            dataclasses.replace(PANGU_24, block_layout="v2"),
            dataclasses.replace(perf, block_layout="v2"))


def canon_served_runs():
    """(label, config, dtype, kind, mesh, launches a rank) of phase 13's
    served runs: 13a the v2 forward, 13b the v2 trajectory and the wm taps
    forward, 13c the wm forward on a mesh the window-major gate refuses."""
    wm32, wm16, v2_32, v2_16 = canon_cfgs()
    n = sum(wm32.depths)
    v2 = {"block_v2": n, "down_sample": 1, "up_sample": 1}
    return (
        ("13a v2 forward float32", v2_32, torch.float32, "forward",
         CANON_MESH, v2),
        ("13a v2 forward bf16", v2_16, torch.bfloat16, "forward", CANON_MESH,
         v2),
        ("13b v2 trajectory bf16", v2_16, torch.bfloat16, "trajectory",
         CANON_MESH, {k: CANON_STEPS * v for k, v in v2.items()}),
        ("13b wm taps float32", wm32, torch.float32, "taps", CANON_MESH,
         {"block_wm_canon": 8, "block_wm_group": n - 8, "down_sample": 1,
          "up_sample": 1}),
        ("13c wm forward bf16", wm16, torch.bfloat16, "forward",
         CANON_REFUSED_MESH, WORLD_TRUNK))


def canon_serve(kind, cfg, params, consts, u, s):
    """One served call of phase 13 (whole results, flattened): a forward,
    a taps forward (prediction, then the taps by name) or the
    ``CANON_STEPS``-step token-space trajectory."""
    from pangu_tpu_torch.engine.rollout import make_rollout
    from pangu_tpu_torch.models import pangu
    if kind == "forward":
        return list(pangu.forward(params, u, s, consts, cfg))
    if kind == "taps":
        taps = {}
        out = pangu.forward(params, u, s, consts, cfg, taps=taps)
        return list(out) + [taps[k] for k in sorted(taps)]
    final, traj = make_rollout(cfg, consts, CANON_STEPS, token_space=True,
                               return_trajectory=True)(params, u, s)
    return list(final) + list(traj)


def canon_train_runs():
    """(label, config, dtype, LoRA, launches a rank a step) of 13d's
    trained runs: a float32 gradient of the v2 model and one of the v2
    model's element-mode LoRA tree of ``canon_lora_tree`` (one
    ``loss_and_grads`` each, no optimizer: six ranks' float32 Adam steps do
    not fit the card beside each other), two bf16 Adam steps of the v2
    model twice (the second run bit-identical to the first).  v2 for the
    LoRA tree too: one device then trains its stages without LoRA as the
    mesh does (the window-major layout trains them through the stage
    Function with canonical ends on one device, row 11c, and through v2
    blocks under a mesh).  The LoRA gradient takes the targets of
    ``far_targets``: the LoRA products on a shard round otherwise than on
    the whole grid, and with the batch's own targets that flipped the sign
    of a few L1 residuals and moved the tiny leaves (stage 3's last bias
    table by 3.1e-2 of its max, the loss equal)."""
    _, _, v2_32, v2_16 = canon_cfgs()
    n = sum(CANON_TRAIN_DEPTHS)
    v2 = {"block_v2": n, "grid_attention": n, "grid_attention_bwd": n,
          "down_sample": 1, "up_sample": 1}
    # the stages without LoRA train on v2 blocks; stage 1, with LoRA and
    # element dropout, on the plain layers
    m = sum(CANON_TRAIN_DEPTHS) - CANON_TRAIN_DEPTHS[1]
    lora = {"block_v2": m, "grid_attention": m, "grid_attention_bwd": m,
            "down_sample": 1, "up_sample": 1}
    return (("float32", train_world_cfg(v2_32, CANON_TRAIN_DEPTHS),
             torch.float32, False, v2),
            ("element LoRA float32",
             train_world_cfg(v2_32, CANON_TRAIN_DEPTHS), torch.float32, True,
             lora),
            ("bf16", train_world_cfg(v2_16, CANON_TRAIN_DEPTHS),
             torch.bfloat16, False, v2),
            ("bf16 again", train_world_cfg(v2_16, CANON_TRAIN_DEPTHS),
             torch.bfloat16, False, v2))


def far_targets(batch, consts):
    """``batch`` with its targets 1000 standard deviations below their
    means: every residual of the weighted L1 loss is then positive, so its
    cotangent is one constant on any path, as phases 6-9 hold two paths to
    one loss cotangent."""
    return {**batch,
            "target_upper": batch["target_upper"] - 1e3 * consts["upper_std"],
            "target_surface": (batch["target_surface"]
                               - 1e3 * consts["surface_std"])}


def canon_lora_tree(cut):
    """13d's element-mode LoRA tree from the depth-cut tree ``cut``:
    rank-4 factors with dropout 0.1 in element mode at every dense site of
    stage 1's blocks (both kinds of mask cut: a window site's rows and a
    grid site's tokens, over dp and sp), B drawn nonzero (each mask then
    reaches the loss and A's gradient); the rest keeps no LoRA (with LoRA
    in stages 1 and 2 and at Down/UpSample, or in stage 1 and at
    Down/UpSample, six ranks' float32 gradients ran out of the card's
    memory).  Drawn from seeded CPU generators: the same on every rank."""
    from pangu_tpu_torch.models import lora
    tree = {**cut, "stages": list(cut["stages"])}
    tree["stages"][1] = lora.init_lora(
        torch.Generator().manual_seed(SEED + 41), cut["stages"][1], rank=4,
        dropout=0.1, dropout_mode="element")
    gen = torch.Generator().manual_seed(SEED + 42)
    for site in lora._dense_nodes(tree["stages"][1]):
        site["lora_b"] = 0.01 * torch.randn(site["lora_b"].shape,
                                            generator=gen)
    return tree


def canon_grads(cfg, params32, batch, consts, dev, mesh=None):
    """13d's float32 loss and gradient (``engine.train.loss_and_grads``,
    seeded as ``train_steps``' first step, no optimizer) from ``params32``
    (under ``mesh`` where given): ``(losses, grads on the CPU, seconds)``."""
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine import train as T
    from pangu_tpu_torch.parallel import sharding

    p = T._map(params32, lambda t: t.detach().to(dev, torch.float32,
                                                copy=True).requires_grad_())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sharding.use_mesh(mesh):
        loss, _, grads = T.loss_and_grads(p, batch, consts, cfg,
                                          TrainConfig(), device=dev,
                                          seed=SEED + 40)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    grads = to_dtype(grads, torch.device("cpu"))
    del p
    torch.cuda.empty_cache()
    return [float(loss)], grads, sec


def canon_rank(path, cli_runs):
    """One rank of phase 13's world: each served run of
    ``canon_served_runs`` and each trained run of ``canon_train_runs`` with
    the rank's launch counts, exchanges by collective, wall seconds and
    peak device memory (and rank 0's results), then the command lines of
    ``cli_runs``."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import MeshConfig
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.parallel import mesh as M
    from pangu_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    blob = torch.load(path, mmap=True, weights_only=False)
    rank = M.world()[0]
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = M.build_mesh(MeshConfig(*shape))
        return meshes[shape]

    def measured(mesh, fn):
        ops.reset_launches()
        mesh.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {"counts": ops.launches(), "s": time.perf_counter() - t0,
                     "by_op": {k: list(v) for k, v in mesh.by_op.items()},
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    out = {"rank": rank, "served": {}, "train": {}}
    dev = mesh_of(CANON_MESH).device
    u, s = blob["upper"].to(dev), blob["surface"].to(dev)
    consts = to_device(synthetic_constants(canon_cfgs()[0], seed=SEED), dev)
    params32 = to_dtype(blob["params"], dev)
    for label, cfg, dtype, kind, shape, _ in canon_served_runs():
        mesh = mesh_of(shape)
        params = to_dtype(params32, dtype)
        with sharding.use_mesh(mesh):
            res, rec = measured(mesh, lambda: canon_serve(
                kind, cfg, params, consts, u, s))
        rec["coords"] = mesh.coords
        rec["digest"] = digest(res)
        if rank == 0:
            rec["result"] = [t.cpu() for t in res]
        out["served"][label] = rec
        del res, params
    del params32
    torch.cuda.empty_cache()

    mesh = mesh_of(CANON_TRAIN_MESH)
    batch = {k: v.to(dev) for k, v in blob["batch"].items()}
    cut = cut_depth(blob["params"], CANON_TRAIN_DEPTHS)
    for label, cfg, dtype, lora, _ in canon_train_runs():
        tc = to_device(synthetic_constants(cfg, seed=SEED), dev)
        if dtype == torch.float32:
            tree = canon_lora_tree(cut) if lora else cut
            b = far_targets(batch, tc) if lora else batch
            (losses, grads, _), rec = measured(mesh, lambda: canon_grads(
                cfg, tree, b, tc, dev, mesh))
            rec["digest"] = checksum(flat(grads))
            rec = {"losses": losses, "steps": [rec], "coords": mesh.coords}
            if rank == 0:
                rec["grads"] = grads
            out["train"][label] = rec
            del grads
            continue
        steps = []

        def on_step(i, sec, p):
            steps.append({"counts": ops.launches(), "s": sec,
                          "by_op": {k: list(v) for k, v in
                                    mesh.by_op.items()},
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30, "digest": checksum(leaves(p))})
            ops.reset_launches()
            mesh.reset_counts()

        ops.reset_launches()
        mesh.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, grads = train_steps(cfg, cut, dtype, batch, tc, dev, mesh,
                                    on_step)
        out["train"][label] = {"losses": losses, "steps": steps,
                               "coords": mesh.coords}
        del grads
    del blob, batch
    torch.cuda.empty_cache()
    out["cli"] = train_cli_rank(cli_runs)
    return out


def canon_shard_kernels(params32, smi):
    """Phase 13's kernels on the shapes a rank of the canonical route gives
    them (sp 3 at full width: a third of each stage's longitude windows),
    each against its plain version (``TOL``), with its time, the plain
    version's and the bound; returns their lines by row."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.models.layers import window_region_ids
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    from pangu_tpu_torch.ops.earth_block_wm import (block_wm_canon,
                                                    block_wm_canon_plain,
                                                    block_wm_group,
                                                    block_wm_plain)
    from pangu_tpu_torch.ops.updown import (down_sample, down_sample_plain,
                                            up_sample, up_sample_plain)
    from pangu_tpu_torch.ops.window_attention import (
        grid_attention, grid_attention_bwd, grid_attention_bwd_plain,
        grid_attention_plain)

    dev = torch.device("cuda")
    spn = CANON_MESH[1]
    g0, g1, g2, g3 = (PANGU_24.stage(i) for i in range(4))
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out = {}

    def wbytes(p, dtype):
        n = sum(t.numel() for t in leaves(p) if t.dim() < 4)
        return n * torch.tensor([], dtype=dtype).element_size()

    for label, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        p = to_dtype(to_dtype({"s0": params32["stages"][0]["blocks"][1],
                               "s1": params32["stages"][1]["blocks"][2],
                               "down": params32["downsample"],
                               "up": params32["upsample"]}, dev), dtype)
        cases = []
        for geom, bp, sname in ((g0, p["s0"], "stage 0"),
                                (g1, p["s1"], "stage 1")):
            c, n = geom.dim, geom.window_tokens
            ids = torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                                    geom.window), device=dev)
            w_l = geom.w // spn
            x = torch.randn((1, geom.z, geom.h_padded, w_l, c), generator=gen,
                            device=dev).to(dtype)
            gy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            rows = x.numel() // c
            tb = bp["attn"]["bias_table"]
            byts = 2 * nbytes(x) + nbytes(tb) + wbytes(bp, dtype) + nbytes(ids)
            name = f"{sname} sp-{spn} shard"
            cases.append((
                "block_v2", f"{name}, shift (1, 3, 0)",
                2 * rows * c * (12 * c + 2 * n), byts,
                lambda bp=bp, x=x, g=geom, i=ids: block_v2(
                    bp, x, g, (1, 3, 0), 3, i, dtype == torch.bfloat16),
                lambda bp=bp, x=x, g=geom, i=ids: block_v2_plain(
                    bp, x, g, (1, 3, 0), 3, i, dtype == torch.bfloat16),
                (3, 1)))
            at = bp["attn"]
            w = (at["qkv"]["kernel"], at["qkv"]["bias"], at["proj"]["kernel"],
                 at["proj"]["bias"])
            cases.append((
                "grid_attention", f"{name}, region ids",
                2 * rows * c * (4 * c + 2 * n),
                2 * nbytes(x) + nbytes(*w, tb) + nbytes(ids),
                lambda x=x, w=w, tb=tb, g=geom, i=ids:
                    grid_attention(x, *w, tb, g.window, i),
                lambda x=x, w=w, tb=tb, g=geom, i=ids:
                    grid_attention_plain(x, *w, tb, g.window, i), (3, 1)))
            cases.append((
                "grid_attention_bwd", f"{name}, region ids",
                2 * rows * (11 * c * c + 6 * n * c),
                3 * nbytes(x) + nbytes(*w[:3], tb) + nbytes(ids)
                + 4 * (sum(t.numel() for t in w) + tb.numel()),
                lambda x=x, gy=gy, w=w, tb=tb, g=geom, i=ids:
                    grid_attention_bwd(x, gy, *w[:3], tb, g.window, i),
                lambda x=x, gy=gy, w=w, tb=tb, g=geom, i=ids:
                    grid_attention_bwd_plain(x, gy, *w[:3], tb, g.window, i),
                (2, 1)))
            xs = to_window_major_(x, geom)
            tanh = dtype == torch.bfloat16
            cases.append((
                "block_wm_canon", f"{name}, canonical in", 2 * rows * c * (
                    12 * c + 2 * n), byts - nbytes(ids),
                lambda bp=bp, x=x, g=geom: block_wm_canon(
                    bp, x, g, (0, 0, 0), 0, None, tanh, in_layout="canon"),
                lambda bp=bp, x=x, g=geom: block_wm_canon_plain(
                    bp, x, g, (0, 0, 0), 0, None, tanh, "canon", "wm"),
                (3, 1)))
            cases.append((
                "block_wm_canon", f"{name}, canonical out, shift (1, 3, 0)",
                2 * rows * c * (12 * c + 2 * n), byts,
                lambda bp=bp, xs=xs, g=geom, i=ids: block_wm_canon(
                    bp, xs, g, (1, 3, 0), 3, i, tanh, out_layout="canon"),
                lambda bp=bp, xs=xs, g=geom, i=ids: block_wm_canon_plain(
                    bp, xs, g, (1, 3, 0), 3, i, tanh, "wm", "canon"),
                (3, 1)))
            if geom is g1:
                gh = 2
                cases.append((
                    "block_wm_group", f"{name}, gh {gh}, shift (1, 3, 0)",
                    2 * rows * c * (12 * c + 2 * n), byts,
                    lambda bp=bp, xs=xs, g=geom, i=ids: block_wm_group(
                        bp, xs, g, (1, 3, 0), 3, i, tanh, gh),
                    lambda bp=bp, xs=xs, g=geom, i=ids: block_wm_plain(
                        bp, xs, g, (1, 3, 0), 3, i, tanh), (3, 1)))
        c0, c_in, c_out = g0.dim, g2.dim, g3.dim
        isz = torch.tensor([], dtype=dtype).element_size()
        x0 = torch.randn((1, g0.z, g0.h, g0.w // spn, c0), generator=gen,
                         device=dev).to(dtype)
        out_rows = g1.z * g1.h * g1.w // spn
        cases.append((
            "down_sample", f"stage 0 -> 1, sp-{spn} shard",
            2 * out_rows * 4 * c0 * 2 * c0,
            nbytes(x0) + out_rows * 2 * c0 * isz + wbytes(p["down"], dtype),
            lambda x=x0: down_sample(p["down"], x),
            lambda x=x0: down_sample_plain(p["down"], x), (5, 1)))
        x2 = torch.randn((1, g2.z, g2.h, g2.w // spn, c_in), generator=gen,
                         device=dev).to(dtype)
        in_rows, out_rows = x2.numel() // c_in, g3.z * g3.h * g3.w // spn
        cases.append((
            "up_sample", f"stage 2 -> 3, sp-{spn} shard",
            2 * in_rows * c_in * 4 * c_out + 2 * out_rows * c_out * c_out,
            nbytes(x2) + out_rows * c_out * isz + wbytes(p["up"], dtype),
            lambda x=x2: up_sample(p["up"], x, g3.h),
            lambda x=x2: up_sample_plain(p["up"], x, g3.h), (5, 1)))
        for line in check_kernels(cases, dtype, {}):
            out.setdefault(line["name"], []).append(
                {**line, "dtype": label, "card": smi})
        del cases, p
        torch.cuda.empty_cache()
    return out


def to_window_major_(x, geom):
    from pangu_tpu_torch.ops.earth_block_wm import to_window_major
    return to_window_major(x, geom.window).contiguous()


def canon_world_phase(smi, path_counts, tmp):
    """Phase 13: the canonical route's kernels on a rank's shard against
    their plain versions, then a world of ``WORLD`` ranks on the one card
    serving and training the canonical route (13a-d), against one
    device's runs."""
    from pangu_tpu_torch.config import PANGU_24
    from pangu_tpu_torch.data.constants import synthetic_constants, to_device
    from pangu_tpu_torch.models import pangu
    from pangu_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    print("card:", smi)
    t0 = time.perf_counter()
    params32 = pangu.init_params(torch.Generator().manual_seed(SEED),
                                 PANGU_24, device="cpu")
    out = {"shard_kernels": canon_shard_kernels(params32, smi)}
    print(f"params and the shard kernels: {time.perf_counter() - t0:.2f} s "
          f"({smi})")

    t0 = time.perf_counter()
    consts_dev = to_device(synthetic_constants(PANGU_24, seed=SEED), dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 16)

    def state(b):
        return (consts_dev["upper_mean"][None] + consts_dev["upper_std"][None]
                * torch.randn((b, 5, PANGU_24.levels, PANGU_24.lat,
                               PANGU_24.lon), generator=g, device=dev),
                consts_dev["surface_mean"][None]
                + consts_dev["surface_std"][None]
                * torch.randn((b, 4, PANGU_24.lat, PANGU_24.lon), generator=g,
                              device=dev))

    u, s = state(1)
    (bu, bs), (tu, ts) = state(CANON_TRAIN_BATCH), state(CANON_TRAIN_BATCH)
    batch = {"upper": bu, "surface": bs, "target_upper": tu,
             "target_surface": ts}
    path = os.path.join(tmp, "canon_world.pt")
    torch.save({"params": params32, "upper": u.cpu(), "surface": s.cpu(),
                "batch": {k: v.cpu() for k, v in batch.items()}}, path)

    refs, walls = {}, {}
    params_dev = to_dtype(params32, dev)
    for label, cfg, dtype, kind, shape, _ in canon_served_runs():
        p = to_dtype(params_dev, dtype)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        refs[label] = [t.cpu() for t in canon_serve(kind, cfg, p,
                                                     consts_dev, u, s)]
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t1
        del p
    del params_dev
    train_refs = {}
    cut = cut_depth(params32, CANON_TRAIN_DEPTHS)
    for label, cfg, dtype, lora, _ in canon_train_runs():
        if label == "bf16 again":
            continue
        tc = to_device(synthetic_constants(cfg, seed=SEED), dev)
        if dtype == torch.float32:
            tree = canon_lora_tree(cut) if lora else cut
            b = far_targets(batch, tc) if lora else batch
            *train_refs[label], sec = canon_grads(cfg, tree, b, tc, dev)
            del tree, b
            walls[f"13d train {label}"] = [sec]
            continue
        w = []
        train_refs[label] = train_steps(cfg, cut, dtype, batch, tc, dev,
                                        on_step=lambda i, sec, p: w.append(
                                            sec))
        walls[f"13d train {label}"] = w
    torch.cuda.synchronize()
    print(f"single-device references: {time.perf_counter() - t0:.2f} s; "
          f"walls {({k: v if isinstance(v, list) else round(v, 3) for k, v in walls.items()})} "
          f"({smi})", flush=True)
    del params32, consts_dev, batch, u, s, bu, bs, tu, ts, g, tc
    torch.cuda.empty_cache()

    print(f"this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB of the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
          f"reserved) while the world runs")
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    cli_root = os.path.join(tmp, "canon_cli")
    cli_runs = [("lora_tune", train_cli_argv(
        cli_root, "lora_element", (), CANON_CLI_MESH, CANON_CLI_BATCH))]
    t0 = time.perf_counter()
    try:
        ranks = launch.run(canon_rank, WORLD, path, cli_runs, device="cuda",
                           timeout_s=CANON_WORLD_TIMEOUT_S)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    world_s = time.perf_counter() - t0
    out["world_s"] = world_s
    print(f"world of {WORLD} ranks: the whole world {world_s:.1f} s (spawn, "
          f"loads, {len(canon_served_runs())} served and "
          f"{len(canon_train_runs())} trained runs, {len(cli_runs)} command "
          f"line) ({smi})")
    r0 = ranks[0]

    def by_op_line(by_op):
        return ", ".join(f"{k} {v[0]} x {v[1] / 2 ** 20:.1f} MiB"
                         for k, v in sorted(by_op.items())) or "none"

    for label, cfg, dtype, kind, shape, want_counts in canon_served_runs():
        digests = {r["served"][label]["digest"] for r in ranks}
        if len(digests) != 1:
            raise AssertionError(f"{label}: the ranks' results differ")
        got, want = r0["served"][label]["result"], refs.pop(label)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        rel = max(e[1] for e in errs)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"{label} mesh {shape} vs one device ({len(got)} tensors): "
              f"max_abs_err {max(e[0] for e in errs):.3e} rel {rel:.3e} (tol "
              f"{CANON_TOL[dtype]:.0e}) "
              f"{'bit-equal' if same else 'not bit-equal'}; one device "
              f"{walls[label]:.3f} s ({smi})", flush=True)
        if rel > CANON_TOL[dtype]:
            raise AssertionError(f"{label}: rel err {rel:.3e}")
        for r in ranks:
            rec = r["served"][label]
            counts = rec["counts"]
            print(f"  rank {r['rank']} {rec['coords']}: launches "
                  f"{ {k: v for k, v in counts.items() if v} }; exchanges "
                  f"{by_op_line(rec['by_op'])}; wall {rec['s']:.3f} s; peak "
                  f"{rec['peak_gib']:.2f} GiB ({smi})")
            if counts != {**{k: 0 for k in counts}, **want_counts}:
                raise AssertionError(f"rank {r['rank']} {label}: launches "
                                     f"{counts}, want {want_counts}")
            if (rec["by_op"] != {}) != (shape == CANON_MESH):
                raise AssertionError(f"rank {r['rank']} {label}: exchanges "
                                     f"{rec['by_op']}")
        path_counts[f"canonical {label}"] = {
            k: sum(r["served"][label]["counts"][k] for r in ranks)
            for k in r0["served"][label]["counts"]}
        out[label] = {"rel": rel, "bit_equal": same,
                      "s": [r["served"][label]["s"] for r in ranks],
                      "one_device_s": walls[label],
                      "by_op": r0["served"][label]["by_op"],
                      "peak_gib": [r["served"][label]["peak_gib"]
                                   for r in ranks]}

    for label, cfg, dtype, lora, step_counts in canon_train_runs():
        name = (f"13d {'' if lora else 'v2 '}train mesh {CANON_TRAIN_MESH} "
                f"batch {CANON_TRAIN_BATCH} depths {CANON_TRAIN_DEPTHS} "
                f"{label}")
        got = r0["train"][label]
        want_losses, want_grads = train_refs[label.replace(" again", "")]
        if not all(math.isfinite(v) for v in got["losses"]):
            raise AssertionError(f"{name}: losses {got['losses']}")
        lrel = max(abs(a - w) / abs(w)
                   for a, w in zip(got["losses"], want_losses))
        line = (f"{name}: losses {got['losses']} vs one device "
                f"{want_losses} (rel {lrel:.3e}, tol "
                f"{TRAIN_LOSS_TOL[dtype]:.0e})")
        if lrel > TRAIN_LOSS_TOL[dtype]:
            raise AssertionError(line)
        if dtype == torch.float32:
            errs = tree_errs(got["grads"], want_grads)
            worst = max(errs, key=lambda e: e[2])
            line += (f"; step-1 gradient ({len(errs)} leaves) worst "
                     f"{worst[0]} rel {worst[2]:.3e} (tol "
                     f"{CANON_GRAD_TOL:.0e})")
            if lora:            # the leaves the masks feed directly
                fed = [e for e in errs if "/lora_" in e[0]]
                line += (f", of the {len(fed)} LoRA leaves "
                         f"{max(fed, key=lambda e: e[2])[0]} rel "
                         f"{max(e[2] for e in fed):.3e}; targets "
                         f"1000 std below the means (far_targets)")
            if worst[2] > CANON_GRAD_TOL:
                raise AssertionError(line)
        print(line, flush=True)
        for i in range(CANON_STEPS if dtype == torch.bfloat16 else 1):
            digests = {r["train"][label]["steps"][i]["digest"]
                       for r in ranks}
            if label == "bf16 again":
                digests.add(r0["train"]["bf16"]["steps"][i]["digest"])
            if len(digests) != 1:
                raise AssertionError(f"{name} step {i}: the params (float32: "
                                     f"the gradient) differ across ranks or "
                                     f"runs")
        print(f"  {'params' if dtype == torch.bfloat16 else 'the gradient'} "
              f"bit-equal across the {WORLD} ranks"
              + (" after each step" if dtype == torch.bfloat16 else "")
              + (" and equal to the first bf16 run's"
                 if label == "bf16 again" else ""))
        total = {}
        for r in ranks:
            for i, st in enumerate(r["train"][label]["steps"]):
                counts = st["counts"]
                print(f"  rank {r['rank']} {r['train'][label]['coords']} "
                      f"{'step ' + str(i) if dtype == torch.bfloat16 else 'gradient'}: launches "
                      f"{ {k: v for k, v in counts.items() if v} }; "
                      f"exchanges {by_op_line(st['by_op'])}; wall "
                      f"{st['s']:.3f} s; peak {st['peak_gib']:.2f} GiB "
                      f"({smi})")
                if counts != {**{k: 0 for k in counts}, **step_counts}:
                    raise AssertionError(f"rank {r['rank']} {name} step {i}: "
                                         f"launches {counts}")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
        path_counts[f"canonical {name}"] = total
        out[name] = {"loss_rel": lrel,
                     "s": [st["s"] for r in ranks
                           for st in r["train"][label]["steps"]],
                     "one_device_s": walls.get(f"13d train {label}"),
                     "by_op_step0": r0["train"][label]["steps"][0]["by_op"]}

    # 13d: cli.lora_tune with its default element-mode dropout in the world
    from pangu_tpu_torch.config import DataConfig
    if sorted(os.listdir(cli_root)) != ["rank0"]:
        raise AssertionError(f"13d: ranks other than 0 wrote: "
                             f"{sorted(os.listdir(cli_root))}")
    active = ranks[:math.prod(CANON_CLI_MESH)]
    if any(r["cli"][0]["counts"]["block_wm"] for r in ranks[len(active):]):
        raise AssertionError("13d: an idle rank launched a kernel")
    runs = [r["cli"][0] for r in active]
    run_dir = os.path.join(cli_root, "rank0", "lora_element",
                           str(DataConfig().horizon))
    models = set(os.listdir(os.path.join(run_dir, "models")))
    csvs = os.listdir(os.path.join(run_dir, "test", "csv"))
    with open(os.path.join(run_dir, "lora_element.log")) as f:
        log = f.read()
    vals = {tuple(r["val_loss"][0]) for r in runs}
    val = runs[0]["val_loss"][0]
    print(f"cli.lora_tune (element-mode dropout) in the world, mesh "
          f"{CANON_CLI_MESH} batch {CANON_CLI_BATCH} depths "
          f"{TRAIN_CLI_DEPTHS} bf16 (ranks {len(active)}-{WORLD - 1} idle): "
          f"return codes {[r['cli'][0]['rc'] for r in ranks]}; rank 0 wrote "
          f"models {sorted(models)}, {len(csvs)} test CSVs; "
          f"validation losses {val} on every rank {len(vals) == 1}; wall "
          f"{runs[0]['s']:.1f} s ({smi})", flush=True)
    n_cli = sum(TRAIN_CLI_DEPTHS)
    for r in active:
        c = r["cli"][0]["counts"]
        print(f"  rank {r['rank']}: launches "
              f"{ {k: v for k, v in c.items() if v} }")
        # training runs the plain per-block layers (LoRA in every block);
        # each served forward merges and runs the window-major trunk
        if (c["block_wm"] + c["block_wm_group"] != TRAIN_CLI_SERVED * n_cli
                or c["block_bwd"] or c["block_v2"]
                or any(c[k] for k in EDGE_KERNELS)):
            raise AssertionError(f"13d lora_tune rank {r['rank']}: "
                                 f"launches {c}")
    if (any(r["cli"][0]["rc"] != 0 for r in ranks) or len(vals) != 1 or not val
            or not all(math.isfinite(v) for v in val)
            or not {"best.pt", "lora_adapter", "merged"} <= models
            or len(csvs) != 12 or "mode=element" not in log):
        raise AssertionError(f"13d lora_tune: codes {[r['rc'] for r in runs]}"
                             f", val losses {vals}, models {models}, "
                             f"{len(csvs)} CSVs")
    path_counts["canonical cli.lora_tune element"] = {
        k: sum(r["cli"][0]["counts"][k] for r in active)
        for k in runs[0]["counts"]}
    out["cli.lora_tune element"] = {"val_loss": val,
                                    "s": [r["s"] for r in runs]}
    del ranks
    torch.cuda.empty_cache()
    return out

if __name__ == "__main__":
    sys.exit(main())

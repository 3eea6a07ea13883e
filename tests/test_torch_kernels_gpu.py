"""The port's CUDA kernels against their plain PyTorch versions on the card,
at TINY and MID widths (head dims 8 and 12, channel counts that are not
multiples of the GEMM tiles, batch 2), float32 and bf16, every shift a stage
chain uses; the edge kernels (embed, transition, recovery upper and surface)
at the stage-end offsets (0, 0, 0) and (1, 3, 6); the grouped block (MID
stage 1 has nlat 6: three groups of 2), the canonical end-point blocks and
the canonical DownSample / UpSample; the canonical stage, ``forward(taps=)``
and the hierarchical rollout; a batch of 8 at full width, which passes
the 65,535 row tiles that a grid's y dimension can hold; and the training
kernels: the block with per-sample branch scales (scales of 1 bit-equal to
the served block), the block backward (every gradient, and bit-identical in
two runs), the upper embed weight gradient, the recovery backward, and the
float32 train step's loss (1e-4 relative) and gradients (1e-3 of each
leaf's max) against the plain path; and the ``block_layout="v2"`` kernels:
the grid block at the three shifts a v2 stage uses, with and without
branch scales, the grid attention (with and without region ids) and its
backward (every gradient, bit-identical in two runs), the v2 forward (1e-3,
against plain versions and the wm forward), the v2 rollouts' launch counts
and the float32 v2 train step against the plain path; and the per-block
path: the no-roll block and the block tail, the windowed sdpa and its
backward (with and without the folded mask, each bit-identical in two runs;
and on random inputs at N = 37, 100, 120, 144, 200 and 256 with head dims
8 to 72, and the bf16 refusal of N above 256 and of tiles beyond shared
memory), the served forward with
adapters on each stage's first block (against plain versions and the
merged forward) and the float32 per-block train step under both grid
attention backwards (against plain versions and the fused step); the fused
window attention forward and every gradient of its drop-in, the block
backward with canonical ends, the grouped block with branch scales, the
float32 train step through the canonical stage Function (adapters at
Down/UpSample only) and ``attn_impl="xla"`` (no kernel launched); and the
bf16 tensor-core route of the block forward, the block backward (both
layouts) and the grid attention forward and backward at a row count that
is not a multiple of the 128-row product tile and at C = 384, with float32
and bf16 bias tables, bit-identical in two runs (the grouped block equal
to the ungrouped one, one launch plan in bf16); and the bf16 tensor-core
route of the block tail (both GELU forms, a row count off the 128-row
tile, bit-identical in two runs, ValueError for C or hidden not a
multiple of 8) and of the recovery backward (its relayout pass equal to
``field_cotangent_wm``, bit-identical in two runs and with finite junk on
the pair's pad rows); and the window-major DownSample and UpSample (junk
on their input's latitude-pad rows leaves the output unchanged, the
output's pad rows zeros, a batch-2 sample equal to it run alone, bf16
bit-identical in two runs, ValueError for bf16 channels not a multiple of
8); and the transition, the recovery (both branches) and the embed
(each sample of a batch of 2 equal to it run alone, junk on the pair's
latitude-pad rows leaving the outputs unchanged, bf16 bit-identical in two
runs; ValueError for a bf16 C not a multiple of 8, all four running on the
tensor cores in bf16); and the bf16 tensor-core routes of the upper embed
weight gradient (bit-identical in two runs, blind to junk on the
cotangent's token-lat pad rows and plane-0 rows) and of the canonical
UpSample (odd and even ``out_h``, bit-identical in two runs, a batch-2
sample equal to it run alone), each refusing a bf16 C not a multiple of 8
with ValueError; and the bf16 tensor-core routes of the canonical
DownSample (odd and even latitude counts, bit-identical in two runs, the
last sample of a batch of 8 bit-equal to it run alone, bit-equal to the
window-major DownSample on the same tokens, which runs the same two
kernels) and of the fused window attention (with and without the folded
mask, bit-identical in two runs, each sample of a batch of 2 bit-equal to
it run alone), each refusing what its tiles do not take with ValueError,
and the float32 outputs of both equal to their first versions' and the
bf16 window-major DownSample's equal to its output before the shared
kernel (a digest of each output recorded from the earlier kernels).
Needs a CUDA
device and nvcc: marked ``gpu``, skipped elsewhere.  Run on the card with
``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

Error measure: max |kernel - plain| / max |plain|.  Tolerances: 1e-4 in
float32 (reassociation of float32 sums, amplified by the LayerNorms), 2**-6
in bf16 (a few bf16 ulps: a value that rounds one way in one version and the
other way in the other moves by an ulp and the difference propagates)."""

import dataclasses

import pytest
import torch

from pangu_tpu_torch.config import MID, PANGU_24, TINY, _pick_gh
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.engine.rollout import (make_hierarchical_rollout,
                                            make_rollout)
from pangu_tpu_torch.engine.transition_wm import (apply_transition_wm,
                                                  apply_transition_wm_plain,
                                                  build_transition_wm)
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_canon,
                                                block_wm_canon_plain,
                                                block_wm_group, block_wm_plain,
                                                from_window_major,
                                                pad_rows_zeroed, run_stage_wm,
                                                to_window_major)
from pangu_tpu_torch.ops.embed_wm import embed_wm, embed_wm_plain
from pangu_tpu_torch.ops.recovery_wm import (recovery_wm_surface,
                                             recovery_wm_surface_plain,
                                             recovery_wm_upper,
                                             recovery_wm_upper_plain)
from pangu_tpu_torch.ops.updown import (down_sample, down_sample_plain,
                                        up_sample, up_sample_plain)
from pangu_tpu_torch.ops.updown_wm import (down_sample_wm,
                                           down_sample_wm_plain, up_sample_wm,
                                           up_sample_wm_plain)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
CFGS = {"TINY": TINY, "MID": MID}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _params(cfg, dev):
    return pangu.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)


def _storage(geom, dev, dtype, seed=1, batch=2):
    wz, wh, ww = geom.window
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, geom.z // wz, geom.h_padded // wh, geom.w // ww,
             wz * wh * ww, geom.dim)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("delta,canon_add,shifted", [
    ((0, 0, 0), 0, False), ((1, 3, 6), 3, True), ((-1, -3, -6), 0, False)])
def test_block_wm_kernel_matches_plain(cuda, cfg_name, stage, dtype, delta,
                                       canon_add, shifted):
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][0]
    xs = _storage(geom, cuda, dtype)
    ids = None
    if shifted:
        ids = torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                                geom.window), device=cuda)
    for tanh in (False, True):
        got = block_wm(bp, xs, geom, delta, canon_add, ids, tanh)
        want = block_wm_plain(bp, xs, geom, delta, canon_add, ids, tanh)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= TOL[dtype]


def _pad_junk(xs, geom, off):
    """Rolled storage xs with 50x its values on its latitude-pad rows
    (storage latitude s holds canonical (s + off_lat) % hp), the rest
    unchanged bit for bit."""
    grid = from_window_major(xs, geom.window)
    kept = pad_rows_zeroed(grid, geom, off[1])
    return to_window_major(kept + 50 * (grid - kept),
                           geom.window).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_updown_wm_kernels_match_plain(cuda, cfg_name, dtype, off):
    """DownSample and UpSample against their plain versions; junk on the
    input's latitude-pad rows leaves the output unchanged, the output's
    pad rows are zeros, sample 1 of the batch equals it run alone, and a
    bf16 output is bit-identical in two runs."""
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    g0, g1, g2, g3 = (cfg.stage(i) for i in range(4))
    for fn, plain, p, gin, gout in (
            (down_sample_wm, down_sample_wm_plain, params["downsample"], g0,
             g1),
            (up_sample_wm, up_sample_wm_plain, params["upsample"], g2, g3)):
        xs = _storage(gin, cuda, dtype)
        got = fn(p, xs, gin, gout, off)
        want = plain(p, xs, gin, gout, off)
        junk = fn(p, _pad_junk(xs, gin, off), gin, gout, off)
        alone = fn(p, xs[1:].contiguous(), gin, gout, off)
        again = fn(p, xs, gin, gout, off)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]
        assert torch.equal(junk, got)
        assert not from_window_major(got, gout.window)[:, :, gout.h:].any()
        assert torch.equal(alone[0], got[1])
        if dtype == torch.bfloat16:
            assert torch.equal(again, got)


@pytest.mark.parametrize("which", ["down", "up"])
def test_updown_wm_bf16_refuses_shapes_outside_the_tiles(cuda, which):
    """A bf16 DownSample or UpSample whose channels are not multiples of
    8 raises ValueError before a launch (no fallback)."""
    cfg = dataclasses.replace(TINY, dims=(20, 40, 40, 20))
    params = pangu.init_params(torch.Generator(device=cuda).manual_seed(0),
                               cfg, device=cuda)
    fn, gin, gout = ((down_sample_wm, cfg.stage(0), cfg.stage(1))
                     if which == "down" else
                     (up_sample_wm, cfg.stage(2), cfg.stage(3)))
    xs = _storage(gin, cuda, torch.bfloat16)
    before = fn.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        fn(params[f"{which}sample"], xs, gin, gout, (0, 0, 0))
    assert fn.launches == before


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_forward_kernels_match_plain(cuda, cfg_name):
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    consts = synthetic_constants(cfg)
    g = torch.Generator(device=cuda).manual_seed(2)
    upper = torch.randn((1, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                        device=cuda)
    surface = torch.randn((1, 4, cfg.lat, cfg.lon), generator=g, device=cuda)
    got = pangu.forward(params, upper, surface, consts, cfg, device=cuda)
    want = pangu.forward(params, upper, surface, consts, cfg, device=cuda,
                         kernels=False)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= TOL[torch.float32]


def _state(cfg, dev, seed=3, batch=2):
    consts = to_device(synthetic_constants(cfg), dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    upper = consts["upper_mean"][None] + consts["upper_std"][None] * torch.randn(
        (batch, 5, cfg.levels, cfg.lat, cfg.lon), generator=g, device=dev)
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * torch.randn((batch, 4, cfg.lat, cfg.lon), generator=g,
                             device=dev))
    return consts, upper, surface


def _in_dtype(cfg, dtype):
    return dataclasses.replace(
        cfg, compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_embed_wm_kernel_matches_plain(cuda, cfg_name, dtype):
    """The embed against its plain version; each sample of the batch of 2
    equal bit for bit to it run alone, and a bf16 output bit-identical in
    two runs."""
    cfg = _in_dtype(CFGS[cfg_name], dtype)
    p = _params(cfg, cuda)["patch_embed"]
    consts, upper, surface = _state(cfg, cuda)
    got = embed_wm(p, upper, surface, consts, cfg)
    want = embed_wm_plain(p, upper, surface, consts, cfg)
    alone = [embed_wm(p, upper[i:i + 1], surface[i:i + 1], consts, cfg)
             for i in range(2)]
    again = embed_wm(p, upper, surface, consts, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]
    assert all(torch.equal(a[0], got[i]) for i, a in enumerate(alone))
    if dtype == torch.bfloat16:
        assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_transition_and_recovery_kernels_match_plain(cuda, cfg_name, dtype,
                                                     off):
    """The transition and both recovery branches against their plain
    versions; each sample of the batch of 2 equal bit for bit to it run
    alone, 50x junk on the pair's latitude-pad rows (never read) leaves the
    outputs bit-equal, and a bf16 output is bit-identical in two runs."""
    cfg = _in_dtype(CFGS[cfg_name], dtype)
    params = _params(cfg, cuda)
    g0 = cfg.stage(0)
    skip, dec = _storage(g0, cuda, dtype, seed=4), _storage(g0, cuda, dtype, seed=5)
    junk = (_pad_junk(skip, g0, off), _pad_junk(dec, g0, off))
    assert not torch.equal(junk[0], skip)
    tp = build_transition_wm(params, to_device(synthetic_constants(cfg), cuda),
                             cfg)
    pr = params["patch_recovery"]
    for kern, plain in (
            (lambda a, b: apply_transition_wm(tp, a, b, g0, off),
             lambda a, b: apply_transition_wm_plain(tp, a, b, g0, off)),
            (lambda a, b: recovery_wm_upper(pr, a, b, off, cfg),
             lambda a, b: recovery_wm_upper_plain(pr, a, b, off, cfg)),
            (lambda a, b: recovery_wm_surface(pr, a, b, off, cfg),
             lambda a, b: recovery_wm_surface_plain(pr, a, b, off, cfg))):
        got = kern(skip, dec)
        want = plain(skip, dec)
        alone = [kern(skip[i:i + 1].contiguous(), dec[i:i + 1].contiguous())
                 for i in range(2)]
        with_junk = kern(*junk)
        again = kern(skip, dec)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= TOL[dtype]  # transition pad rows: zeros
        assert all(torch.equal(a[0], got[i]) for i, a in enumerate(alone))
        assert torch.equal(with_junk, got)
        if dtype == torch.bfloat16:
            assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (0, 3, 6)])
def test_transition_z_shards_match_plain_and_the_whole_pair(cuda, cfg_name,
                                                            dtype, off):
    """Row 5z: the transition on each tp = 2 z shard (``z_base``,
    ``nz_global``; the shard's slice of the bias field, not contiguous
    where it is also a longitude shard) against its plain version, and the
    shards put together bit-equal to the transition of the whole pair; at
    off (0, 0, 0) also tp 2 x sp 2 shards.  Counted in ``z_launches``."""
    cfg = _in_dtype(CFGS[cfg_name], dtype)
    g0 = cfg.stage(0)
    nz, nlon = g0.z // g0.window[0], g0.w // g0.window[2]
    skip, dec = _storage(g0, cuda, dtype, seed=6), _storage(g0, cuda, dtype,
                                                            seed=7)
    tp = build_transition_wm(_params(cfg, cuda),
                             to_device(synthetic_constants(cfg), cuda), cfg)
    whole = apply_transition_wm(tp, skip, dec, g0, off)
    for spn in (1, 2) if off[2] == 0 else (1,):
        nzl, nll = nz // 2, nlon // spn
        planes = []
        for zi in range(2):
            row = []
            for li in range(spn):
                sl = (slice(None), slice(zi * nzl, (zi + 1) * nzl),
                      slice(None), slice(li * nll, (li + 1) * nll))
                loc = {**tp, "bias_field_wm": tp["bias_field_wm"][sl]}
                a, b = skip[sl].contiguous(), dec[sl].contiguous()
                before = apply_transition_wm.z_launches
                got = apply_transition_wm(loc, a, b, g0, off, z_base=zi * nzl,
                                          nz_global=nz)
                want = apply_transition_wm_plain(loc, a, b, g0, off,
                                                 z_base=zi * nzl, nz_global=nz)
                assert apply_transition_wm.z_launches == before + 1
                assert _rel_err(got, want) <= TOL[dtype]
                row.append(got)
            planes.append(torch.cat(row, dim=3))
        assert torch.equal(torch.cat(planes, dim=1), whole)


@pytest.mark.parametrize("which", ["transition", "recovery_upper",
                                   "recovery_surface", "embed"])
def test_edge_bf16_refuses_shapes_outside_the_tiles(cuda, which):
    """A bf16 transition, recovery (either branch) or embed whose C is not
    a multiple of 8 raises ValueError before a launch (no fallback)."""
    cfg = _in_dtype(dataclasses.replace(TINY, dims=(20, 40, 40, 20)),
                    torch.bfloat16)
    params = _params(cfg, cuda)
    g0 = cfg.stage(0)
    skip, dec = (_storage(g0, cuda, torch.bfloat16, seed=s) for s in (4, 5))
    if which == "transition":
        tp = build_transition_wm(
            params, to_device(synthetic_constants(cfg), cuda), cfg)
        fn = apply_transition_wm
        call = lambda: fn(tp, skip, dec, g0, (0, 0, 0))  # noqa: E731
    elif which == "embed":
        consts, upper, surface = _state(cfg, cuda)
        fn = embed_wm
        call = lambda: fn(params["patch_embed"], upper,  # noqa: E731
                          surface, consts, cfg)
    else:
        fn = (recovery_wm_upper if which == "recovery_upper"
              else recovery_wm_surface)
        call = lambda: fn(params["patch_recovery"], skip, dec,  # noqa: E731
                          (0, 0, 0), cfg)
    before = fn.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_token_space_rollout_kernels_match_plain(cuda, cfg_name):
    """Edge forward and a 2-step token-space rollout, float32, kernels
    against plain versions on the card; the rollout's final state also
    against the full-step rollout."""
    cfg = dataclasses.replace(CFGS[cfg_name], edge_kernels=True)
    params = _params(cfg, cuda)
    consts, upper, surface = _state(cfg, cuda, batch=1)
    got = pangu.forward(params, upper, surface, consts, cfg, device=cuda)
    want = pangu.forward(params, upper, surface, consts, cfg, device=cuda,
                         kernels=False)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= TOL[torch.float32]
    runs = [make_rollout(c, consts, 2, token_space=t, device=cuda, kernels=k)(
                params, upper, surface)
            for c, t, k in ((cfg, True, True), (cfg, True, False),
                            (CFGS[cfg_name], False, True))]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.isfinite(a).all()
            assert _rel_err(a, b) <= 1e-3


def _ids(geom, dev):
    return torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                             geom.window), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("delta,canon_add,shifted", [
    ((0, 0, 0), 0, False), ((1, 3, 6), 3, True), ((-1, -3, -6), 0, False)])
def test_block_wm_group_kernel_matches_plain(cuda, cfg_name, dtype, delta,
                                             canon_add, shifted):
    cfg = CFGS[cfg_name]
    geom = cfg.stage(1)
    gh = _pick_gh(geom.h_padded // geom.window[1], 2)
    assert gh == 2
    bp = _params(cfg, cuda)["stages"][1]["blocks"][0]
    xs = _storage(geom, cuda, dtype)
    ids = _ids(geom, cuda) if shifted else None
    got = block_wm_group(bp, xs, geom, delta, canon_add, ids, True, gh)
    want = block_wm_plain(bp, xs, geom, delta, canon_add, ids, True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("in_layout,out_layout,delta,canon_add,shifted", [
    ("canon", "wm", (0, 0, 0), 0, False),
    ("wm", "canon", (1, 3, 6), 3, True),
    ("wm", "canon", (0, 0, 0), 0, False),
    ("canon", "canon", (0, 0, 0), 0, False)])
def test_block_wm_canon_kernel_matches_plain(cuda, cfg_name, stage, dtype,
                                             in_layout, out_layout, delta,
                                             canon_add, shifted):
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][0]
    x = _storage(geom, cuda, dtype)
    if in_layout == "canon":
        x = torch.randn((2, geom.z, geom.h_padded, geom.w, geom.dim),
                        device=cuda).to(dtype)
    ids = _ids(geom, cuda) if shifted else None
    got = block_wm_canon(bp, x, geom, delta, canon_add, ids, True,
                         in_layout=in_layout, out_layout=out_layout)
    want = block_wm_canon_plain(bp, x, geom, delta, canon_add, ids, True,
                                in_layout, out_layout)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_canonical_updown_kernels_match_plain(cuda, cfg_name, dtype):
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    g0, g2 = cfg.stage(0), cfg.stage(2)
    x = torch.randn((2, g0.z, g0.h, g0.w, g0.dim), device=cuda).to(dtype)
    got = down_sample(params["downsample"], x)
    want = down_sample_plain(params["downsample"], x)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]
    x = torch.randn((2, g2.z, g2.h, g2.w, g2.dim), device=cuda).to(dtype)
    got = up_sample(params["upsample"], x, cfg.h_tokens)
    want = up_sample_plain(params["upsample"], x, cfg.h_tokens)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_canon_stage_and_taps_forward_match_plain(cuda, cfg_name):
    """The canonical stage chain at lat_group 2 and the whole ``forward``
    with taps, float32, kernels against plain versions; the taps output
    also against the window-major forward."""
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    geom = cfg.stage(1)
    x = torch.randn((1, geom.z, geom.h, geom.w, geom.dim), device=cuda)
    stage = {"blocks": params["stages"][1]["blocks"] * 2}
    got = run_stage_wm(stage, x, geom, io_layout="canon", lat_group=2)
    want = run_stage_wm(stage, x, geom, io_layout="canon", kernels=False)
    assert _rel_err(got, want) <= TOL[torch.float32]
    consts, upper, surface = _state(cfg, cuda, batch=1)
    taps, plain_taps = {}, {}
    got = pangu.forward(params, upper, surface, consts, cfg, device=cuda,
                        taps=taps)
    want = pangu.forward(params, upper, surface, consts, cfg, device=cuda,
                         taps=plain_taps, kernels=False)
    wm = pangu.forward(params, upper, surface, consts, cfg, device=cuda)
    for a, b, c in zip(got, want, wm):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= 1e-3
        assert _rel_err(a, c) <= 1e-3
    for name, t in plain_taps.items():
        assert _rel_err(taps[name], t) <= 1e-3, name


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_hierarchical_rollout_kernels_match_plain(cuda, cfg_name):
    cfg = dataclasses.replace(CFGS[cfg_name], edge_kernels=True)
    pa = _params(cfg, cuda)
    pb = pangu.init_params(torch.Generator(device=cuda).manual_seed(1), cfg,
                           device=cuda)
    consts, upper, surface = _state(cfg, cuda, batch=1)
    runs = [make_hierarchical_rollout(cfg, consts, 54, (24, 6), token_space=t,
                                      device=cuda, kernels=k)[0](
                {24: pa, 6: pb}, upper, surface)
            for t, k in ((True, True), (True, False), (False, True))]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.isfinite(a).all()
            assert _rel_err(a, b) <= 1e-3


def _bf16_batch8_case(dev):
    cfg = dataclasses.replace(PANGU_24, param_dtype="bfloat16",
                              compute_dtype="bfloat16", gelu="tanh")
    gen = torch.Generator(device=dev).manual_seed(0)
    g0, g2, g3 = cfg.stage(0), cfg.stage(2), cfg.stage(3)

    def dense(i, o):
        return {"kernel": (0.02 * torch.randn((i, o), generator=gen,
                                              device=dev)).bfloat16()}

    def norm(c):
        return {"scale": torch.ones(c, device=dev).bfloat16(),
                "bias": torch.zeros(c, device=dev).bfloat16()}

    c = g0.dim
    bp = {"norm1": norm(c), "norm2": norm(c),
          "attn": {"qkv": {**dense(c, 3 * c),
                           "bias": torch.zeros(3 * c, device=dev).bfloat16()},
                   "proj": {**dense(c, c),
                            "bias": torch.zeros(c, device=dev).bfloat16()},
                   "bias_table": (0.02 * torch.randn(
                       (g0.num_window_types, g0.heads, 144, 144),
                       generator=gen, device=dev)).bfloat16()},
          "mlp": {"fc1": {**dense(c, 4 * c),
                          "bias": torch.zeros(4 * c, device=dev).bfloat16()},
                  "fc2": {**dense(4 * c, c),
                          "bias": torch.zeros(c, device=dev).bfloat16()}}}
    up = {"expand": dense(g2.dim, 4 * g3.dim), "norm": norm(g3.dim),
          "mix": dense(g3.dim, g3.dim)}
    return cfg, bp, up, gen


def test_batch8_full_width_matches_batch1(cuda):
    """Batch 8 at stage 0 gives 8 x 535,680 / 64 = 66,960 row tiles per
    GEMM: sample 7 of the batch-8 stage-0 block and UpSample equals the
    batch-1 launch on that sample (bit for bit, or within the bf16 gate)."""
    cfg, bp, up, gen = _bf16_batch8_case(cuda)
    g0, g2, g3 = cfg.stage(0), cfg.stage(2), cfg.stage(3)
    xs = torch.randn((8,) + _storage(g0, cuda, torch.bfloat16,
                                     batch=1).shape[1:],
                     generator=gen, device=cuda).bfloat16()
    ids = _ids(g0, cuda)
    got = block_wm(bp, xs, g0, (1, 3, 6), 3, ids, True)[7]
    want = block_wm(bp, xs[7:].contiguous(), g0, (1, 3, 6), 3, ids, True)[0]
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= TOL[torch.bfloat16]
    del got, want, xs
    x2 = torch.randn((8,) + _storage(g2, cuda, torch.bfloat16,
                                     batch=1).shape[1:],
                     generator=gen, device=cuda).bfloat16()
    got = up_sample_wm(up, x2, g2, g3, (1, 3, 6))[7]
    want = up_sample_wm(up, x2[7:].contiguous(), g2, g3, (1, 3, 6))[0]
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# Training kernels: the block with branch scales, the block backward, the
# upper embed weight gradient and the recovery backward
# ---------------------------------------------------------------------------

def _drop(batch, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    vals = torch.tensor([0.0, 0.8, 1.25])
    return vals[torch.randint(0, 3, (batch, 2), generator=g)].to(dev)


def _tree_rel_errs(got, want, path=""):
    if isinstance(want, dict):
        out = []
        for k in want:
            out += _tree_rel_errs(got[k], want[k], f"{path}/{k}")
        return out
    return [(path, _rel_err(got, want))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_block_wm_drop_kernel_matches_plain(cuda, cfg_name, stage, dtype):
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][1]
    xs = _storage(geom, cuda, dtype)
    ids = torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                            geom.window), device=cuda)
    drop = _drop(xs.shape[0], cuda)
    for tanh in (False, True):
        got = block_wm(bp, xs, geom, (1, 3, 6), 3, ids, tanh, drop)
        want = block_wm_plain(bp, xs, geom, (1, 3, 6), 3, ids, tanh, drop)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_wm_unit_scales_bit_equal_to_served_block(cuda, dtype):
    """Scales of 1 leave every value as the served block (drop=None) has
    it: the scale path adds no rounding of its own."""
    geom = MID.stage(0)
    bp = _params(MID, cuda)["stages"][0]["blocks"][1]
    xs = _storage(geom, cuda, dtype)
    ids = torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                            geom.window), device=cuda)
    served = block_wm(bp, xs, geom, (1, 3, 6), 3, ids, True)
    ones = block_wm(bp, xs, geom, (1, 3, 6), 3, ids, True,
                    torch.ones(xs.shape[0], 2, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(served, ones)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("shifted", [False, True])
def test_block_bwd_kernel_matches_plain(cuda, cfg_name, stage, dtype,
                                        shifted):
    from pangu_tpu_torch.ops.earth_block_bwd import block_bwd, block_bwd_plain
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][1]
    xs, g = _storage(geom, cuda, dtype, 1), _storage(geom, cuda, dtype, 2)
    drop = _drop(xs.shape[0], cuda)
    if shifted:
        args = ((1, 3, 6), (1, 3, 6), 3, torch.as_tensor(window_region_ids(
            geom.z, geom.h_padded, geom.window), device=cuda))
    else:
        args = ((-1, -3, -6), (0, 0, 0), 0, None)
    for tanh in (False, True):
        got = block_bwd(bp, xs, g, geom, *args, drop, tanh)
        want = block_bwd_plain(bp, xs, g, geom, *args, drop, tanh)
        torch.cuda.synchronize()
        errs = _tree_rel_errs({"dx": got[0], **got[1]},
                              {"dx": want[0], **want[1]})
        assert all(e <= TOL[dtype] for _, e in errs), errs
        again = block_bwd(bp, xs, g, geom, *args, drop, tanh)
        assert all(torch.equal(a, b) for a, b in zip(
            [got[0], *_leaves(got[1])], [again[0], *_leaves(again[1])]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _dw_inputs(cfg, dev, dtype):
    """(a stage-0 wm cotangent, the physical upper field, the constants) of
    the upper embed weight gradient at batch 2."""
    consts = to_device(synthetic_constants(cfg), dev)
    g = torch.Generator(device=dev).manual_seed(4)
    upper = (consts["upper_mean"][None] + consts["upper_std"][None]
             * torch.randn((2, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                           device=dev))
    return _storage(cfg.stage(0), dev, dtype, 5), upper, consts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_embed_dw_kernel_matches_plain(cuda, cfg_name, dtype):
    from pangu_tpu_torch.ops.embed_wm import (embed_dw_upper,
                                              embed_dw_upper_plain)
    cfg = CFGS[cfg_name]
    dxs, upper, consts = _dw_inputs(cfg, cuda, dtype)
    got = embed_dw_upper(dxs, upper, consts, cfg)
    want = embed_dw_upper_plain(dxs, upper, consts, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= TOL[dtype]


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_embed_dw_bf16_tensor_core_route(cuda, cfg_name):
    """The bf16 route of the upper embed weight gradient (a relayout into
    the patch matrix with its indicator column, one tensor-core product, a
    split sum) at batch 2: against the plain version, two runs bit for bit,
    and dK, db the same bit for bit with junk (50x) on the cotangent's
    token-lat pad rows and other values on its plane-0 rows, neither of
    which is summed."""
    from pangu_tpu_torch.ops.embed_wm import (embed_dw_upper,
                                              embed_dw_upper_plain)
    cfg = CFGS[cfg_name]
    g0 = cfg.stage(0)
    bf = torch.bfloat16
    dxs, upper, consts = _dw_inputs(cfg, cuda, bf)
    got = embed_dw_upper(dxs, upper, consts, cfg)
    want = embed_dw_upper_plain(dxs, upper, consts, cfg)
    torch.cuda.synchronize()
    assert all(_rel_err(a, b) <= TOL[bf] for a, b in zip(got, want))
    assert g0.h < g0.h_padded
    grid = from_window_major(dxs, g0.window).clone()
    grid[:, :, g0.h:] = 50 * grid[:, :, g0.h:] + 7
    grid[:, 0] = -3 * grid[:, 0] + 1
    junk = to_window_major(grid, g0.window).contiguous()
    for again in (embed_dw_upper(dxs, upper, consts, cfg),
                  embed_dw_upper(junk, upper, consts, cfg)):
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_embed_dw_bf16_refuses_shapes_outside_the_tiles(cuda):
    from pangu_tpu_torch.ops.embed_wm import embed_dw_upper
    cfg = dataclasses.replace(TINY, dims=(20, 40, 40, 20))
    dxs, upper, consts = _dw_inputs(cfg, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        embed_dw_upper(dxs, upper, consts, cfg)


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_canonical_up_sample_bf16_tensor_core_route(cuda, cfg_name):
    """The bf16 canonical UpSample on the tensor cores at batch 2, cropped
    to an odd and an even latitude count: against the plain version,
    bit-identical in two runs, its second sample bit-equal to that sample
    run alone."""
    cfg = CFGS[cfg_name]
    p = _params(cfg, cuda)["upsample"]
    g2 = cfg.stage(2)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((2, g2.z, g2.h, g2.w, g2.dim), generator=g,
                    device=cuda).to(torch.bfloat16)
    for out_h in (2 * g2.h - 1, 2 * g2.h):
        got = up_sample(p, x, out_h)
        want = up_sample_plain(p, x, out_h)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert _rel_err(got, want) <= TOL[torch.bfloat16]
        assert torch.equal(got, up_sample(p, x, out_h))
        assert torch.equal(got[1], up_sample(p, x[1:].contiguous(), out_h)[0])


def test_canonical_up_sample_bf16_refuses_shapes_outside_the_tiles(cuda):
    cfg = dataclasses.replace(TINY, dims=(20, 40, 40, 20))
    g2 = cfg.stage(2)
    x = torch.randn((1, g2.z, g2.h, g2.w, g2.dim), device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        up_sample(_params(cfg, cuda)["upsample"], x.to(torch.bfloat16),
                  2 * g2.h - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_recovery_bwd_kernel_matches_plain(cuda, cfg_name, dtype, off):
    from pangu_tpu_torch.ops.recovery_wm import (recovery_bwd,
                                                 recovery_bwd_plain)
    cfg = CFGS[cfg_name]
    p = _params(cfg, cuda)["patch_recovery"]
    g3 = cfg.stage(3)
    skip, dec = _storage(g3, cuda, dtype, 6), _storage(g3, cuda, dtype, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    du = torch.randn((2, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                     device=cuda).to(dtype)
    ds = torch.randn((2, 4, cfg.lat, cfg.lon), generator=g,
                     device=cuda).to(dtype)
    got = recovery_bwd(p, skip, dec, du, ds, off, cfg)
    want = recovery_bwd_plain(p, skip, dec, du, ds, off, cfg)
    torch.cuda.synchronize()
    errs = _tree_rel_errs({"p": got[0], "skip": got[1], "dec": got[2]},
                          {"p": want[0], "skip": want[1], "dec": want[2]})
    assert all(e <= TOL[dtype] for _, e in errs), errs


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_recovery_bwd_bf16_tensor_core_route(cuda, cfg_name, off):
    """The bf16 route of the recovery backward at batch 2: its relayout pass
    equal to ``field_cotangent_wm``, two runs bit for bit, and every output
    the same bit for bit when the pair's latitude-pad rows hold finite junk
    instead of zeros (their cotangent rows are zero)."""
    from pangu_tpu_torch.ops.earth_block_wm import (from_window_major,
                                                    to_window_major)
    from pangu_tpu_torch.ops.recovery_wm import (field_cotangent_wm,
                                                 field_cotangent_wm_kernel,
                                                 recovery_bwd)
    cfg = CFGS[cfg_name]
    bf = torch.bfloat16
    p = _params(cfg, cuda)["patch_recovery"]
    g3 = cfg.stage(3)
    g = torch.Generator(device=cuda).manual_seed(8)
    du = torch.randn((2, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                     device=cuda).to(bf)
    ds = torch.randn((2, 4, cfg.lat, cfg.lon), generator=g,
                     device=cuda).to(bf)
    got = field_cotangent_wm_kernel(du, ds, off, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, field_cotangent_wm(du, ds, off, cfg))
    pad = ((torch.arange(g3.h_padded, device=cuda) + off[1])
           % g3.h_padded) >= g3.h

    def pair(seed, junk):
        grid = from_window_major(_storage(g3, cuda, bf, seed), g3.window)
        grid[:, :, pad] = (50 * grid[:, :, pad] + 7) if junk else 0
        return to_window_major(grid, g3.window).contiguous()

    runs = [recovery_bwd(p, pair(6, junk), pair(7, junk), du, ds, off, cfg)
            for junk in (False, True, True)]
    torch.cuda.synchronize()
    flat = [[t for t in (r[0]["upper"]["kernel"], r[0]["upper"]["bias"],
                         r[0]["surface"]["kernel"], r[0]["surface"]["bias"],
                         r[1], r[2])] for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(flat[1], flat[2]))
    assert all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))


@pytest.mark.parametrize("edge", [False, True])
def test_train_step_kernels_match_plain(cuda, edge):
    """The float32 train step's loss and every gradient, kernels against
    plain versions, with stochastic-depth scales drawn once and shared."""
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine.train import loss_and_grads
    cfg = dataclasses.replace(TINY, edge_kernels=edge)
    consts = to_device(synthetic_constants(cfg), cuda)
    g = torch.Generator(device=cuda).manual_seed(9)

    def field(*shape, mean, std):
        return mean[None] + std[None] * torch.randn(shape, generator=g,
                                                    device=cuda)

    batch = {k: field(2, v, *dims, mean=consts[f"{m}_mean"],
                      std=consts[f"{m}_std"])
             for k, v, dims, m in (
                 ("upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("surface", 4, (cfg.lat, cfg.lon), "surface"),
                 ("target_upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("target_surface", 4, (cfg.lat, cfg.lon), "surface"))}
    rates = cfg.drop_path_rates()
    gen = torch.Generator(device=cuda).manual_seed(10)
    drops = [pangu._stage_drops(cfg.depths[i], rates, sum(cfg.depths[:i]),
                                gen, 2) for i in range(4)]
    out = []
    for kernels in (True, False):
        params = _params(cfg, cuda)
        for t in _param_leaves(params):
            t.requires_grad_(True)
        out.append(loss_and_grads(params, batch, consts, cfg, TrainConfig(),
                                  device=cuda, kernels=kernels, drops=drops))
    (lk, _, gk), (lp, _, gp) = out
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    errs = _tree_rel_errs(_as_dict(gk), _as_dict(gp))
    assert all(e <= 1e-3 for _, e in errs), errs


def _param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _param_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _param_leaves(v)
    else:
        yield tree


def _as_dict(tree):
    if isinstance(tree, list):
        return {str(i): _as_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# block_layout="v2": the grid block (B10), the grid attention (B14) and its
# backward (B15)
# ---------------------------------------------------------------------------

def _grid(geom, dev, dtype, seed=1, batch=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, geom.z, geom.h_padded, geom.w, geom.dim)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _ids(geom, dev):
    return torch.as_tensor(window_region_ids(geom.z, geom.h_padded,
                                             geom.window), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("delta,canon_add,shifted", [
    ((0, 0, 0), 0, False), ((1, 3, 6), 3, True), ((-1, -3, -6), 0, False)])
@pytest.mark.parametrize("with_drop", [False, True])
def test_block_v2_kernel_matches_plain(cuda, cfg_name, stage, dtype, delta,
                                       canon_add, shifted, with_drop):
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][1]
    x = _grid(geom, cuda, dtype)
    ids = _ids(geom, cuda) if shifted else None
    drop = _drop(x.shape[0], cuda) if with_drop else None
    for tanh in (False, True):
        got = block_v2(bp, x, geom, delta, canon_add, ids, tanh, drop)
        want = block_v2_plain(bp, x, geom, delta, canon_add, ids, tanh, drop)
        torch.cuda.synchronize()
        assert got.shape == want.shape == x.shape and got.dtype == dtype
        assert _rel_err(got, want) <= TOL[dtype]


def _attn_args(bp):
    a = bp["attn"]
    return (a["qkv"]["kernel"], a["qkv"]["bias"], a["proj"]["kernel"],
            a["proj"]["bias"], a["bias_table"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("masked", [False, True])
def test_grid_attention_kernels_match_plain(cuda, cfg_name, stage, dtype,
                                            masked):
    """The forward, and every gradient of the backward (also bit-identical
    in two runs); random biases so that the bias gradients are not trivial."""
    from pangu_tpu_torch.ops.window_attention import (
        grid_attention, grid_attention_bwd, grid_attention_bwd_plain,
        grid_attention_plain)
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    wqkv, _, wp, _, table = _attn_args(
        _params(cfg, cuda)["stages"][stage]["blocks"][0])
    g = torch.Generator(device=cuda).manual_seed(11)
    bqkv = 0.02 * torch.randn(3 * geom.dim, generator=g, device=cuda)
    bp = 0.02 * torch.randn(geom.dim, generator=g, device=cuda)
    x, dy = _grid(geom, cuda, dtype, 1), _grid(geom, cuda, dtype, 2)
    ids = _ids(geom, cuda) if masked else None
    args = (wqkv.to(dtype), bqkv.to(dtype), wp.to(dtype))
    got = grid_attention(x, *args, bp.to(dtype), table, geom.window, ids)
    want = grid_attention_plain(x, *args, bp.to(dtype), table, geom.window,
                                ids)
    torch.cuda.synchronize()
    assert got.shape == x.shape and _rel_err(got, want) <= TOL[dtype]
    got = grid_attention_bwd(x, dy, *args, table, geom.window, ids)
    want = grid_attention_bwd_plain(x, dy, *args, table, geom.window, ids)
    torch.cuda.synchronize()
    names = ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dbias")
    errs = [(n, _rel_err(a, b)) for n, a, b in zip(names, got, want)]
    assert all(e <= TOL[dtype] for _, e in errs), errs
    assert got[0].dtype == dtype and all(t.dtype == torch.float32
                                         for t in got[1:])
    again = grid_attention_bwd(x, dy, *args, table, geom.window, ids)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_v2_paths_match_plain(cuda, cfg_name):
    """The v2 forward (kernels against plain versions, and against the wm
    forward from the same params), and the full-step and token-space v2
    rollouts with their launch counts."""
    from pangu_tpu_torch import ops
    cfg = dataclasses.replace(CFGS[cfg_name], block_layout="v2")
    params = _params(cfg, cuda)
    consts = synthetic_constants(cfg)
    g = torch.Generator(device=cuda).manual_seed(2)
    upper = torch.randn((1, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                        device=cuda)
    surface = torch.randn((1, 4, cfg.lat, cfg.lon), generator=g, device=cuda)
    got = pangu.forward(params, upper, surface, consts, cfg, device=cuda)
    want = pangu.forward(params, upper, surface, consts, cfg, device=cuda,
                         kernels=False)
    wm = pangu.forward(params, upper, surface, consts, CFGS[cfg_name],
                       device=cuda)
    for a, b, c in zip(got, want, wm):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= 1e-3 and _rel_err(a, c) <= 1e-3
    per_step = {"block_v2": sum(cfg.depths), "down_sample": 1, "up_sample": 1}
    for token in (False, True):
        ops.reset_launches()
        make_rollout(cfg, consts, 2, token_space=token, device=cuda)(
            params, upper, surface)
        counts = ops.launches()
        assert counts == {**{k: 0 for k in counts},
                          **{k: 2 * v for k, v in per_step.items()}}, counts


def test_v2_train_step_kernels_match_plain(cuda):
    """The float32 v2 train step's loss and every gradient, kernels against
    plain versions, the scales drawn once and shared; the per-step launch
    counts."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine.train import loss_and_grads
    cfg = dataclasses.replace(TINY, block_layout="v2")
    consts = to_device(synthetic_constants(cfg), cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    batch = {k: consts[f"{m}_mean"][None] + consts[f"{m}_std"][None]
             * torch.randn((2, v, *dims), generator=g, device=cuda)
             for k, v, dims, m in (
                 ("upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("surface", 4, (cfg.lat, cfg.lon), "surface"),
                 ("target_upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("target_surface", 4, (cfg.lat, cfg.lon), "surface"))}
    drops = pangu.draw_drops(cfg, torch.Generator(device=cuda).manual_seed(10),
                             2)
    out = []
    for kernels in (True, False):
        params = _params(cfg, cuda)
        for t in _param_leaves(params):
            t.requires_grad_(True)
        ops.reset_launches()
        out.append(loss_and_grads(params, batch, consts, cfg, TrainConfig(),
                                  device=cuda, kernels=kernels, drops=drops))
        if kernels:
            counts = ops.launches()
    n = sum(cfg.depths)
    assert counts == {**{k: 0 for k in counts}, "block_v2": n,
                      "grid_attention": n, "grid_attention_bwd": n,
                      "down_sample": 1, "up_sample": 1}, counts
    (lk, _, gk), (lp, _, gp) = out
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    errs = _tree_rel_errs(_as_dict(gk), _as_dict(gp))
    assert all(e <= 1e-3 for _, e in errs), errs


# ---------------------------------------------------------------------------
# The per-block path: the no-roll block, the block tail, the windowed sdpa
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_block_noroll_and_tail_kernels_match_plain(cuda, cfg_name, stage,
                                                   dtype):
    """The no-roll block on a padded grid whose pad rows hold data (the
    whole grid), and the block tail on a cropped grid."""
    from pangu_tpu_torch.ops.block_tail import (fused_block_tail,
                                                fused_block_tail_plain)
    from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                      block_noroll_plain)
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][0]
    tanh = dtype == torch.bfloat16
    x = _grid(geom, cuda, dtype, 3)
    got = block_noroll_fused(bp, x, geom, tanh)
    want = block_noroll_plain(bp, x, geom, tanh)
    torch.cuda.synchronize()
    assert got.shape == x.shape and _rel_err(got, want) <= TOL[dtype]
    a, s = x[:, :, :geom.h], _grid(geom, cuda, dtype, 4)[:, :, :geom.h]
    got = fused_block_tail(bp, a, s, tanh)
    want = fused_block_tail_plain(bp, a, s, tanh)
    torch.cuda.synchronize()
    assert got.shape == a.shape and _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_block_tail_bf16_tensor_core_route(cuda, cfg_name, stage):
    """The bf16 tail on a row count that is not a multiple of the 128-row
    product tile, both GELU forms: within 2^-6 of the plain version and
    bit-identical in two runs."""
    from pangu_tpu_torch.ops.block_tail import (fused_block_tail,
                                                fused_block_tail_plain)
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][0]
    g = torch.Generator(device=cuda).manual_seed(11)
    rows = 5 * 128 + 37
    a, s = (torch.randn((rows, geom.dim), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    for tanh in (False, True):
        got = fused_block_tail(bp, a, s, tanh)
        again = fused_block_tail(bp, a, s, tanh)
        want = fused_block_tail_plain(bp, a, s, tanh)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _rel_err(got, want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("c,hidden", [(20, 80), (16, 60)])
def test_block_tail_bf16_refuses_shapes_outside_the_tiles(cuda, c, hidden):
    """A bf16 tail whose C or hidden is not a multiple of 8 raises
    ValueError before a launch (no fallback)."""
    from pangu_tpu_torch.ops.block_tail import fused_block_tail
    g = torch.Generator(device=cuda).manual_seed(12)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    p = {"norm1": {"scale": r(c), "bias": r(c)},
         "norm2": {"scale": r(c), "bias": r(c)},
         "mlp": {"fc1": {"kernel": r(c, hidden), "bias": r(hidden)},
                 "fc2": {"kernel": r(hidden, c), "bias": r(c)}}}
    a = r(300, c)
    before = fused_block_tail.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_block_tail(p, a, a, True)
    assert fused_block_tail.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_kernels_match_plain(cuda, cfg_name, stage, dtype, masked):
    """The sdpa forward and every output of its backward (each bit-identical
    in two runs), on the stage's bias table with and without the folded
    mask, two longitude windows."""
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    table = _params(cfg, cuda)["stages"][stage]["blocks"][0]["attn"][
        "bias_table"].float()
    if masked:
        ids = _ids(geom, cuda)
        table = table + torch.where(ids[:, None, :] != ids[:, :, None],
                                    -100.0, 0.0)[:, None]
    bias = table.contiguous()
    ntype, heads, n, _ = bias.shape
    hd = geom.dim // heads
    g = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn((2, ntype, 3, heads, hd, n), generator=g,
                      device=cuda).to(dtype)
    dy = torch.randn((2, ntype, heads, hd, n), generator=g,
                     device=cuda).to(dtype)
    _check_sdpa(qkv, bias, dy, dtype)


def _check_sdpa(qkv, bias, dy, dtype):
    """sdpa and sdpa_bwd against their plain versions, each bit-identical in
    a second run."""
    from pangu_tpu_torch.ops.window_attention import (sdpa, sdpa_bwd,
                                                      sdpa_bwd_plain,
                                                      sdpa_plain)
    got, want = sdpa(qkv, bias), sdpa_plain(qkv, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(got, sdpa(qkv, bias))
    got, want = sdpa_bwd(qkv, bias, dy), sdpa_bwd_plain(qkv, bias, dy)
    torch.cuda.synchronize()
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    assert all(e <= TOL[dtype] for e in errs), errs
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    again = sdpa_bwd(qkv, bias, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,hd,n", [
    (torch.float32, 12, 120), (torch.bfloat16, 12, 120),
    (torch.bfloat16, 64, 100), (torch.bfloat16, 72, 144),
    (torch.bfloat16, 32, 256), (torch.bfloat16, 8, 200),
    (torch.bfloat16, 20, 37)])
def test_sdpa_kernels_other_shapes(cuda, dtype, hd, n):
    """The sdpa kernels on random qkv (2, 3, 3, 2, hd, N) and a random
    float32 bias (3, 2, N, N): N not a multiple of 16 (padded, the pads
    masked) nor of 8 (element-wise tile loads), N past 144 (the bias of the
    forward and the dbias partial of the backward in device memory, eight
    warps striding over the query rows) and head dims 8 to 72 (past 32 the
    kernels walk hd 32 columns at a time)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    qkv = torch.randn((2, 3, 3, 2, hd, n), generator=g, device=cuda).to(dtype)
    bias = torch.randn((3, 2, n, n), generator=g, device=cuda)
    dy = torch.randn((2, 3, 2, hd, n), generator=g, device=cuda).to(dtype)
    _check_sdpa(qkv, bias, dy, dtype)


@pytest.mark.parametrize("hd,n", [(8, 272), (1024, 144)])
def test_sdpa_refuses_what_the_bf16_kernels_cannot_take(cuda, hd, n):
    """N above 256, or tiles beyond the device's shared memory."""
    from pangu_tpu_torch.ops.window_attention import sdpa, sdpa_bwd
    bf = dict(device=cuda, dtype=torch.bfloat16)
    qkv = torch.zeros((1, 1, 3, 1, hd, n), **bf)
    bias = torch.zeros((1, 1, n, n), device=cuda)
    with pytest.raises(ValueError, match="N up to 256"):
        sdpa(qkv, bias)
    with pytest.raises(ValueError, match="N up to 256"):
        sdpa_bwd(qkv, bias, torch.zeros((1, 1, 1, hd, n), **bf))


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_per_block_forward_matches_plain(cuda, cfg_name):
    """The served forward with adapters (B non-zero at qkv) on each stage's
    first block and none on DownSample / UpSample, unmerged: kernels against
    plain versions and against the merged forward (1e-3, float32), and its
    launch counts."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.models import lora
    cfg = dataclasses.replace(CFGS[cfg_name], lora_fused=False)
    params = _params(cfg, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    tree = lora.init_lora(g, params, rank=4, alpha=4.0)
    for sp in tree["stages"]:
        sp["blocks"] = [sp["blocks"][0]] + [lora.strip_lora(bp)
                                            for bp in sp["blocks"][1:]]
        site = sp["blocks"][0]["attn"]["qkv"]
        site["lora_b"] = 0.05 * torch.randn(site["lora_b"].shape,
                                            generator=g, device=cuda)
    tree["downsample"] = lora.strip_lora(tree["downsample"])
    tree["upsample"] = lora.strip_lora(tree["upsample"])
    consts = synthetic_constants(cfg)
    upper = torch.randn((1, 5, cfg.levels, cfg.lat, cfg.lon), generator=g,
                        device=cuda)
    surface = torch.randn((1, 4, cfg.lat, cfg.lon), generator=g, device=cuda)
    ops.reset_launches()
    got = pangu.forward(tree, upper, surface, consts, cfg, device=cuda)
    counts = ops.launches()
    want = pangu.forward(tree, upper, surface, consts, cfg, device=cuda,
                         kernels=False)
    merged = pangu.forward(tree, upper, surface, consts,
                           dataclasses.replace(cfg, lora_fused=True),
                           device=cuda)
    for a, b, c in zip(got, want, merged):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= 1e-3 and _rel_err(a, c) <= 1e-3
    half = [d // 2 for d in cfg.depths]
    assert counts == {**{k: 0 for k in counts},
                      "block_noroll_fused": sum(h - 1 for h in half),
                      "grid_attention": sum(half),
                      "fused_block_tail": sum(half),
                      "down_sample": 1, "up_sample": 1}, counts


def _flat_grads(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_grads(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat_grads(v, f"{path}/{i}")
    else:
        yield path, tree.float()


@pytest.mark.parametrize("grid_bwd", ["pallas", "xla"])
def test_per_block_train_step_matches_plain(cuda, grid_bwd):
    """The float32 per-block train step (``train_fused=False``, ``remat``)
    against the plain path and against the fused step, scales shared; its
    launch counts."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine.train import loss_and_grads
    cfg = dataclasses.replace(TINY, train_fused=False, remat=True,
                              grid_bwd=grid_bwd)
    consts = to_device(synthetic_constants(cfg), cuda)
    g = torch.Generator(device=cuda).manual_seed(14)
    batch = {k: consts[f"{m}_mean"][None] + consts[f"{m}_std"][None]
             * torch.randn((1, v, *dims), generator=g, device=cuda)
             for k, v, dims, m in (
                 ("upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("surface", 4, (cfg.lat, cfg.lon), "surface"),
                 ("target_upper", 5, (cfg.levels, cfg.lat, cfg.lon), "upper"),
                 ("target_surface", 4, (cfg.lat, cfg.lon), "surface"))}
    drops = pangu.draw_drops(cfg, torch.Generator(device=cuda).manual_seed(15),
                             1)
    out = []
    for c, kernels in ((cfg, True), (cfg, False), (TINY, True)):
        params = _params(cfg, cuda)
        for t in _param_leaves(params):
            t.requires_grad_(True)
        ops.reset_launches()
        out.append(loss_and_grads(params, batch, consts, c, TrainConfig(),
                                  device=cuda, kernels=kernels, drops=drops))
        if c is cfg and kernels:
            counts = ops.launches()
    n = sum(cfg.depths)
    bwd = ({"grid_attention_bwd": n} if grid_bwd == "pallas"
           else {"sdpa": n, "sdpa_bwd": n})
    assert counts == {**{k: 0 for k in counts}, "grid_attention": 2 * n,
                      "down_sample": 1, "up_sample": 1, **bwd}, counts
    (lk, _, gk), (lp, _, gp), (lf, _, gf) = out
    for lw, gw in ((lp, gp), (lf, gf)):
        assert abs(float(lk) - float(lw)) <= 1e-4 * abs(float(lw))
        # a branch scaled by 0 leaves its leaves' gradients all zero in
        # both paths: those compare equal, not as 0 / 0
        bad = [(p, float((a - b).abs().max()), float(b.abs().max()))
               for (p, a), (_, b) in zip(_flat_grads(gk), _flat_grads(gw))
               if float((a - b).abs().max())
               > 1e-3 * float(b.abs().max())]
        assert not bad, bad


# ---------------------------------------------------------------------------
# The fused window attention, the canonical block backward, the grouped
# block with branch scales, the canonical training route and attn_impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel_matches_plain(cuda, cfg_name, stage, dtype,
                                               masked):
    """The fused window attention forward on the stage's partitioned
    windows (batch 2), and every gradient of ``window_attention_pallas``
    (the reference composition through the sdpa kernels) against
    ``kernels=False``."""
    from pangu_tpu_torch.models.layers import window_partition
    from pangu_tpu_torch.ops.window_attention import (window_attention_fused,
                                                      window_attention_pallas,
                                                      window_attention_plain)
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    attn = _params(cfg, cuda)["stages"][stage]["blocks"][0]["attn"]
    attn = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in attn.items()}
    x = window_partition(_grid(geom, cuda, dtype, 16), geom.window)
    ids = _ids(geom, cuda) if masked else None
    bias = attn["bias_table"].float()
    if masked:
        bias = bias + torch.where(ids[:, None, :] != ids[:, :, None], -100.0,
                                  0.0)[:, None]
    args = (attn["qkv"]["kernel"], attn["qkv"]["bias"], attn["proj"]["kernel"],
            attn["proj"]["bias"], bias.contiguous())
    got = window_attention_fused(x, *args)
    want = window_attention_plain(x, *args)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]
    dy = _grid(geom, cuda, dtype, 17)
    dy = window_partition(dy, geom.window)
    grads = []
    for kernels in (True, False):
        p = {k: ({kk: vv.detach().clone().requires_grad_(True)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else v.detach().clone().requires_grad_(True))
             for k, v in attn.items()}
        xx = x.detach().clone().requires_grad_(True)
        y = window_attention_pallas(p, xx, geom.heads, ids, kernels=kernels)
        y.backward(dy)
        grads.append([xx.grad, p["qkv"]["kernel"].grad, p["qkv"]["bias"].grad,
                      p["proj"]["kernel"].grad, p["proj"]["bias"].grad,
                      p["bias_table"].grad])
    torch.cuda.synchronize()
    errs = [_rel_err(a, b) for a, b in zip(*grads)]
    assert all(e <= TOL[dtype] for e in errs), errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("x_layout,g_layout", [
    ("canon", "wm"), ("wm", "canon"), ("canon", "canon")])
def test_block_bwd_canon_kernel_matches_plain(cuda, cfg_name, stage, dtype,
                                              x_layout, g_layout):
    """The block backward with a canonical end (a stage's first block, its
    last after an unshifted one, a one-block stage), with branch scales:
    every gradient against the plain version, bit-identical in two runs."""
    from pangu_tpu_torch.ops.earth_block_bwd import (block_bwd_canon,
                                                     block_bwd_plain)
    cfg = CFGS[cfg_name]
    geom = cfg.stage(stage)
    bp = _params(cfg, cuda)["stages"][stage]["blocks"][1]
    xs = (_grid if x_layout == "canon" else _storage)(geom, cuda, dtype, 1)
    g = (_grid if g_layout == "canon" else _storage)(geom, cuda, dtype, 2)
    drop = _drop(xs.shape[0], cuda)
    if x_layout == "wm":          # the last block, shifted
        args = ((1, 3, 6), (0, 0, 0), 3, _ids(geom, cuda))
    elif g_layout == "wm":        # the first block, a shifted one after it
        args = ((0, 0, 0), (-1, -3, -6), 0, None)
    else:
        args = ((0, 0, 0), (0, 0, 0), 0, None)
    got = block_bwd_canon(bp, xs, g, geom, *args, drop, True,
                          x_layout=x_layout, g_layout=g_layout)
    want = block_bwd_plain(bp, xs, g, geom, *args, drop, True, x_layout,
                           g_layout)
    torch.cuda.synchronize()
    assert got[0].shape == xs.shape
    errs = _tree_rel_errs({"dx": got[0], **got[1]}, {"dx": want[0], **want[1]})
    assert all(e <= TOL[dtype] for _, e in errs), errs
    again = block_bwd_canon(bp, xs, g, geom, *args, drop, True,
                            x_layout=x_layout, g_layout=g_layout)
    assert all(torch.equal(a, b) for a, b in zip(
        [got[0], *_leaves(got[1])], [again[0], *_leaves(again[1])]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_block_wm_group_drop_kernel_matches_plain(cuda, dtype, shifted):
    """The grouped block (MID stage 1: three groups of 2) with per-sample
    branch scales against the plain block; scales of 1 bit-equal to the
    served grouped block."""
    geom = MID.stage(1)
    bp = _params(MID, cuda)["stages"][1]["blocks"][1]
    xs = _storage(geom, cuda, dtype)
    args = ((1, 3, 6), 3, _ids(geom, cuda)) if shifted else ((0, 0, 0), 0,
                                                             None)
    drop = _drop(xs.shape[0], cuda)
    got = block_wm_group(bp, xs, geom, *args, True, 2, drop)
    want = block_wm_plain(bp, xs, geom, *args, True, drop)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= TOL[dtype]
    ones = block_wm_group(bp, xs, geom, *args, True, 2,
                          torch.ones(xs.shape[0], 2, device=cuda))
    assert torch.equal(ones, block_wm_group(bp, xs, geom, *args, True, 2))


def test_canon_train_step_matches_plain(cuda):
    """The float32 train step with adapters only at Down/UpSample
    (``lora_fused=False``): every stage trains through the canonical stage
    Function; kernels against plain versions (loss 1e-4 relative, every leaf
    1e-3 of its max) and its launch counts."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine.train import loss_and_grads
    from pangu_tpu_torch.models import lora
    cfg = dataclasses.replace(TINY, lora_fused=False)
    consts, upper, surface = _state(cfg, cuda, batch=1)
    _, tu, ts = _state(cfg, cuda, seed=4, batch=1)
    batch = {"upper": upper, "surface": surface, "target_upper": tu,
             "target_surface": ts}
    drops = pangu.draw_drops(cfg, torch.Generator(device=cuda).manual_seed(15),
                             1)
    out = []
    for kernels in (True, False):
        tree = lora.init_lora(torch.Generator(device=cuda).manual_seed(16),
                              _params(cfg, cuda), rank=4, alpha=4.0)
        tree["stages"] = lora.strip_lora({"s": tree["stages"]})["s"]
        for t in _param_leaves(tree):
            t.requires_grad_(True)
        ops.reset_launches()
        out.append(loss_and_grads(tree, batch, consts, cfg, TrainConfig(),
                                  device=cuda, kernels=kernels, drops=drops))
        if kernels:
            counts = ops.launches()
    nb = sum(cfg.depths)
    canon = 2 * 3           # the first and last block of stages 0, 1+2, 3
    assert counts == {**{k: 0 for k in counts}, "block_wm": nb - canon,
                      "block_wm_canon": canon, "block_bwd": nb - canon,
                      "block_bwd_canon": canon}, counts
    (lk, _, gk), (lp, _, gp) = out
    assert abs(float(lk) - float(lp)) <= 1e-4 * abs(float(lp))
    bad = [(p, float((a - b).abs().max()), float(b.abs().max()))
           for (p, a), (_, b) in zip(_flat_grads(gk), _flat_grads(gp))
           if float((a - b).abs().max()) > 1e-3 * float(b.abs().max())]
    assert not bad, bad


def test_attn_impl_xla_launches_no_kernel(cuda):
    """``attn_impl="xla"`` served and trained on the card: no kernel
    counter moves; the served step agrees with "pallas" (float32, 1e-3)."""
    from pangu_tpu_torch import ops
    from pangu_tpu_torch.config import TrainConfig
    from pangu_tpu_torch.engine.train import loss_and_grads
    cfg = dataclasses.replace(TINY, attn_impl="xla")
    consts, upper, surface = _state(cfg, cuda, batch=1)
    params = _params(cfg, cuda)
    ops.reset_launches()
    with torch.no_grad():
        got = pangu.forward(params, upper, surface, consts, cfg, device=cuda)
        assert not any(ops.launches().values()), ops.launches()
        want = pangu.forward(params, upper, surface, consts, TINY,
                             device=cuda)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= 1e-3
    for t in _param_leaves(params):
        t.requires_grad_(True)
    ops.reset_launches()
    loss, _, _ = loss_and_grads(params, {"upper": upper, "surface": surface,
                                         "target_upper": upper,
                                         "target_surface": surface},
                                consts, cfg, TrainConfig(), device=cuda,
                                seed=5)
    assert not any(ops.launches().values()), ops.launches()
    assert torch.isfinite(loss)


# The bf16 route of the backward units (tensor-core products and attention):
# TINY with three longitude windows, 18 windows a sample (2,592 rows at
# batch 1, not a multiple of the 64-row product tile), and TINY's grid at
# C = 384 (12 heads of 32, the model's stage-1 width), batch 2.
TC_CASES = {
    "ragged": (dataclasses.replace(TINY, lon=144), 1),
    "c384": (dataclasses.replace(TINY, dims=(384, 768, 768, 384),
                                 heads=(12, 24, 24, 12)), 2),
}


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("case", ["ragged", "c384"])
def test_block_bwd_tensor_core_cases(cuda, case, shifted, table_dtype):
    """The bf16 block backward at a ragged row count and at C = 384, region
    ids present (shifted) and absent, the bias table in float32 and bf16,
    with and without branch scales: every gradient against the plain
    version, bit-identical in two runs."""
    from pangu_tpu_torch.ops.earth_block_bwd import block_bwd, block_bwd_plain
    cfg, batch = TC_CASES[case]
    geom = cfg.stage(0)
    bp = _params(cfg, cuda)["stages"][0]["blocks"][1]
    bp["attn"]["bias_table"] = bp["attn"]["bias_table"].to(table_dtype)
    xs = _storage(geom, cuda, torch.bfloat16, 1, batch)
    g = _storage(geom, cuda, torch.bfloat16, 2, batch)
    if case == "ragged":
        assert (xs.numel() // geom.dim) % 64
    if shifted:
        args = ((1, 3, 6), (1, 3, 6), 3, _ids(geom, cuda))
    else:
        args = ((-1, -3, -6), (0, 0, 0), 0, None)
    for drop in (None, _drop(batch, cuda)):
        got = block_bwd(bp, xs, g, geom, *args, drop, True)
        want = block_bwd_plain(bp, xs, g, geom, *args, drop, True)
        torch.cuda.synchronize()
        errs = _tree_rel_errs({"dx": got[0], **got[1]},
                              {"dx": want[0], **want[1]})
        assert all(e <= TOL[torch.bfloat16] for _, e in errs), errs
        again = block_bwd(bp, xs, g, geom, *args, drop, True)
        assert all(torch.equal(a, b) for a, b in zip(
            [got[0], *_leaves(got[1])], [again[0], *_leaves(again[1])]))


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_layout,g_layout", [
    ("canon", "wm"), ("wm", "canon"), ("canon", "canon")])
@pytest.mark.parametrize("case", ["ragged", "c384"])
def test_block_bwd_canon_tensor_core_cases(cuda, case, x_layout, g_layout,
                                           table_dtype):
    """The bf16 block backward with canonical ends at a ragged row count
    and at C = 384, the bias table in float32 and bf16, with branch scales:
    every gradient against the plain version, bit-identical in two runs."""
    from pangu_tpu_torch.ops.earth_block_bwd import (block_bwd_canon,
                                                     block_bwd_plain)
    cfg, batch = TC_CASES[case]
    geom = cfg.stage(0)
    bp = _params(cfg, cuda)["stages"][0]["blocks"][1]
    bp["attn"]["bias_table"] = bp["attn"]["bias_table"].to(table_dtype)
    bf = torch.bfloat16
    xs = (_grid if x_layout == "canon" else _storage)(geom, cuda, bf, 1, batch)
    g = (_grid if g_layout == "canon" else _storage)(geom, cuda, bf, 2, batch)
    drop = _drop(batch, cuda)
    if x_layout == "wm":
        args = ((1, 3, 6), (0, 0, 0), 3, _ids(geom, cuda))
    elif g_layout == "wm":
        args = ((0, 0, 0), (-1, -3, -6), 0, None)
    else:
        args = ((0, 0, 0), (0, 0, 0), 0, None)
    got = block_bwd_canon(bp, xs, g, geom, *args, drop, True,
                          x_layout=x_layout, g_layout=g_layout)
    want = block_bwd_plain(bp, xs, g, geom, *args, drop, True, x_layout,
                           g_layout)
    torch.cuda.synchronize()
    errs = _tree_rel_errs({"dx": got[0], **got[1]}, {"dx": want[0], **want[1]})
    assert all(e <= TOL[bf] for _, e in errs), errs
    again = block_bwd_canon(bp, xs, g, geom, *args, drop, True,
                            x_layout=x_layout, g_layout=g_layout)
    assert all(torch.equal(a, b) for a, b in zip(
        [got[0], *_leaves(got[1])], [again[0], *_leaves(again[1])]))


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["ragged", "c384"])
def test_grid_attention_tensor_core_cases(cuda, case, masked, table_dtype):
    """The bf16 grid attention (its products on the tensor cores) and its
    backward (products and attention) at a ragged row count and at C = 384,
    region ids present and absent, the bias table in float32 and bf16:
    against the plain versions, the backward bit-identical in two runs."""
    from pangu_tpu_torch.ops.window_attention import (
        grid_attention, grid_attention_bwd, grid_attention_bwd_plain,
        grid_attention_plain)
    cfg, batch = TC_CASES[case]
    geom = cfg.stage(0)
    bf = torch.bfloat16
    wqkv, _, wp, _, table = _attn_args(
        _params(cfg, cuda)["stages"][0]["blocks"][0])
    table = table.to(table_dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    bqkv = 0.02 * torch.randn(3 * geom.dim, generator=g, device=cuda)
    bp = 0.02 * torch.randn(geom.dim, generator=g, device=cuda)
    x = _grid(geom, cuda, bf, 1, batch)
    dy = _grid(geom, cuda, bf, 2, batch)
    ids = _ids(geom, cuda) if masked else None
    args = (wqkv.to(bf), bqkv.to(bf), wp.to(bf))
    got = grid_attention(x, *args, bp.to(bf), table, geom.window, ids)
    want = grid_attention_plain(x, *args, bp.to(bf), table, geom.window, ids)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= TOL[bf]
    got = grid_attention_bwd(x, dy, *args, table, geom.window, ids)
    want = grid_attention_bwd_plain(x, dy, *args, table, geom.window, ids)
    torch.cuda.synchronize()
    names = ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dbias")
    errs = [(n, _rel_err(a, b)) for n, a, b in zip(names, got, want)]
    assert all(e <= TOL[bf] for _, e in errs), errs
    again = grid_attention_bwd(x, dy, *args, table, geom.window, ids)
    assert all(torch.equal(a, b) for a, b in zip(got, again))



@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("case", ["ragged", "c384"])
def test_block_forward_tensor_core_cases(cuda, case, shifted, table_dtype):
    """The bf16 block forward (products and attention on the tensor cores)
    at a row count that is not a multiple of the 128-row product tile and
    at C = 384, region ids present (shifted) and absent, the bias table in
    float32 and bf16, with and without branch scales: against the plain
    version, bit-identical in two runs; the grouped block (every latitude
    window in one group) bit-identical to the ungrouped one, since in bf16
    both run one launch plan."""
    cfg, batch = TC_CASES[case]
    geom = cfg.stage(0)
    bp = _params(cfg, cuda)["stages"][0]["blocks"][1]
    bp["attn"]["bias_table"] = bp["attn"]["bias_table"].to(table_dtype)
    xs = _storage(geom, cuda, torch.bfloat16, 1, batch)
    if case == "ragged":
        assert (xs.numel() // geom.dim) % 128
    args = (((1, 3, 6), 3, _ids(geom, cuda)) if shifted
            else ((0, 0, 0), 0, None))
    gh = xs.shape[2]
    for drop in (None, _drop(batch, cuda)):
        got = block_wm(bp, xs, geom, *args, True, drop)
        want = block_wm_plain(bp, xs, geom, *args, True, drop)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= TOL[torch.bfloat16]
        assert torch.equal(got, block_wm(bp, xs, geom, *args, True, drop))
        assert torch.equal(got, block_wm_group(bp, xs, geom, *args, True, gh,
                                               drop))


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["ragged", "c384"])
def test_grid_attention_forward_tensor_core_bit_identical(cuda, case, masked,
                                                          table_dtype):
    """The bf16 grid attention forward (B14: products and attention on the
    tensor cores) at a ragged row count and at C = 384, region ids present
    and absent, the bias table in float32 and bf16: against the plain
    version and bit-identical in two runs."""
    from pangu_tpu_torch.ops.window_attention import (grid_attention,
                                                      grid_attention_plain)
    cfg, batch = TC_CASES[case]
    geom = cfg.stage(0)
    bf = torch.bfloat16
    wqkv, bqkv, wp, bp, table = _attn_args(
        _params(cfg, cuda)["stages"][0]["blocks"][0])
    args = (wqkv.to(bf), bqkv.to(bf), wp.to(bf), bp.to(bf),
            table.to(table_dtype), geom.window,
            _ids(geom, cuda) if masked else None)
    x = _grid(geom, cuda, bf, 1, batch)
    if case == "ragged":
        assert (x.numel() // geom.dim) % 128
    got = grid_attention(x, *args)
    want = grid_attention_plain(x, *args)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= TOL[bf]
    assert torch.equal(got, grid_attention(x, *args))



# ---------------------------------------------------------------------------
# The canonical DownSample and the fused window attention on the tensor
# cores; their float32 routes as their first versions wrote them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_canonical_down_sample_bf16_tensor_core_route(cuda, cfg_name):
    """The bf16 canonical DownSample on the tensor cores at an odd and an
    even latitude count: against the plain version, bit-identical in two
    runs, the last sample of a batch of 8 bit-equal to that sample run
    alone."""
    cfg = CFGS[cfg_name]
    p = _params(cfg, cuda)["downsample"]
    g0 = cfg.stage(0)
    g = torch.Generator(device=cuda).manual_seed(10)
    for h in (g0.h, g0.h + 1):
        x = torch.randn((8, g0.z, h, g0.w, g0.dim), generator=g,
                        device=cuda).to(torch.bfloat16)
        got = down_sample(p, x)
        want = down_sample_plain(p, x)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert _rel_err(got, want) <= TOL[torch.bfloat16]
        assert torch.equal(got, down_sample(p, x))
        assert torch.equal(got[7], down_sample(p, x[7:].contiguous())[0])


@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_down_sample_wm_and_canonical_bf16_agree_bit_for_bit(cuda, cfg_name):
    """The window-major DownSample at offset (0, 0, 0), on storage that
    holds the canonical grid with zero pad rows, and the canonical
    DownSample on that grid give the same bits on every real output row:
    one gather + LayerNorm kernel (two row maps) and one product."""
    cfg = CFGS[cfg_name]
    p = _params(cfg, cuda)["downsample"]
    g0, g1 = cfg.stage(0), cfg.stage(1)
    grid = _grid(g0, cuda, torch.bfloat16, 11)
    grid[:, :, g0.h:] = 0
    xs = to_window_major(grid, g0.window).contiguous()
    wm = from_window_major(down_sample_wm(p, xs, g0, g1, (0, 0, 0)),
                           g1.window)[:, :, :g1.h]
    canon = down_sample(p, grid[:, :, :g0.h].contiguous())
    torch.cuda.synchronize()
    assert wm.shape == canon.shape
    assert torch.equal(wm, canon)


def test_canonical_down_sample_bf16_refuses_shapes_outside_the_tiles(cuda):
    cfg = dataclasses.replace(TINY, dims=(20, 40, 40, 20))
    g0 = cfg.stage(0)
    x = torch.randn((1, g0.z, g0.h, g0.w, g0.dim), device=cuda)
    before = down_sample.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        down_sample(_params(cfg, cuda)["downsample"], x.to(torch.bfloat16))
    assert down_sample.launches == before


def _window_inputs(cfg, stage, dev, dtype, masked, batch, seed=18):
    """(x, [wqkv, bqkv, wp, bp], folded float32 bias) of the fused window
    attention on the stage's partitioned windows of ``batch`` samples."""
    from pangu_tpu_torch.models.layers import window_partition
    geom = cfg.stage(stage)
    wqkv, bqkv, wp, bp, table = _attn_args(
        _params(cfg, dev)["stages"][stage]["blocks"][0])
    bias = table.float()
    if masked:
        ids = _ids(geom, dev)
        bias = bias + torch.where(ids[:, None, :] != ids[:, :, None], -100.0,
                                  0.0)[:, None]
    x = window_partition(_grid(geom, dev, dtype, seed, batch), geom.window)
    return (x.contiguous(), [t.to(dtype) for t in (wqkv, bqkv, wp, bp)],
            bias.contiguous())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_window_attention_bf16_tensor_core_route(cuda, cfg_name, stage,
                                                 masked):
    """The bf16 fused window attention on the tensor cores (MID: head dim
    12, the attention's element-by-element tile loads): against the plain
    version (q scaled in bf16), bit-identical in two runs, each sample of
    a batch of 2 bit-equal to it run alone."""
    from pangu_tpu_torch.ops.window_attention import (window_attention_fused,
                                                      window_attention_plain)
    x, w, bias = _window_inputs(CFGS[cfg_name], stage, cuda, torch.bfloat16,
                                masked, 2)
    got = window_attention_fused(x, *w, bias)
    want = window_attention_plain(x, *w, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL[torch.bfloat16]
    assert torch.equal(got, window_attention_fused(x, *w, bias))
    for b in range(2):
        alone = window_attention_fused(x[b:b + 1].contiguous(), *w, bias)
        assert torch.equal(got[b:b + 1], alone)


@pytest.mark.parametrize("dims,window", [((20, 40, 40, 20), (2, 6, 12)),
                                         ((16, 32, 32, 16), (2, 6, 16))],
                         ids=["C 20", "N 192"])
def test_window_attention_bf16_refuses_shapes_outside_the_tiles(cuda, dims,
                                                                window):
    """A bf16 C that is not a multiple of 8, or a window of more than 144
    tokens, raises ValueError before a launch (no fallback); float32 takes
    both."""
    from pangu_tpu_torch.ops.window_attention import (window_attention_fused,
                                                      window_attention_pallas)
    cfg = dataclasses.replace(TINY, dims=dims, window=window)
    for dtype in (torch.bfloat16, torch.float32):
        x, w, bias = _window_inputs(cfg, 0, cuda, dtype, False, 1)
        before = window_attention_pallas.launches
        if dtype == torch.float32:
            assert window_attention_fused(x, *w, bias).shape == x.shape
            assert window_attention_pallas.launches == before + 1
        else:
            with pytest.raises(ValueError, match="multiples of 8"):
                window_attention_fused(x, *w, bias)
            assert window_attention_pallas.launches == before


def _np_leaf(rng, *shape, s=0.3):
    return (rng.normal(size=shape) * s).astype("float32")


def f32_digests(dev=torch.device("cuda")):
    """sha256 of the float32 outputs of the canonical DownSample and the
    fused window attention (masked) at TINY and MID stage 0, on inputs and
    weights drawn with numpy: ``{(kernel, config): hex}``."""
    import hashlib

    import numpy as np

    from pangu_tpu_torch.models.layers import window_partition
    from pangu_tpu_torch.ops.window_attention import window_attention_fused
    out = {}
    for name, cfg in CFGS.items():
        rng = np.random.default_rng(19)
        g0 = cfg.stage(0)
        c, n = g0.dim, g0.window_tokens

        def t(a):
            return torch.from_numpy(a).to(dev)

        p = {"norm": {"scale": t(1 + _np_leaf(rng, 4 * c)),
                      "bias": t(_np_leaf(rng, 4 * c))},
             "reduce": {"kernel": t(_np_leaf(rng, 4 * c, 2 * c, s=0.05))}}
        x = t(_np_leaf(rng, 2, g0.z, g0.h, g0.w, c, s=1.0))
        ys = {"down_sample": down_sample(p, x)}
        ntype = (g0.z // g0.window[0]) * (g0.h_padded // g0.window[1])
        ids = _ids(g0, dev)
        bias = t(_np_leaf(rng, ntype, g0.heads, n, n)) + torch.where(
            ids[:, None, :] != ids[:, :, None], -100.0, 0.0)[:, None]
        w = [t(_np_leaf(rng, *s, s=0.1)) for s in ((c, 3 * c), (3 * c,),
                                                   (c, c), (c,))]
        grid = t(_np_leaf(rng, 2, g0.z, g0.h_padded, g0.w, c, s=1.0))
        xw = window_partition(grid, g0.window).contiguous()
        ys["window_attention_pallas"] = window_attention_fused(
            xw, *w, bias.contiguous())
        torch.cuda.synchronize()
        for kernel, y in ys.items():
            out[(kernel, name)] = hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()
    return out


# f32_digests() as the first versions (commit b419df9) gave them on an
# NVIDIA H100 80GB HBM3, torch 2.11.0+cu128: the float32 routes of both
# kernels did not change with their bf16 redesign
F32_FIRST_VERSION = {
    ("down_sample", "TINY"):
        "588063c7f156a8e17e55242962401b5ab7a0e1dcfed5fd833feb54c8b1be2ff2",
    ("window_attention_pallas", "TINY"):
        "ab7513fbc81a7d750c4abcbddc2f0a1a50f7747f8b138b54918b979a32aa14b2",
    ("down_sample", "MID"):
        "6e069df0dfb8454db3cdb186ff157272451cc878ce2d5ca62332f20a703790e7",
    ("window_attention_pallas", "MID"):
        "759e39c604e7650c79af8ef49892eddff6d0d2174b92b61847934cb9337f1875",
}


def test_float32_routes_equal_their_first_versions(cuda):
    assert f32_digests(cuda) == F32_FIRST_VERSION


def wm_down_digests(dev=torch.device("cuda")):
    """sha256 of the bf16 window-major DownSample's output at TINY and MID
    (offset (1, 3, 6), batch 2) on inputs and weights drawn with numpy:
    ``{config: hex}``."""
    import hashlib

    import numpy as np
    out = {}
    for name, cfg in CFGS.items():
        rng = np.random.default_rng(20)
        g0, g1 = cfg.stage(0), cfg.stage(1)
        c = g0.dim

        def t(a):
            return torch.from_numpy(a).to(dev).to(torch.bfloat16)

        p = {"norm": {"scale": t(1 + _np_leaf(rng, 4 * c)),
                      "bias": t(_np_leaf(rng, 4 * c))},
             "reduce": {"kernel": t(_np_leaf(rng, 4 * c, 2 * c, s=0.05))}}
        wz, wh, ww = g0.window
        xs = t(_np_leaf(rng, 2, g0.z // wz, g0.h_padded // wh, g0.w // ww,
                        wz * wh * ww, c, s=1.0))
        y = down_sample_wm(p, xs, g0, g1, (1, 3, 6))
        torch.cuda.synchronize()
        out[name] = hashlib.sha256(
            y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    return out


# wm_down_digests() as the window-major DownSample's kernels before they
# shared their gather + LayerNorm kernel with the canonical DownSample
# (commit b419df9) gave them on an NVIDIA H100 80GB HBM3, torch
# 2.11.0+cu128
WM_DOWN_BEFORE = {
    "TINY": "9174227f57e4d2baddf1302d98f8c8176e8e7077089afeac2b2bcbea1bd5c8ac",
    "MID": "f89f6d4447fa1c89f321b40cc39b47ac117fc0c5dc50414b4afaa131eaec7d56",
}


def test_down_sample_wm_bf16_bits_unchanged(cuda):
    assert wm_down_digests(cuda) == WM_DOWN_BEFORE


def _lon_shard(x, dim, n, i):
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
def test_canonical_kernels_on_a_lon_shard(cuda, cfg_name, dtype):
    """The kernels of the canonical route on a rank's longitude shard (sp
    2 at stage 0; stage 1 of MID has 5 lon windows, so its DownSample /
    UpSample take a shard of stage 0 and its image): ``block_v2`` and
    ``block_wm_canon`` (canonical in, canonical out) with a shift whose
    lon component is 0, ``down_sample`` and ``up_sample``, each against
    its plain version and against its output on the whole grid cut to the
    shard; a shift with a lon component on the shard, and a DownSample of
    an odd number of columns, raise ValueError (they would read across
    shards)."""
    from pangu_tpu_torch.ops.earth_block_fused import block_v2, block_v2_plain
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    g0 = cfg.stage(0)
    bp = params["stages"][0]["blocks"][1]
    ids = torch.as_tensor(window_region_ids(g0.z, g0.h_padded, g0.window),
                          device=cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    grid = torch.randn((2, g0.z, g0.h_padded, g0.w, g0.dim), generator=g,
                       device=cuda).to(dtype)
    shard = _lon_shard(grid, 3, 2, 1)
    wm = to_window_major(grid, g0.window).contiguous()
    wm_shard = _lon_shard(wm, 3, 2, 1)
    cases = (
        ("block_v2", lambda x: block_v2(bp, x, g0, (1, 3, 0), 3, ids, True),
         lambda x: block_v2_plain(bp, x, g0, (1, 3, 0), 3, ids, True),
         grid, shard, 3),
        ("block_wm_canon in", lambda x: block_wm_canon(
            bp, x, g0, (0, 0, 0), 0, None, True, in_layout="canon"),
         lambda x: block_wm_canon_plain(bp, x, g0, (0, 0, 0), 0, None, True,
                                        "canon", "wm"), grid, shard, 3),
        ("block_wm_canon out", lambda x: block_wm_canon(
            bp, x, g0, (1, 3, 0), 3, ids, True, out_layout="canon"),
         lambda x: block_wm_canon_plain(bp, x, g0, (1, 3, 0), 3, ids, True,
                                        "wm", "canon"), wm, wm_shard, 3),
        ("down_sample", lambda x: down_sample(params["downsample"], x),
         lambda x: down_sample_plain(params["downsample"], x),
         grid[:, :, :g0.h].contiguous(), shard[:, :, :g0.h].contiguous(), 3))
    for name, kern, plain, whole, part, dim in cases:
        got, want = kern(part), plain(part)
        cut = _lon_shard(kern(whole), dim, 2, 1)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= TOL[dtype], name
        assert _rel_err(got, cut) <= TOL[dtype], name
    g2, g3 = cfg.stage(2), cfg.stage(3)
    y = torch.randn((2, g2.z, g2.h, g2.w, g2.dim), generator=g,
                    device=cuda).to(dtype)
    y_shard = _lon_shard(y, 3, 5 if g2.w // g2.window[2] % 2 else 2, 1)
    got = up_sample(params["upsample"], y_shard, g3.h)
    assert _rel_err(got, up_sample_plain(params["upsample"], y_shard,
                                         g3.h)) <= TOL[dtype]
    whole = up_sample(params["upsample"], y, g3.h)
    n = y.shape[3] // y_shard.shape[3]
    assert _rel_err(got, _lon_shard(whole, 3, n, 1)) <= TOL[dtype]
    with pytest.raises(ValueError, match="reads across shards"):
        block_v2(bp, shard, g0, (1, 3, 6), 3, ids, True)
    with pytest.raises(ValueError, match="reads across shards"):
        block_wm_canon(bp, wm_shard, g0, (1, 3, 6), 3, ids, True,
                       out_layout="canon")
    with pytest.raises(ValueError, match="reads across shards"):
        down_sample(params["downsample"], grid[:, :, :g0.h, :g0.w // 2 - 1]
                    .contiguous())

"""The port's CUDA kernels against their plain PyTorch versions on the card,
at TINY and MID widths (head dims 8 and 12, channel counts that are not
multiples of the GEMM tiles, batch 2), float32 and bf16, every shift a stage
chain uses; the edge kernels (embed, transition, recovery upper and surface)
at the stage-end offsets (0, 0, 0) and (1, 3, 6).  Needs a CUDA device and nvcc: marked ``gpu``, skipped elsewhere.
Run on the card with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

Error measure: max |kernel - plain| / max |plain|.  Tolerances: 1e-4 in
float32 (reassociation of float32 sums, amplified by the LayerNorms), 2**-6
in bf16 (a few bf16 ulps: a value that rounds one way in one version and the
other way in the other moves by an ulp and the difference propagates)."""

import dataclasses

import pytest
import torch

from pangu_tpu_torch.config import MID, TINY
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.engine.rollout import make_rollout
from pangu_tpu_torch.engine.transition_wm import (apply_transition_wm,
                                                  apply_transition_wm_plain,
                                                  build_transition_wm)
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops.earth_block_wm import block_wm, block_wm_plain
from pangu_tpu_torch.ops.embed_wm import embed_wm, embed_wm_plain
from pangu_tpu_torch.ops.recovery_wm import (recovery_wm_surface,
                                             recovery_wm_surface_plain,
                                             recovery_wm_upper,
                                             recovery_wm_upper_plain)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_updown_wm_kernels_match_plain(cuda, cfg_name, dtype, off):
    cfg = CFGS[cfg_name]
    params = _params(cfg, cuda)
    g0, g1, g2, g3 = (cfg.stage(i) for i in range(4))
    xs = _storage(g0, cuda, dtype)
    got = down_sample_wm(params["downsample"], xs, g0, g1, off)
    want = down_sample_wm_plain(params["downsample"], xs, g0, g1, off)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL[dtype]
    xs = _storage(g2, cuda, dtype)
    got = up_sample_wm(params["upsample"], xs, g2, g3, off)
    want = up_sample_wm_plain(params["upsample"], xs, g2, g3, off)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL[dtype]


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
    cfg = _in_dtype(CFGS[cfg_name], dtype)
    p = _params(cfg, cuda)["patch_embed"]
    consts, upper, surface = _state(cfg, cuda)
    got = embed_wm(p, upper, surface, consts, cfg)
    want = embed_wm_plain(p, upper, surface, consts, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg_name", ["TINY", "MID"])
@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_transition_and_recovery_kernels_match_plain(cuda, cfg_name, dtype,
                                                     off):
    cfg = _in_dtype(CFGS[cfg_name], dtype)
    params = _params(cfg, cuda)
    g0 = cfg.stage(0)
    skip, dec = _storage(g0, cuda, dtype, seed=4), _storage(g0, cuda, dtype, seed=5)
    tp = build_transition_wm(params, to_device(synthetic_constants(cfg), cuda),
                             cfg)
    got = apply_transition_wm(tp, skip, dec, g0, off)
    want = apply_transition_wm_plain(tp, skip, dec, g0, off)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]      # pad rows: zeros in both
    for kern, plain in ((recovery_wm_upper, recovery_wm_upper_plain),
                        (recovery_wm_surface, recovery_wm_surface_plain)):
        got = kern(params["patch_recovery"], skip, dec, off, cfg)
        want = plain(params["patch_recovery"], skip, dec, off, cfg)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= TOL[dtype]


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

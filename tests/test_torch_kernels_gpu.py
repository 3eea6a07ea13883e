"""The port's CUDA kernels against their plain PyTorch versions on the card,
at TINY and MID widths (head dims 8 and 12, channel counts that are not
multiples of the GEMM tiles, batch 2), float32 and bf16, every shift a stage
chain uses.  Needs a CUDA device and nvcc: marked ``gpu``, skipped elsewhere.
Run on the card with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.

Error measure: max |kernel - plain| / max |plain|.  Tolerances: 1e-4 in
float32 (reassociation of float32 sums, amplified by the LayerNorms), 2**-6
in bf16 (a few bf16 ulps: a value that rounds one way in one version and the
other way in the other moves by an ulp and the difference propagates)."""

import pytest
import torch

from pangu_tpu_torch.config import MID, TINY
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops.earth_block_wm import block_wm, block_wm_plain
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

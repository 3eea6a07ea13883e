"""The index logic of the bf16 transition and upper recovery on the tensor
cores (``csrc/edge_mma.cuh``'s ``edge_mma_kernel`` with ``TransitionMma``
in ``csrc/transition_wm.cu`` and ``RecoveryMma`` in
``csrc/recovery_wm.cu``), modelled in PyTorch on the CPU at TINY, batch 2,
the pair's offsets (0, 0, 0) and (1, 3, 6), float32 and bf16.

The model walks the kernel's tiles as its grid does (``blockIdx.x`` -> the
group, the row tile, the column tile; the tile sizes read from the
sources), builds each tile's row table as the kernel does (the rolled
source row of each output row, its destination), picks the group's matrix
(plane 0 / interior / top, the last real latitude row) and writes the
output as the Ops' epilogues do (the transition's whole rows, zeros on
latitude-pad groups; the recovery's (var, zo, ho) lines two rows at a
time, cropped).  Checked: every output element is written exactly once,
the recovery's 16-byte chunks start on 8-element boundaries, and the
result equals ``apply_transition_wm_plain`` / ``recovery_wm_upper_plain``
(float32 1e-6 of the output's max: float32 sums in another order; bf16
2^-6, the kernels' tolerance: a sum that rounds the other way moves by a
bf16 ulp).  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.engine.transition_wm import (MATRICES,
                                                  apply_transition_wm_plain,
                                                  build_transition_wm)
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.ops.recovery_wm import recovery_wm_upper_plain

CSRC = Path(__file__).resolve().parent.parent / "pangu_tpu_torch" / "csrc"
B = 2
OFFSETS = [(0, 0, 0), (1, 3, 6)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -6}
PZ, PH, PW = TINY.patch


def _tile(source, op):
    """(BM, BN) of ``op``'s EmTile<WM, WN, MT, NT, MinB> in ``source``."""
    text = (CSRC / source).read_text()
    m = re.search(rf"struct {op} {{\s*using Tile = EmTile<(\d+), (\d+), "
                  r"(\d+), (\d+), (\d+)>", text)
    wm, wn, mt, nt, _ = map(int, m.groups())
    return 16 * mt * wm, 8 * nt * wn


def _tiles(groups, m, n, bm, bn):
    """(group, r0, nrows, n0) of every CTA, as edge_mma_kernel takes them
    from blockIdx.x (a row tile's column tiles are neighbours)."""
    mtiles, ntiles = -(-m // bm), -(-n // bn)
    for x in range(groups * mtiles * ntiles):
        n0, y = x % ntiles * bn, x // ntiles
        r0, g = y % mtiles * bm, y // mtiles
        yield g, r0, min(bm, m - r0), n0


def _wm_row(b, z, lat, lon, geom):
    """common.cuh's wm_row: the storage row of token (z, lat, lon)."""
    wz, wh, ww = geom.window
    nz, nlat, nlon = geom.z // wz, geom.h_padded // wh, geom.w // ww
    win = ((b * nz + z // wz) * nlat + lat // wh) * nlon + lon // ww
    return win * (wz * wh * ww) + ((z % wz) * wh + lat % wh) * ww + lon % ww


def _rolled_row(b, z, lat, lon, geom, off):
    """edge_gemm.cuh's rolled_row: where the pair holds token (z, lat, lon)."""
    oz, olat, olon = off
    return _wm_row(b, (z - oz) % geom.z, (lat - olat) % geom.h_padded,
                   (lon - olon) % geom.w, geom)


@pytest.fixture(scope="module")
def setup():
    params = pangu.init_params(torch.Generator().manual_seed(3), TINY,
                               device="cpu")
    tp = build_transition_wm(params, to_device(synthetic_constants(TINY),
                                               "cpu"), TINY)
    g = TINY.stage(0)
    wz, wh, ww = g.window
    shape = (B, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, g.dim)
    rng = np.random.default_rng(11)
    skip, dec = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
                 for _ in range(2))
    return params, tp, skip, dec


def _close(got, want, dtype):
    scale = float(want.float().abs().max())
    assert scale > 0
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("off", OFFSETS)
def test_transition_rows_model_matches_plain(setup, off, dtype):
    _, tp, skip, dec = setup
    tp = {k: v.to(dtype) for k, v in tp.items()}
    skip, dec = skip.to(dtype), dec.to(dtype)
    g = TINY.stage(0)
    c = g.dim
    bm, bn = _tile("transition_wm.cu", "TransitionMma")
    pair = torch.cat([skip.reshape(-1, c), dec.reshape(-1, c)], dim=1)
    bias = tp["bias_field_wm"].reshape(-1, c)
    sample_rows = bias.shape[0]
    out = torch.full((pair.shape[0], c), float("nan"), dtype=dtype)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    for grp, r0, nrows, n0 in _tiles(B * g.z * g.h_padded, g.w, c, bm, bn):
        lat, z, b = grp % g.h_padded, grp // g.h_padded % g.z, \
            grp // (g.h_padded * g.z)
        r = torch.arange(r0, r0 + nrows)
        dst = _wm_row(b, z, lat, r, g)
        cols = slice(n0, min(n0 + bn, c))
        writes[dst, cols] += 1
        if lat >= g.h:                      # a latitude-pad group: zeros
            out[dst, cols] = 0
            continue
        src = _rolled_row(b, z, lat, r, g, off)
        kind = (0 if z == 0 else 4 if z == g.z - 1 else 2) + (lat == g.h - 1)
        y = (pair[src].float() @ tp[MATRICES[kind]][:, cols].float()).to(dtype)
        out[dst, cols] = (y.float() + bias[dst - b * sample_rows, cols]
                          .float()).to(dtype)
    assert bool((writes == 1).all())
    want = apply_transition_wm_plain(tp, skip, dec, g, off)
    _close(out.reshape(skip.shape), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_upper_rows_model_matches_plain(setup, off, dtype):
    params, _, skip, dec = setup
    skip, dec = skip.to(dtype), dec.to(dtype)
    p = {k: v.to(dtype) for k, v in params["patch_recovery"]["upper"].items()}
    g = TINY.stage(3)
    c, v, levels, lat, lon = (g.dim, TINY.upper_vars, TINY.levels, TINY.lat,
                              TINY.lon)
    n = v * PZ * PH * PW
    planes, ht = g.z - 1, TINY.h_tokens
    bm, bn = _tile("recovery_wm.cu", "RecoveryMma")
    assert lon % 8 == 0                     # the 16-byte route
    pair = torch.cat([skip.reshape(-1, c), dec.reshape(-1, c)], dim=1)
    out = torch.full((B * v * levels * lat * lon,), float("nan"), dtype=dtype)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    wo = torch.arange(PW)
    for grp, r0, nrows, n0 in _tiles(B * planes * ht, g.w, n, bm, bn):
        h, zp, b = grp % ht, grp // ht % planes, grp // (ht * planes)
        r = torch.arange(r0, r0 + nrows)
        src = _rolled_row(b, zp + 1, h, r, g, off)
        y = (pair[src].float() @ p["kernel"][:, n0:n0 + bn].float()
             + p["bias"][n0:n0 + bn].float()).to(dtype)
        dst = (((b * v) * levels + PZ * zp) * lat + PH * h) * lon + PW * r
        q = torch.arange(0, nrows, 2)       # a lane: rows 2q, 2q + 1
        for ln in range(min(bn, n - n0) // PW):
            line = n0 // PW + ln
            ho, zo, var = line % PH, line // PH % PZ, line // (PZ * PH)
            if PZ * zp + zo >= levels or PH * h + ho >= lat:
                continue                    # cropped
            o = dst[q] + (var * levels + zo) * lat * lon + ho * lon
            assert bool((o % 8 == 0).all())
            for k in (0, 1):
                rows = q + k
                keep = rows < nrows
                at = (o[keep][:, None] + PW * k + wo).reshape(-1)
                out[at] = y[rows[keep], PW * ln:PW * ln + PW].reshape(-1)
                writes[at] += 1
    assert bool((writes == 1).all())
    want = recovery_wm_upper_plain(params["patch_recovery"], skip, dec, off,
                                   TINY)
    _close(out.reshape(want.shape), want, dtype)

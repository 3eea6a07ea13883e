"""The index logic of the bf16 edge products on the tensor cores
(``csrc/edge_mma.cuh``'s ``edge_mma_kernel`` with ``TransitionMma`` in
``csrc/transition_wm.cu``, ``RecoveryMma`` (upper and surface branches) in
``csrc/recovery_wm.cu`` and ``EmbedMma`` in ``csrc/embed_wm.cu``),
modelled in PyTorch on the CPU at TINY, batch 2, the pair's offsets (0, 0,
0) and (1, 3, 6), float32 and bf16.

The model walks the kernel's tiles as its grid does (``blockIdx.x`` -> the
group, the row tile, the column tile; the tile sizes read from the
sources), builds each tile's row table as the kernel does (the rolled
source row of each output row, its destination; the embed's patch corner),
loads the A rows as the Op's ``load_a`` does (the pair's rows; the embed's
8-byte runs of 4 w_off values, one variable's 8 (zo, ho) runs a 32-wide k
slice, zero-filled past the field's levels and latitudes, const_h the last
variable), picks the group's matrix (plane 0 / interior / top, the last
real latitude row) and writes the output as the Ops' epilogues do (the
transition's and the embed's whole rows, zeros on latitude-pad groups, and
the embed's plane-0 copy 8 channels a lane; the recovery's (var, zo, ho)
lines two rows at a time, cropped).  Checked: every output element is
written exactly once, the 8-byte runs start on 4-element boundaries and
the 16-byte chunks on 8-element boundaries, and the result equals
``apply_transition_wm_plain`` / ``recovery_wm_upper_plain`` /
``recovery_wm_surface_plain`` / ``embed_wm_plain`` (float32 1e-6 of the
output's max: float32 sums in another order; bf16 2^-6, the kernels'
tolerance: a sum that rounds the other way moves by a bf16 ulp).

Two more bf16 routes, modelled the same way: the upper embed weight
gradient (``csrc/embed_dw.cu``), whose relayout writes the patch matrix A
in the cotangent's window-major row order as its grid walks the lon lines
(8-feature groups from two 8-byte runs of the field, then the indicator
column, zero rows on plane 0 and the token-lat pad rows), so that A^T dxs
is dK and db (1e-5 of each output's max: float32 sums in another order,
junk on the cotangent's pad rows and values on its plane-0 rows), and a
row of ones in place of the indicator would get db wrong; and the
canonical UpSample (``csrc/updown.cu``), whose gather + LayerNorm kernel
takes up_rows rows a warp and reads each row's C' slice of the expand
product where ``UpCanonMap`` says, for an odd and an even crop; and the
canonical DownSample (``csrc/updown.cu``), whose gather + LayerNorm kernel
takes a warp a row and reads each of its four parts where
``DownCanonMap`` says (zeros past an odd latitude count).  Last, the bf16
fused window attention (``csrc/window_attn.cu``): its qkv epilogue
(``QScaleEpi``: q rounded after its bias, then times the rounded scale and
rounded again) and ``wattn_mma.cuh``'s walk, one (type, head) at a time
over the windows of that type at ``wa_base`` of the launch's window grid
(read from the source), its table slice, logits with scale 1.  The
kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``)."""

import dataclasses
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
from pangu_tpu_torch.models.layers import dense, layer_norm
from pangu_tpu_torch.ops.earth_block_wm import (from_window_major,
                                                to_window_major)
from pangu_tpu_torch.ops.embed_wm import (embed_dw_operands,
                                          embed_dw_upper_plain,
                                          embed_operands, embed_wm_plain)
from pangu_tpu_torch.ops.recovery_wm import (recovery_wm_surface_plain,
                                             recovery_wm_upper_plain)
from pangu_tpu_torch.ops.updown import down_sample_plain, up_sample_plain
from pangu_tpu_torch.ops.window_attention import window_attention_plain

CSRC = Path(__file__).resolve().parent.parent / "pangu_tpu_torch" / "csrc"
B = 2
OFFSETS = [(0, 0, 0), (1, 3, 6)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -6}
PZ, PH, PW = TINY.patch


def _tile(source, op, which=-1):
    """(BM, BN) of ``op``'s EmTile<WM, WN, MT, NT, MinB> in ``source``; of
    a Tile chosen by ``std::conditional_t``, the one at ``which`` (0: the
    condition true)."""
    text = (CSRC / source).read_text()
    m = re.search(rf"struct {op}\b[^{{]*{{\s*(?://[^\n]*\n\s*)*"
                  r"using Tile = ([^;]*);", text)
    tiles = re.findall(r"EmTile<(\d+), (\d+), (\d+), (\d+), (\d+)>",
                       m.group(1))
    wm, wn, mt, nt, _ = map(int, tiles[which])
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


def _recovery_rows_model(params, skip, dec, off, dtype, surface):
    """The recovery branch's output as RecoveryMma<surface> writes it."""
    skip, dec = skip.to(dtype), dec.to(dtype)
    head = "surface" if surface else "upper"
    p = {k: v.to(dtype) for k, v in params["patch_recovery"][head].items()}
    g = TINY.stage(3)
    c, lat, lon = g.dim, TINY.lat, TINY.lon
    v = TINY.surface_vars if surface else TINY.upper_vars
    pz = 1 if surface else PZ                       # the features' level run
    levels = 1 if surface else TINY.levels
    n = v * pz * PH * PW
    planes, ht = (1 if surface else g.z - 1), TINY.h_tokens
    bm, bn = _tile("recovery_wm.cu", "RecoveryMma", 0 if surface else 1)
    assert lon % 8 == 0                     # the 16-byte route
    pair = torch.cat([skip.reshape(-1, c), dec.reshape(-1, c)], dim=1)
    out = torch.full((B * v * levels * lat * lon,), float("nan"), dtype=dtype)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    wo = torch.arange(PW)
    for grp, r0, nrows, n0 in _tiles(B * planes * ht, g.w, n, bm, bn):
        h, zp, b = grp % ht, grp // ht % planes, grp // (ht * planes)
        r = torch.arange(r0, r0 + nrows)
        src = _rolled_row(b, 0 if surface else zp + 1, h, r, g, off)
        y = (pair[src].float() @ p["kernel"][:, n0:n0 + bn].float()
             + p["bias"][n0:n0 + bn].float()).to(dtype)
        dst = (((b * v) * levels + PZ * zp) * lat + PH * h) * lon + PW * r
        q = torch.arange(0, nrows, 2)       # a lane: rows 2q, 2q + 1
        for ln in range(min(bn, n - n0) // PW):
            line = n0 // PW + ln
            ho, zo, var = line % PH, line // PH % pz, line // (pz * PH)
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
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_upper_rows_model_matches_plain(setup, off, dtype):
    params, _, skip, dec = setup
    out = _recovery_rows_model(params, skip, dec, off, dtype, surface=False)
    want = recovery_wm_upper_plain(params["patch_recovery"], skip.to(dtype),
                                   dec.to(dtype), off, TINY)
    _close(out.reshape(want.shape), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_surface_rows_model_matches_plain(setup, off, dtype):
    params, _, skip, dec = setup
    out = _recovery_rows_model(params, skip, dec, off, dtype, surface=True)
    want = recovery_wm_surface_plain(params["patch_recovery"],
                                     skip.to(dtype), dec.to(dtype), off, TINY)
    _close(out.reshape(want.shape), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_rows_model_matches_plain(setup, dtype):
    """EmbedMma's tiles, 8-byte source runs with their zero-fill predicates
    and whole-row writes, and the plane-0 copy, against embed_wm_plain on
    the operands the wrapper hands the kernel."""
    params = setup[0]
    cfg = dataclasses.replace(TINY, compute_dtype="bfloat16"
                              if dtype == torch.bfloat16 else "float32")
    consts = to_device(synthetic_constants(cfg), "cpu")
    rng = np.random.default_rng(12)
    upper = (consts["upper_mean"][None] + consts["upper_std"][None]
             * torch.as_tensor(rng.normal(size=(B, 5, cfg.levels, cfg.lat,
                                                cfg.lon)).astype(np.float32)))
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * torch.as_tensor(rng.normal(size=(B, 4, cfg.lat, cfg.lon))
                                 .astype(np.float32)))
    pe = params["patch_embed"]
    un, ch, st, w, bias = embed_operands(pe, upper, surface, consts, cfg)
    g = cfg.stage(0)
    c, v, levels, lat, lon = g.dim, cfg.upper_vars, cfg.levels, cfg.lat, \
        cfg.lon
    zp_n, hp, ht, wt = g.z - 1, g.h_padded, cfg.h_tokens, g.w
    bm, bn = _tile("embed_wm.cu", "EmbedMma")
    bk = int(re.search(r"EM_BK = (\d+)",
                       (CSRC / "edge_mma.cuh").read_text()).group(1))
    assert bk == PZ * PH * PW and w.shape[0] == (v + 1) * bk
    vol = levels * lat * lon
    field, chf = un.reshape(-1), ch.reshape(-1)
    out = torch.full((B * g.z * hp * wt, c), float("nan"), dtype=dtype)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    for grp, r0, nrows, n0 in _tiles(B * zp_n * hp, wt, c, bm, bn):
        h, zp, b = grp % hp, grp // hp % zp_n, grp // (hp * zp_n)
        r = torch.arange(r0, r0 + nrows)
        dst = _wm_row(b, zp + 1, h, r, g)
        cols = slice(n0, min(n0 + bn, c))
        assert n0 % 8 == 0 and (cols.stop - n0) % 8 == 0
        writes[dst, cols] += 1
        if h >= ht:                         # a latitude-pad group: zeros
            out[dst, cols] = 0
            continue
        corner = (PZ * zp * lat + PH * h) * lon + PW * r     # the row table
        a = torch.zeros((nrows, w.shape[0]), dtype=dtype)
        for kt in range(w.shape[0] // bk):   # a k slice: variable kt
            src, base = (field, (b * v + kt) * vol) if kt < v else (chf, 0)
            for j in range(PZ * PH):         # its (zo, ho) runs
                zo, ho = divmod(j, PH)
                if PZ * zp + zo >= levels or PH * h + ho >= lat:
                    continue                 # zero-filled
                at = base + corner + (zo * lat + ho) * lon
                assert bool((at % PW == 0).all())        # 8-byte runs
                a[:, kt * bk + PW * j:kt * bk + PW * j + PW] = \
                    src[at[:, None] + torch.arange(PW)]
        out[dst, cols] = (a.float() @ w[:, cols].float()
                          + bias[cols].float()).to(dtype)
    # plane 0: the surface token plane, 8 channels a lane
    assert c % 8 == 0
    for b in range(B):
        for h in range(hp):
            dst = _wm_row(b, 0, h, torch.arange(wt), g)
            writes[dst] += 1
            out[dst] = st[b, h] if h < ht else 0
    assert bool((writes == 1).all())
    want = embed_wm_plain(pe, upper, surface, consts, cfg)
    _close(out.reshape(want.shape), want, dtype)


def _dw_case(dtype):
    """TINY, batch B: the physical upper field, the constants and a stage-0
    wm cotangent in ``dtype`` whose token-lat pad rows hold junk (50x + 7)
    and whose plane-0 rows hold values (neither is summed)."""
    cfg = TINY
    consts = to_device(synthetic_constants(cfg), "cpu")
    rng = np.random.default_rng(13)
    upper = (consts["upper_mean"][None] + consts["upper_std"][None]
             * torch.as_tensor(rng.normal(size=(B, 5, cfg.levels, cfg.lat,
                                                cfg.lon)).astype(np.float32)))
    g = cfg.stage(0)
    grid = torch.as_tensor(rng.normal(size=(B, g.z, g.h_padded, g.w, g.dim))
                           .astype(np.float32))
    assert g.h < g.h_padded
    grid[:, :, g.h:] = 50 * grid[:, :, g.h:] + 7
    dxs = to_window_major(grid, g.window).contiguous().to(dtype)
    return cfg, consts, upper, dxs


def _patch_rows_model(un, ch, cfg):
    """A (storage rows, K + 8) as embed_dw.cu's patch_rows_kernel writes
    it: a block per (b, z, h) lon line and DW_TOK tokens, each token's row
    at its wm row; an upper token's row its K patch values, 8 features (v,
    zo, ho | ho + 1, wo) from two 8-byte runs of 4 wo values, then the
    indicator group (1, then 7 zeros); plane 0's rows and the token-lat pad
    rows all zeros."""
    tok = int(re.search(r"DW_TOK = (\d+)",
                        (CSRC / "embed_dw.cu").read_text()).group(1))
    g = cfg.stage(0)
    v_n, levels, lat, lon = cfg.upper_vars, cfg.levels, cfg.lat, cfg.lon
    k = (v_n + 1) * PZ * PH * PW
    assert k % 8 == 0 and lon % PW == 0
    b_n = un.shape[0]
    a = torch.full((b_n * g.z * g.h_padded * g.w, k + 8), float("nan"),
                   dtype=un.dtype)
    writes = torch.zeros(a.shape[0], dtype=torch.int32)
    field, chf, vol = un.reshape(-1), ch.reshape(-1), levels * lat * lon
    run = torch.arange(PW)
    for line in range(b_n * g.z * g.h_padded):
        h, z, b = (line % g.h_padded, line // g.h_padded % g.z,
                   line // (g.h_padded * g.z))
        for w0 in range(0, g.w, tok):
            w = torch.arange(w0, min(w0 + tok, g.w))
            dst = _wm_row(b, z, h, w, g)
            writes[dst] += 1
            if z == 0 or h >= cfg.h_tokens:
                a[dst] = 0
                continue
            row = torch.zeros((len(w), k + 8), dtype=un.dtype)
            for f0 in range(0, k, 8):
                v, zo = f0 // (PZ * PH * PW), f0 // (PH * PW) % PZ
                lev, la = PZ * (z - 1) + zo, PH * h + f0 // PW % PH
                src, base = (field, (b * v_n + v) * vol) if v < v_n else \
                    (chf, 0)
                for i, at_lat in enumerate((la, la + 1)):
                    if lev >= levels or at_lat >= lat:
                        continue            # zeros
                    at = base + (lev * lat + at_lat) * lon + PW * w
                    assert bool((at % PW == 0).all())     # 8-byte runs
                    row[:, f0 + PW * i:f0 + PW * i + PW] = \
                        src[at[:, None] + run]
            row[:, k] = 1                   # the indicator
            a[dst] = row
    assert bool((writes == 1).all())
    return a, k


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_dw_relayout_model_matches_plain(dtype):
    """A^T dxs over every storage row, A as the relayout writes it, is the
    plain version's dK (its first K rows) and db (the indicator row); the
    padding columns give zeros."""
    cfg, consts, upper, dxs = _dw_case(dtype)
    dxs, un, ch = embed_dw_operands(dxs, upper, consts, cfg)
    a, k = _patch_rows_model(un, ch, cfg)
    got = a.float().T @ dxs.reshape(-1, dxs.shape[-1]).float()
    dk, db = embed_dw_upper_plain(dxs, upper, consts, cfg)
    for part, want in ((got[:k], dk), (got[k], db)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((part - want).abs().max()) <= 1e-5 * scale
    assert bool((got[k + 1:] == 0).all())


def test_embed_dw_row_of_ones_gets_db_wrong():
    """mma_wgrad's row of ones in place of the indicator sums every storage
    row, plane 0's cotangent and the junk on the pad rows with the rest:
    its db is not the plain version's (the trap the indicator avoids)."""
    cfg, consts, upper, dxs = _dw_case(torch.float32)
    dxs, un, ch = embed_dw_operands(dxs, upper, consts, cfg)
    a, k = _patch_rows_model(un, ch, cfg)
    a[:, k] = 1
    got = a.T @ dxs.reshape(-1, dxs.shape[-1])
    _, db = embed_dw_upper_plain(dxs, upper, consts, cfg)
    assert float((got[k] - db).abs().max()) > 0.5 * float(db.abs().max())


def _up_canon_src(m, h, w, out_h, c):
    """updown.cu's UpCanonMap: where y row m of the (BZ, out_h, 2W) grid
    reads its C' slice of e (an element offset)."""
    j, q = m % (2 * w), m // (2 * w)
    i, bz = q % out_h, q // out_h
    return ((bz * h + i // 2) * w + j // 2) * 4 * c + (2 * (i % 2) + j % 2) * c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("crop", ["odd", "even"])
def test_canonical_up_sample_row_map_model_matches_plain(setup, crop, dtype):
    """The canonical UpSample's gather as up_gather_ln_kernel runs it with
    UpCanonMap: up_rows rows a warp (from the source, for the C' of
    TINY), each row read 16 bytes a lane from its C' slice of e, every row
    of the cropped grid written once; then the LayerNorm and the mix
    product as the plain version computes them, against
    ``up_sample_plain``."""
    params = setup[0]
    p = {k: {j: t.to(dtype) for j, t in v.items()}
         for k, v in params["upsample"].items()}
    g2 = TINY.stage(2)
    c = p["mix"]["kernel"].shape[0]
    h, w = g2.h, g2.w
    out_h = 2 * h - 1 if crop == "odd" else 2 * h
    rng = np.random.default_rng(14)
    x = torch.as_tensor(rng.normal(size=(B, g2.z, h, w, g2.dim))
                        .astype(np.float32)).to(dtype)
    rows = re.search(r"constexpr int up_rows\(\) \{ return NJ < (\d+) \? "
                     r"(\d+) / NJ : 1; \}",
                     (CSRC / "updown_rows.cuh").read_text())
    nj = -(-(c // 8) // 32)
    r_n = int(rows.group(2)) // nj if nj < int(rows.group(1)) else 1
    e = dense(p["expand"], x).reshape(-1)
    m3 = B * g2.z * out_h * 2 * w
    y = torch.full((m3, c), float("nan"), dtype=dtype)
    writes = torch.zeros(m3, dtype=torch.int32)
    for warp in range(-(-m3 // r_n)):
        m = torch.arange(warp * r_n, min(warp * r_n + r_n, m3))
        src = _up_canon_src(m, h, w, out_h, c)
        assert bool((src % 8 == 0).all())            # 16-byte loads
        y[m] = e[src[:, None] + torch.arange(c)]
        writes[m] += 1
    assert bool((writes == 1).all())
    out = dense(p["mix"], layer_norm(p["norm"], y))
    want = up_sample_plain(p, x, out_h)
    _close(out.reshape(want.shape), want, dtype)


def _down_canon_src(m, part, h, w, c):
    """updown.cu's DownCanonMap: where part ``part`` of row m of the (BZ,
    ceil(H/2), W/2) grid reads x (an element offset), -1 for zeros."""
    h2, w2 = -(-h // 2), w // 2
    j, q = m % w2, m // w2
    i, bz = q % h2, q // h2
    lat = 2 * i + part // 2
    src = ((bz * h + lat) * w + 2 * j + part % 2) * c
    return torch.where(lat >= h, -1, src)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lat", ["odd", "even"])
def test_canonical_down_sample_row_map_model_matches_plain(setup, lat,
                                                           dtype):
    """The canonical DownSample's gather as down_gather_ln_kernel runs it
    with DownCanonMap: a warp a row, each part read 16 bytes a lane at its
    offset (zeros where the map says -1), every row written once; then the
    LayerNorm and the reduce product as the plain version computes them,
    against ``down_sample_plain``."""
    params = setup[0]
    p = {k: {j: t.to(dtype) for j, t in v.items()}
         for k, v in params["downsample"].items()}
    g0 = TINY.stage(0)
    c, w = g0.dim, g0.w
    h = g0.h - (g0.h % 2 == (lat == "even"))
    rng = np.random.default_rng(15)
    x = torch.as_tensor(rng.normal(size=(B, g0.z, h, w, c))
                        .astype(np.float32)).to(dtype)
    flat = x.reshape(-1)
    m1 = B * g0.z * -(-h // 2) * (w // 2)
    cat = torch.full((m1, 4 * c), float("nan"), dtype=dtype)
    writes = torch.zeros(m1, dtype=torch.int32)
    zero_parts = 0
    for m in range(m1):
        for part in range(4):
            src = int(_down_canon_src(torch.tensor(m), part, h, w, c))
            if src < 0:
                cat[m, part * c:(part + 1) * c] = 0
                zero_parts += 1
            else:
                assert src % 8 == 0                  # 16-byte loads
                cat[m, part * c:(part + 1) * c] = flat[src:src + c]
        writes[m] += 1
    assert bool((writes == 1).all())
    assert zero_parts == (2 * B * g0.z * (w // 2) if h % 2 else 0)
    out = dense(p["reduce"], layer_norm(p["norm"], cat))
    want = down_sample_plain(p, x)
    _close(out.reshape(want.shape), want, dtype)


def _wa_base(geo, zz, hh, win):
    """wattn_mma.cuh's wa_base: the first row of window ``win`` (b = win
    / nlon, l = win % nlon) of type (zz, hh)."""
    nz, nlat, nlon, n = geo
    b, l = win // nlon, win % nlon
    return (((b * nz + zz) * nlat + hh) * nlon + l) * n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [True, False])
def test_window_attention_walk_model_matches_plain(masked, dtype):
    """The bf16 route's steps on flat rows: the qkv product with
    QScaleEpi's rounding, then one (type, head) at a time the windows of
    that type at wa_base of the launch's grid (nz, nlat, nlon, N as
    window_attn.cu builds its WmShape), the float32 table slice of that
    type and head as the bias, logits q k^T + bias (scale 1), P and o
    rounded, then the proj product; every row of o written once, against
    ``window_attention_plain`` (float32 1e-6, bf16 2^-6 of the output's
    max)."""
    nwin, ntype, n, c, heads = 3, 4, 24, 16, 2
    hd = c // heads
    rng = np.random.default_rng(16)

    def r(*shape, s=0.3):
        return torch.as_tensor((rng.normal(size=shape) * s)
                               .astype(np.float32)).to(dtype)

    x = r(nwin, ntype, n, c, s=1.0)
    wqkv, bqkv, wp, bp = r(c, 3 * c), r(3 * c), r(c, c), r(c)
    bias = r(ntype, heads, n, n).float()
    if masked:
        bias[:, :, : n // 2, n // 2:] -= 100.0
    shape = re.search(r"const WmShape s = \{([^}]*)\};",
                      (CSRC / "window_attn.cu").read_text()).group(1)
    nz, nlat, nlon, nn = (eval(v, {"ntype": ntype, "N": n})
                          for v in shape.split(",")[:4])
    assert nn == n
    rows = x.reshape(-1, c)
    qkv = (rows.float() @ wqkv.float() + bqkv.float()).to(dtype)
    scale_t = torch.tensor(hd ** -0.5, dtype=dtype).float()
    qkv[:, :c] = (qkv[:, :c].float() * scale_t).to(dtype)
    o = torch.full((rows.shape[0], c), float("nan"), dtype=dtype)
    writes = torch.zeros(rows.shape[0], c, dtype=torch.int32)
    for ty in range(nz * nlat):
        zz, hh = ty // nlat, ty % nlat
        for h in range(heads):
            tab = bias[ty, h]
            for win in range(nwin * nlon):
                r0 = _wa_base((nz, nlat, nlon, n), zz, hh, win)
                t = qkv[r0:r0 + n]
                q, k, v = (t[:, i * c + h * hd:i * c + (h + 1) * hd].float()
                           for i in range(3))
                pr = torch.softmax(q @ k.T + tab, -1).to(dtype)
                o[r0:r0 + n, h * hd:(h + 1) * hd] = (
                    pr.float() @ v).to(dtype)
                writes[r0:r0 + n, h * hd:(h + 1) * hd] += 1
    assert bool((writes == 1).all())
    out = (o.float() @ wp.float() + bp.float()).to(dtype)
    want = window_attention_plain(x, wqkv, bqkv, wp, bp, bias)
    _close(out.reshape(want.shape), want, dtype)

"""The port's window-major stage chain at ``lat_group=2`` (interior blocks
through ``block_wm_group``) against the JAX package's ``run_stage_wm``
(``io_layout="wm"``, ``lat_group=2``, interior blocks through
``_block_wm_group_call``) run in Pallas interpret mode.  TINY, float32, erf
GELU: stage 1 (nlat 2, one group of 2), stage 1 of TINY with lat 161 (nlat
4, two groups, the shifted block's stitch crossing the group edge), each at
depths 2 and 4, and stage 0 at depth 2 (nlat 3, so gh falls back to 1).
The grouped block with per-sample stochastic-depth scales (``drop``, batch 2)
against ``_block_wm_group_call(drop=...)``, shifted and unshifted, on both
geometries.  Tolerance: max abs error 5e-5, as for the ungrouped chain."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu_torch.config import TINY, _pick_gh
from pangu_tpu_torch.ops import earth_block_wm as W

TOL = 5e-5
CASES = {"TINY": (JAX_TINY, TINY),
         "lat161": (dataclasses.replace(JAX_TINY, lat=161),
                    dataclasses.replace(TINY, lat=161))}


def _wm_input(geom, seed):
    wz, wh, ww = geom.window
    return TP.normal((1, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                      wz * wh * ww, geom.dim), seed)


@pytest.fixture(scope="module")
def params():
    return {case: TP.jax_and_port_params(jcfg, seed=4)
            for case, (jcfg, _) in CASES.items()}


@pytest.mark.parametrize("case,stage_idx,gh,depth", [
    ("TINY", 1, 2, 2), ("TINY", 1, 2, 4), ("lat161", 1, 2, 2),
    ("lat161", 1, 2, 4), ("TINY", 0, 1, 2)])
def test_grouped_stage_matches_jax(params, case, stage_idx, gh, depth):
    jcfg, cfg = CASES[case]
    geom = cfg.stage(stage_idx)
    assert _pick_gh(geom.h_padded // geom.window[1], 2) == gh
    jparams, params = params[case]
    jblocks = jparams["stages"][stage_idx]["blocks"]
    blocks = params["stages"][stage_idx]["blocks"]
    xs = _wm_input(geom, 40 + stage_idx)   # pad rows hold noise: zeroed on read
    with pltpu.force_tpu_interpret_mode():
        want, want_off = JW.run_stage_wm({"blocks": (jblocks * 2)[:depth]},
                                         jnp.asarray(xs),
                                         jcfg.stage(stage_idx),
                                         io_layout="wm", lat_group=2)
    got, off = W.run_stage_wm({"blocks": (blocks * 2)[:depth]},
                              torch.as_tensor(xs), geom, lat_group=2)
    assert off == tuple(want_off)
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("lat_group,want_calls", [(1, 0), (2, 4)])
def test_interior_blocks_dispatch_to_the_grouped_wrapper(params, monkeypatch,
                                                         lat_group,
                                                         want_calls):
    """At gh > 1 every wm -> wm block goes through ``block_wm_group`` with
    that gh, as ``_block_wm_group_call`` takes them in the JAX package."""
    _, params = params["lat161"]
    cfg = CASES["lat161"][1]
    geom = cfg.stage(1)
    calls = []
    real = W.block_wm_group

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(W, "block_wm_group", spy)
    xs = torch.as_tensor(_wm_input(geom, 44))
    blocks = params["stages"][1]["blocks"]
    got, _ = W.run_stage_wm({"blocks": blocks * 2}, xs, geom,
                            lat_group=lat_group)
    want, _ = W.run_stage_wm({"blocks": blocks * 2}, xs, geom, kernels=False)
    assert calls == [2] * want_calls
    assert torch.equal(got, want)


def test_grouped_wrapper_runs_plain_version_on_cpu(params, monkeypatch):
    """A CPU tensor never reaches the kernel library (nor the launch count);
    the grouped block computes the ungrouped block's function."""
    from pangu_tpu_torch import _build

    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_library)
    _, params = params["TINY"]
    geom = TINY.stage(1)
    bp = params["stages"][1]["blocks"][1]
    xs = torch.as_tensor(_wm_input(geom, 45))
    ids = torch.as_tensor(W.window_region_ids(geom.z, geom.h_padded,
                                              geom.window))
    before = W.block_wm_group.launches
    got = W.block_wm_group(bp, xs, geom, (1, 3, 6), 3, ids, False, 2)
    want = W.block_wm_plain(bp, xs, geom, (1, 3, 6), 3, ids, False)
    assert torch.equal(got, want)
    assert W.block_wm_group.launches == before


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shifted", [True, False])
def test_grouped_block_with_drop_matches_jax(params, case, shifted):
    jcfg, cfg = CASES[case]
    geom = cfg.stage(1)
    jparams, params = params[case]
    jbp = jparams["stages"][1]["blocks"][1]
    bp = params["stages"][1]["blocks"][1]
    wz, wh, ww = geom.window
    xs = TP.normal((2, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                    wz * wh * ww, geom.dim), 46)
    drop = np.asarray([[0.8, 1.25], [1.25, 0.0]], np.float32)
    ids = (W.window_region_ids(geom.z, geom.h_padded, geom.window) if shifted
           else None)
    delta, canon_add = ((1, 3, 6), 3) if shifted else ((-1, -3, -6), 0)
    with pltpu.force_tpu_interpret_mode():
        want = JW._block_wm_group_call(
            jbp, jnp.asarray(xs), jcfg.stage(1), delta, canon_add,
            None if ids is None else jnp.asarray(ids), False, 2,
            drop=jnp.asarray(drop))
    got = W.block_wm_group(bp, torch.as_tensor(xs), geom, delta, canon_add,
                           None if ids is None else torch.as_tensor(ids),
                           False, 2, torch.as_tensor(drop))
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL
    # the scales reach the output: sample 1's MLP branch is cut
    plain = W.block_wm_plain(bp, torch.as_tensor(xs), geom, delta, canon_add,
                             None if ids is None else torch.as_tensor(ids),
                             False)
    assert not torch.equal(got, plain)

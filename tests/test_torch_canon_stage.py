"""The port's canonical-layout stage chain (``run_stage_wm(io_layout=
"canon")``: the first block reads the canonical grid, the last writes it,
one roll and crop at the end) against the JAX package's ``run_stage_wm``
(``io_layout="canon"``, end-point blocks through ``_block_wm_call`` with
``in_layout`` / ``out_layout="canon"``) in Pallas interpret mode.  TINY,
float32, erf GELU, stages 0 and 1 at depths 2 and 4, ``lat_group`` 1 and 2
(at stage 1 depth 4 with ``lat_group=2`` the two interior blocks are
grouped; stage 0 falls back to one window per program).  Tolerance: max
abs error 5e-5."""

import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import earth_block_wm as W

TOL = 5e-5


@pytest.fixture(scope="module")
def params():
    return TP.jax_and_port_params(JAX_TINY, seed=6)


@pytest.mark.parametrize("stage_idx,depth,lat_group", [
    (0, 2, 1), (0, 4, 2), (1, 2, 2), (1, 4, 1), (1, 4, 2)])
def test_canon_stage_matches_jax(params, stage_idx, depth, lat_group):
    jparams, params = params
    jblocks = jparams["stages"][stage_idx]["blocks"]
    blocks = params["stages"][stage_idx]["blocks"]
    geom = TINY.stage(stage_idx)
    x = TP.normal((1, geom.z, geom.h, geom.w, geom.dim), 50 + stage_idx)
    with pltpu.force_tpu_interpret_mode():
        want = JW.run_stage_wm({"blocks": (jblocks * 2)[:depth]},
                               jnp.asarray(x), JAX_TINY.stage(stage_idx),
                               io_layout="canon", lat_group=lat_group)
    got = W.run_stage_wm({"blocks": (blocks * 2)[:depth]}, torch.as_tensor(x),
                         geom, io_layout="canon", lat_group=lat_group)
    assert got.shape == want.shape == x.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("in_layout,out_layout",
                         [("canon", "wm"), ("wm", "canon"), ("canon", "canon")])
def test_canon_block_is_the_relayout_around_the_block(params, in_layout,
                                                      out_layout):
    """The end-point block equals the wm block between the relayouts, and a
    CPU tensor runs that plain composition."""
    _, params = params
    geom = TINY.stage(0)
    bp = params["stages"][0]["blocks"][0]
    grid = torch.as_tensor(TP.normal((1, geom.z, geom.h_padded, geom.w,
                                      geom.dim), 52))
    xs = W.to_window_major(grid, geom.window)
    want = W.block_wm_plain(bp, xs, geom, (0, 0, 0), 0, None, False)
    if out_layout == "canon":
        want = W.from_window_major(want, geom.window)
    x = grid if in_layout == "canon" else xs
    before = W.block_wm_canon.launches
    got = W.block_wm_canon(bp, x, geom, (0, 0, 0), 0, None, False,
                           in_layout=in_layout, out_layout=out_layout)
    assert torch.equal(got, want)
    assert W.block_wm_canon.launches == before


def test_canon_entry_block_must_be_unshifted(params):
    _, params = params
    geom = TINY.stage(0)
    grid = torch.zeros((1, geom.z, geom.h_padded, geom.w, geom.dim))
    with pytest.raises(ValueError, match="unshifted"):
        W.block_wm_canon(params["stages"][0]["blocks"][1], grid, geom,
                         (1, 3, 6), 3, None, False, in_layout="canon")

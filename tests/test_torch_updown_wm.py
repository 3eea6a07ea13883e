"""The port's window-major DownSample / UpSample against the JAX package's
``down_sample_wm`` / ``up_sample_wm`` in Pallas interpret mode.  TINY,
float32, with and without a stage-end offset.  UpSample is compared on valid
latitude rows only: the JAX kernel leaves junk in its pad rows (the next
block zero-synthesises them), the port writes zeros there.  Tolerance: max
abs error 5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu.ops import updown_wm as JU
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import earth_block_wm as W
from pangu_tpu_torch.ops import updown_wm as U

TOL = 5e-5


def _wm_input(geom, seed):
    wz, wh, ww = geom.window
    return TP.normal((1, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                      wz * wh * ww, geom.dim), seed)


@pytest.fixture(scope="module")
def params():
    return TP.jax_and_port_params(JAX_TINY, seed=5)


@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_down_sample_wm_matches_jax(params, off):
    jparams, tparams = params
    g0, g1 = TINY.stage(0), TINY.stage(1)
    xs = _wm_input(g0, 30)
    with pltpu.force_tpu_interpret_mode():
        want = JU.down_sample_wm(jparams["downsample"], jnp.asarray(xs),
                                 JAX_TINY.stage(0), JAX_TINY.stage(1), off)
    got = U.down_sample_wm(tparams["downsample"], torch.as_tensor(xs), g0, g1,
                           off)
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL   # pad rows are zeros in both


@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_up_sample_wm_matches_jax_on_valid_rows(params, off):
    jparams, tparams = params
    g2, g3 = TINY.stage(2), TINY.stage(3)
    xs = _wm_input(g2, 31)
    with pltpu.force_tpu_interpret_mode():
        want = JU.up_sample_wm(jparams["upsample"], jnp.asarray(xs),
                               JAX_TINY.stage(2), JAX_TINY.stage(3), off)
    got = U.up_sample_wm(tparams["upsample"], torch.as_tensor(xs), g2, g3, off)
    assert got.shape == want.shape
    want_valid = np.asarray(JW.from_window_major(want, g3.window))[:, :, :g3.h]
    got_grid = W.from_window_major(got, g3.window)
    assert TP.max_abs_err(got_grid[:, :, :g3.h], want_valid) <= TOL
    assert not got_grid[:, :, g3.h:].any()

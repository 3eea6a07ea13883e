"""The port's window-major stage chain (``run_stage_wm``, wm in / wm out,
one lat window per program) against the JAX package's ``run_stage_wm``
(``io_layout="wm"``, ``lat_group=1``) run in Pallas interpret mode, as
tests/test_ops.py runs it.  TINY, float32, erf GELU.  Stages 0 and 1 at
depths 2 and 4 cover the unshifted block, the shifted block with its region
mask, and the inverse-offset read of the block after a shifted one.
Tolerance: max abs error 5e-5 (the JAX test's own 3e-5 plus float32
reassociation between the frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import earth_block_wm as W

TOL = 5e-5


def _wm_input(geom, seed):
    wz, wh, ww = geom.window
    return TP.normal((1, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                      wz * wh * ww, geom.dim), seed)


@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("depth", [2, 4])
def test_run_stage_wm_matches_jax(stage_idx, depth):
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=stage_idx)
    jblocks = jparams["stages"][stage_idx]["blocks"]
    blocks = params["stages"][stage_idx]["blocks"]
    geom = TINY.stage(stage_idx)
    xs = _wm_input(geom, 10 + stage_idx)   # pad rows hold noise: zeroed on read

    with pltpu.force_tpu_interpret_mode():
        want, want_off = JW.run_stage_wm({"blocks": (jblocks * 2)[:depth]},
                                         jnp.asarray(xs),
                                         JAX_TINY.stage(stage_idx),
                                         io_layout="wm", lat_group=1)
    got, off = W.run_stage_wm({"blocks": (blocks * 2)[:depth]},
                              torch.as_tensor(xs), geom)
    assert off == tuple(want_off)
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
@pytest.mark.parametrize("stage_idx", [0, 1])
def test_wm_to_canonical_matches_jax_roll_and_crop(stage_idx, off):
    """The one roll+crop helper equals the JAX code's inline
    from_window_major -> jnp.roll(off) -> crop (pangu.py:673)."""
    geom = TINY.stage(stage_idx)
    xs = _wm_input(geom, 20)
    want = jnp.roll(JW.from_window_major(jnp.asarray(xs), geom.window), off,
                    axis=(1, 2, 3))[:, :, :geom.h]
    got = W.wm_to_canonical(torch.as_tensor(xs), off, geom)
    np.testing.assert_array_equal(TP.to_np(got), np.asarray(want))


def test_window_major_layout_matches_jax():
    geom = TINY.stage(0)
    x = TP.normal((2, geom.z, geom.h_padded, geom.w, 3), 21)
    want = JW.to_window_major(jnp.asarray(x), geom.window)
    got = W.to_window_major(torch.as_tensor(x), geom.window)
    np.testing.assert_array_equal(TP.to_np(got), np.asarray(want))
    back = W.from_window_major(got, geom.window)
    np.testing.assert_array_equal(TP.to_np(back), x)


def test_block_wrapper_runs_plain_version_on_cpu(monkeypatch):
    """A CPU tensor never reaches the kernel library (nor its launch count)."""
    from pangu_tpu_torch import _build

    def no_library():
        raise AssertionError("kernel library used for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_library)
    _, params = TP.jax_and_port_params(JAX_TINY, seed=0)
    geom = TINY.stage(0)
    xs = torch.as_tensor(_wm_input(geom, 22))
    before = W.block_wm.launches
    got = W.block_wm(params["stages"][0]["blocks"][0], xs, geom, (0, 0, 0), 0,
                     None, False)
    want = W.block_wm_plain(params["stages"][0]["blocks"][0], xs, geom,
                            (0, 0, 0), 0, None, False)
    assert torch.equal(got, want)
    assert W.block_wm.launches == before

"""The port's token-space transition against the JAX package's: the
composed operator of ``build_transition`` / ``build_transition_wm`` leaf by
leaf (tolerance 1e-5: float32 products of the same weights, summed in
another order), and ``apply_transition_wm`` (on CPU tensors: its plain
version) against JAX ``apply_transition_wm`` in Pallas interpret mode on
rolled window-major storage with 50x junk in the latitude-pad rows, valid
rows only (tolerance 2e-4 abs, as ``tests/test_transition.py`` holds the JAX
kernel).  TINY, float32: its odd levels (5) and lat (49) exercise both crop
edges of the composed matrices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine import transition as JT
from pangu_tpu.engine import transition_wm as JTW
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import (denorm_data, synthetic_constants,
                                            to_device)
from pangu_tpu_torch.engine import transition as T
from pangu_tpu_torch.engine import transition_wm as TW
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.ops.earth_block_wm import (from_window_major,
                                                to_window_major)

TOL_LEAF = 1e-5
TOL = 2e-4
B = 2
LEAVES = ["M_s", "M_sh", "M_u", "M_uh", "M_uz", "M_uzh", "bias_field",
          "bias_field_wm"]


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=31)
    consts = synthetic_constants(TINY)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    tc = to_device(consts, "cpu")
    return (jparams, params, JTW.build_transition_wm(jparams, jc, JAX_TINY),
            TW.build_transition_wm(params, tc, TINY), tc)


@pytest.mark.parametrize("leaf", LEAVES)
def test_build_transition_leaf_matches_jax(setup, leaf):
    _, _, want, got, _ = setup
    assert got[leaf].shape == want[leaf].shape
    assert got[leaf].dtype == torch.float32
    assert TP.max_abs_err(got[leaf], want[leaf]) <= TOL_LEAF


def _pair(seed):
    g = TINY.stage(0)
    return TP.normal((B, g.z, g.h, g.w, g.dim), seed)


def _rolled(x, off, seed):
    """Canonical (B, Z, H, W, C) -> rolled wm storage with 50x junk in the
    latitude-pad rows."""
    g = TINY.stage(0)
    junk = 50.0 * TP.normal((B, g.z, g.h_padded - g.h, g.w, g.dim), seed)
    xp = np.concatenate([x, junk], axis=2)
    xp = np.roll(xp, tuple(-o for o in off), axis=(1, 2, 3))
    return to_window_major(torch.as_tensor(xp), g.window).numpy()


@pytest.mark.parametrize("off", [(0, 0, 0), (1, 3, 6)])
def test_apply_transition_wm_matches_jax_on_valid_rows(setup, off):
    _, _, jtp, tp, _ = setup
    g = TINY.stage(0)
    skip = _rolled(_pair(32), off, 33)
    dec = _rolled(_pair(34), off, 35)
    with pltpu.force_tpu_interpret_mode():
        want = JTW.apply_transition_wm(jtp, jnp.asarray(skip),
                                       jnp.asarray(dec), JAX_TINY.stage(0), off)
    got = TW.apply_transition_wm(tp, torch.as_tensor(skip),
                                 torch.as_tensor(dec), g, off)
    assert got.shape == want.shape
    got_grid = from_window_major(got, g.window)
    want_grid = from_window_major(torch.as_tensor(np.array(want)), g.window)
    assert TP.max_abs_err(got_grid[:, :, :g.h], want_grid[:, :, :g.h]) <= TOL
    assert torch.count_nonzero(got_grid[:, :, g.h:]) == 0
    assert TW.apply_transition_wm.launches == 0


def test_apply_transition_matches_jax(setup):
    _, _, jtp, tp, _ = setup
    skip, dec = _pair(36), _pair(37)
    want = JT.apply_transition(jtp, (jnp.asarray(skip), jnp.asarray(dec)))
    got = T.apply_transition(tp, (torch.as_tensor(skip), torch.as_tensor(dec)))
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL
    cat = T.apply_transition(tp, torch.cat([torch.as_tensor(skip),
                                            torch.as_tensor(dec)], -1))
    assert TP.max_abs_err(cat, got) <= TOL


def test_transition_equals_the_canonical_round_trip(setup):
    """apply_transition == embed(renorm(crop(denorm(recovery(x))))) in the
    port itself: recovery, de-normalisation and the next embed."""
    _, params, _, tp, tc = setup
    parts = (torch.as_tensor(_pair(38)), torch.as_tensor(_pair(39)))
    raw = denorm_data(*L.patch_recovery(params["patch_recovery"], parts, TINY),
                      tc)
    want = L.patch_embed(params["patch_embed"], *raw, tc, TINY)
    got = T.apply_transition(tp, parts)
    assert got.shape == want.shape
    assert TP.max_abs_err(got, want) <= TOL

"""The port's ``recovery_wm`` (on CPU tensors: its plain versions) against
the JAX package's ``recovery_wm`` in Pallas interpret mode, as
``tests/test_ops.py`` runs it: TINY, float32, batch 2, rolled window-major
skip/decoder storage, offsets (0, 0, 0) and the served (1, 3, 6).
Tolerance: max abs error 5e-5 (float32 reassociation of a 2C-term sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import recovery_wm as JR
from pangu_tpu_torch.config import TINY, recovery_supported
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.ops import recovery_wm as R

TOL = 5e-5
B = 2
OFFSETS = [(0, 0, 0), (1, 3, 6)]


def _storage(seed):
    g = TINY.stage(3)
    wz, wh, ww = g.window
    return TP.normal((B, g.z // wz, g.h_padded // wh, g.w // ww,
                      wz * wh * ww, g.dim), seed)


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=21)
    return jparams, params, _storage(22), _storage(23)


@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_wm_matches_jax(setup, off):
    jparams, params, skip, dec = setup
    assert recovery_supported(TINY) and JR.recovery_supported(JAX_TINY)
    with pltpu.force_tpu_interpret_mode():
        want = JR.recovery_wm(jparams["patch_recovery"], jnp.asarray(skip),
                              jnp.asarray(dec), off, JAX_TINY)
    got = R.recovery_wm(params["patch_recovery"], torch.as_tensor(skip),
                        torch.as_tensor(dec), off, TINY)
    assert got[0].shape == (B, 5, TINY.levels, TINY.lat, TINY.lon)
    assert got[1].shape == (B, 4, TINY.lat, TINY.lon)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_wm_branches_equal_patch_recovery(setup, off):
    """Each branch wrapper, on CPU tensors, equals the served recovery of
    the canonical pair (roll back by ``off``, crop the lat padding)."""
    _, params, skip, dec = setup
    g = TINY.stage(3)
    wz, wh, ww = g.window

    def canonical(x):
        t = torch.as_tensor(x).reshape(B, g.z // wz, g.h_padded // wh,
                                       g.w // ww, wz, wh, ww, g.dim)
        t = t.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, g.z, g.h_padded,
                                                       g.w, g.dim)
        return torch.roll(t, off, dims=(1, 2, 3))[:, :, :g.h]

    want = L.patch_recovery(params["patch_recovery"],
                            (canonical(skip), canonical(dec)), TINY)
    s, d = torch.as_tensor(skip), torch.as_tensor(dec)
    got = (R.recovery_wm_upper(params["patch_recovery"], s, d, off, TINY),
           R.recovery_wm_surface(params["patch_recovery"], s, d, off, TINY))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert R.recovery_wm_upper.launches == R.recovery_wm_surface.launches == 0

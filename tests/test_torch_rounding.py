"""The port's patch embed and patch recovery round where the JAX package's
``patch_embed`` / ``patch_recovery`` round in bf16: the statistics cast to
the compute dtype and the fields normalised in it; each projection term (or
each part's product in ``dense_split_rows``) summed in float32 and rounded
once; the terms and the bias added in the dtype.  TINY, bf16, the same bf16
inputs and parameters on both sides.

Tolerances, in bf16 ulps of the output's magnitude (ulp(m) = 2**(floor(log2
m) - 7) at m = max |JAX output|): the largest difference at most half an
ulp, and at most one element in a thousand differing at all.  With the same
rounding points the two differ only where a float32 sum taken in another
order rounds the other way; with float32 normalisation and one rounding (the
port before this rule) the largest difference is a whole ulp and about half
of all elements differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.models import layers as JL
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.models import layers as L

MAX_ULPS = 0.5
MAX_DIFFERING = 1e-3


def _check(got, want):
    g = TP.to_np(got)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert np.abs(g - w).max() <= MAX_ULPS * ulp
    assert (g != w).mean() <= MAX_DIFFERING


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=7)
    consts = synthetic_constants(TINY)
    upper = consts["upper_mean"][None] + consts["upper_std"][None] * TP.normal(
        (1, 5, TINY.levels, TINY.lat, TINY.lon), 1)
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * TP.normal((1, 4, TINY.lat, TINY.lon), 2))
    return jparams, params, consts, upper, surface


def test_patch_embed_rounds_as_jax_in_bf16(setup):
    jparams, params, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    want = jax.jit(lambda p, u, s: JL.patch_embed(p, u, s, jc, JAX_TINY))(
        jparams["patch_embed"], jnp.asarray(upper, jnp.bfloat16),
        jnp.asarray(surface, jnp.bfloat16))
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    got = L.patch_embed(params["patch_embed"],
                        torch.as_tensor(upper).bfloat16(),
                        torch.as_tensor(surface).bfloat16(), tc, TINY)
    assert got.dtype == torch.bfloat16
    _check(got, want)


def test_patch_recovery_rounds_as_jax_in_bf16(setup):
    jparams, params, _, _, _ = setup
    shape = (1, TINY.z_tokens, TINY.h_tokens, TINY.w_tokens, TINY.dims[3])
    skip, dec = TP.normal(shape, 3), TP.normal(shape, 4)
    want = jax.jit(lambda p, a, b: JL.patch_recovery(p, (a, b), JAX_TINY))(
        jparams["patch_recovery"], jnp.asarray(skip, jnp.bfloat16),
        jnp.asarray(dec, jnp.bfloat16))
    got = L.patch_recovery(params["patch_recovery"],
                           (torch.as_tensor(skip).bfloat16(),
                            torch.as_tensor(dec).bfloat16()), TINY)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _check(g, w)

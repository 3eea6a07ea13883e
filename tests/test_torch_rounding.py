"""The port's patch embed and patch recovery round where the JAX package's
``patch_embed`` / ``patch_recovery`` round in bf16: the statistics cast to
the compute dtype and the fields normalised in it; each projection term (or
each part's product in ``dense_split_rows``) summed in float32 and rounded
once; the terms and the bias added in the dtype.  The plain versions of two
kernels round where their Pallas kernels do (run in interpret mode): the
fused window attention (``window_attention_plain`` against
``window_attention_pallas``, with and without the shifted-window mask): q,
k, v rounded after their bias, q times the scale rounded in the dtype,
float32 logits plus the bias, P and o rounded, the proj sum rounded once;
and the canonical DownSample (``down_sample_plain`` against
``down_sample_fused``, an odd and an even latitude count): the LayerNorm in
float32 rounded once, the product rounded once.  The bf16 kernels on the
card are held to these plain versions.  TINY, bf16, the same bf16 inputs
and parameters on both sides.

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

from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.models import layers as JL
from pangu_tpu.ops import updown as JU
from pangu_tpu.ops import window_attention as JW
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.ops import updown as U
from pangu_tpu_torch.ops import window_attention as W

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


def _bf16_pair(tree):
    """A (JAX, port) pair of the same bf16 values of a numpy tree."""
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return jt, jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).bfloat16(), jt)


@pytest.mark.parametrize("masked", [True, False])
def test_window_attention_rounds_as_jax_in_bf16(masked):
    """Windows (1 sample, 2 longitude windows, 3 types, N 144, C 16, 2
    heads): the plain version (q scaled in the dtype) against the Pallas
    kernel's own rounding."""
    nlon, ntype, n, c, heads = 2, 3, 144, 16, 2
    rng = np.random.default_rng(21)

    def r(*shape, s=0.3):
        return (rng.normal(size=shape) * s).astype(np.float32)

    jp, p = _bf16_pair({"qkv": {"kernel": r(c, 3 * c), "bias": r(3 * c)},
                        "proj": {"kernel": r(c, c), "bias": r(c)},
                        "bias_table": r(ntype, heads, n, n)})
    jx, x = _bf16_pair(r(1, nlon, ntype, n, c, s=1.0))
    ids = L.window_region_ids(4, 18, (2, 6, 12))[:ntype] if masked else None
    mask = None
    if masked:
        jids = jnp.asarray(ids)
        mask = jnp.where(jids[:, None, :] != jids[:, :, None],
                         jnp.float32(-100.0), jnp.float32(0.0))
    with pltpu.force_tpu_interpret_mode():
        want = JW.window_attention_pallas(jp, jx, heads, mask)
    got = W.window_attention_pallas(
        p, x, heads, None if ids is None else torch.as_tensor(ids))
    assert got.dtype == torch.bfloat16
    _check(got, want)


@pytest.mark.parametrize("h", [TINY.h_tokens, TINY.h_tokens - 1])
def test_down_sample_rounds_as_jax_in_bf16(setup, h):
    """The stage-0 grid with an odd and an even latitude count: the plain
    version against the Pallas kernel (its zero pad row, LayerNorm with
    float32 statistics rounded once, the product rounded once)."""
    jparams, params = setup[0], setup[1]
    g0 = TINY.stage(0)
    jd, d = _bf16_pair(jax.tree.map(np.asarray, jparams["downsample"]))
    jx, x = _bf16_pair(TP.normal((2, g0.z, h, g0.w, g0.dim), 22))
    with pltpu.force_tpu_interpret_mode():
        want = JU.down_sample_fused(jd, jx)
    got = U.down_sample(d, x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _check(got, want)

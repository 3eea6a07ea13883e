"""The port's canonical-layout DownSample / UpSample (``ops/updown``)
against the JAX package's ``down_sample_fused`` / ``up_sample_fused`` (the
Pallas kernels ``_down_pallas`` / ``_up_pallas``) in interpret mode.  TINY
widths, float32, with odd and even latitude counts: DownSample's zero pad
row, its merge order (h_off, w_off, C), UpSample's depth-to-space order
and its crop.  Tolerance: max abs error 5e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import updown as JU
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import updown as U

TOL = 5e-5


@pytest.fixture(scope="module")
def params():
    return TP.jax_and_port_params(JAX_TINY, seed=9)


@pytest.mark.parametrize("h", [TINY.h_tokens, TINY.h_tokens - 1])
def test_down_sample_matches_jax(params, h):
    jparams, tparams = params
    g0 = TINY.stage(0)
    x = TP.normal((2, g0.z, h, g0.w, g0.dim), 60)
    with pltpu.force_tpu_interpret_mode():
        want = JU.down_sample_fused(jparams["downsample"], jnp.asarray(x))
    got = U.down_sample(tparams["downsample"], torch.as_tensor(x))
    assert got.shape == want.shape == (2, g0.z, -(-h // 2), g0.w // 2,
                                       2 * g0.dim)
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("out_h", [TINY.h_tokens, TINY.h_tokens + 1])
def test_up_sample_matches_jax(params, out_h):
    jparams, tparams = params
    g2 = TINY.stage(2)
    x = TP.normal((2, g2.z, g2.h, g2.w, g2.dim), 61)
    with pltpu.force_tpu_interpret_mode():
        want = JU.up_sample_fused(jparams["upsample"], jnp.asarray(x), out_h)
    got = U.up_sample(tparams["upsample"], torch.as_tensor(x), out_h)
    assert got.shape == want.shape == (2, g2.z, out_h, 2 * g2.w, TINY.dims[3])
    assert TP.max_abs_err(got, want) <= TOL


def test_down_sample_merge_order_pinned():
    """With a unit LayerNorm and a selection matrix, output feature k*C + c
    of DownSample is LN of input (2i + k // 2, 2j + k % 2, c): the merge
    order (h_off, w_off, C)."""
    C = 4
    x = torch.as_tensor(TP.normal((1, 1, 3, 4, C), 62))
    p = {"norm": {"scale": torch.ones(4 * C), "bias": torch.zeros(4 * C)},
         "reduce": {"kernel": torch.eye(4 * C)[:, :2 * C]}}
    cat = torch.zeros((1, 1, 2, 2, 4 * C))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))
    for k in range(4):
        cat[..., k * C:(k + 1) * C] = xp[:, :, k // 2::2, k % 2::2]
    mu = cat.mean(-1, keepdim=True)
    want = ((cat - mu) / torch.sqrt(cat.var(-1, unbiased=False, keepdim=True)
                                     + 1e-5))[..., :2 * C]
    got = U.down_sample(p, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_up_sample_interleave_order_pinned():
    """With an identity expand, output (2i + ho, 2j + wo) before the norm is
    input (i, j) feature block (2 * ho + wo): the (h_off, w_off) order."""
    C = 4
    x = torch.as_tensor(TP.normal((1, 1, 2, 3, 4 * C), 63))
    ident = {"kernel": torch.eye(C)}
    p = {"expand": {"kernel": torch.eye(4 * C)}, "mix": ident,
         "norm": {"scale": torch.ones(C), "bias": torch.zeros(C)}}
    got = U.up_sample(p, x, 3)
    for i in range(3):
        for j in range(6):
            blk = x[0, 0, i // 2, j // 2, (2 * (i % 2) + j % 2) * C:][:C]
            want = (blk - blk.mean()) / torch.sqrt(blk.var(unbiased=False)
                                                   + 1e-5)
            np.testing.assert_allclose(got[0, 0, i, j].numpy(), want.numpy(),
                                       atol=1e-5)

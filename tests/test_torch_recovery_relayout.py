"""The bf16 recovery backward's relayout and the algebra of its route, on
the CPU at TINY in float32, batch 2, the pair's offsets (0, 0, 0) and the
served (1, 3, 6):

* ``ops/recovery_wm.py::field_cotangent_wm`` (the matrix dF_wm that
  ``csrc/recovery_bwd.cu`` writes before its products; on CPU tensors
  ``field_cotangent_wm_kernel`` is the same function) against the JAX
  package's ``_feat_cotangents`` placed in the pair's rolled window-major
  storage: equal, a permutation of the field cotangents with zeros;
* the plain recovery backward's outputs from dF_wm alone, as the route
  forms them: the token cotangents dF_wm [Ku | Ks]^T, the heads' weight and
  bias gradients [skip | dec | 1]^T dF_wm summed over every storage row, the
  pair's latitude-pad rows holding finite junk: 1e-5 of each output's max
  (float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu.ops import recovery_wm as JR
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import recovery_wm as R
from pangu_tpu_torch.ops.earth_block_wm import (from_window_major,
                                                to_window_major)

B = 2
OFFSETS = [(0, 0, 0), (1, 3, 6)]


def _cotangents(seed):
    return (TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), seed),
            TP.normal((B, 4, TINY.lat, TINY.lon), seed + 1))


@pytest.mark.parametrize("off", OFFSETS)
def test_field_cotangent_wm_matches_jax_rolled_to_storage(off):
    du, ds = _cotangents(70)
    g = TINY.stage(3)
    dF_u, dF_s = JR._feat_cotangents(jnp.asarray(du), jnp.asarray(ds),
                                     JAX_TINY)
    fu, fs = dF_u.shape[-1], dF_s.shape[-1]
    t = jnp.concatenate([jnp.pad(dF_s, ((0, 0),) * 3 + ((fu, 0),))[:, None],
                         jnp.pad(dF_u, ((0, 0),) * 4 + ((0, fs),))], axis=1)
    t = jnp.pad(t, ((0, 0), (0, 0), (0, g.h_padded - g.h), (0, 0), (0, 0)))
    t = jnp.roll(t, shift=tuple(-o for o in off), axis=(1, 2, 3))
    want = np.asarray(JW.to_window_major(t, g.window))
    got = R.field_cotangent_wm(torch.as_tensor(du), torch.as_tensor(ds), off,
                               TINY)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    via = R.field_cotangent_wm_kernel(torch.as_tensor(du),
                                      torch.as_tensor(ds), off, TINY)
    assert torch.equal(via, got)


@pytest.mark.parametrize("off", OFFSETS)
def test_recovery_bwd_from_the_relayout(off):
    g = TINY.stage(3)
    c = g.dim
    wz, wh, ww = g.window
    shape = (B, g.z // wz, g.h_padded // wh, g.w // ww, wz * wh * ww, c)
    skip, dec = (torch.as_tensor(TP.normal(shape, s)) for s in (72, 73))
    pad = ((torch.arange(g.h_padded) + off[1]) % g.h_padded) >= g.h
    assert pad.any()
    for t in (skip, dec):            # finite junk on the pad rows
        grid = from_window_major(t, g.window)
        grid[:, :, pad] = 50.0 * grid[:, :, pad] + 7.0
        t.copy_(to_window_major(grid, g.window))
    du, ds = (torch.as_tensor(a) for a in _cotangents(74))
    r = np.random.default_rng(75)
    p = {h: {"kernel": torch.as_tensor(
        r.normal(size=(2 * c, f)).astype(np.float32))}
        for h, f in (("upper", 160), ("surface", 64))}
    grads, d_skip, d_dec = R.recovery_bwd_plain(p, skip, dec, du, ds, off,
                                                TINY)

    dF = R.field_cotangent_wm(du, ds, off, TINY).reshape(-1, 224)
    tok = dF @ torch.cat([p["upper"]["kernel"], p["surface"]["kernel"]],
                         dim=1).T
    rows = torch.cat([skip.reshape(-1, c), dec.reshape(-1, c),
                      torch.ones(dF.shape[0], 1)], dim=1)
    dk = rows.T @ dF

    def close(got, want):
        scale = float(want.abs().max())
        assert scale > 0 and float((got - want).abs().max()) <= 1e-5 * scale

    close(tok[:, :c], d_skip.reshape(-1, c))
    close(tok[:, c:], d_dec.reshape(-1, c))
    for head, cols in (("upper", slice(0, 160)), ("surface", slice(160, 224))):
        close(dk[:2 * c, cols], grads[head]["kernel"])
        close(dk[2 * c, cols], grads[head]["bias"])

"""The port's training edges against the JAX package at TINY, float32:

* the recovery backward (``recovery_bwd``, on CPU tensors its plain
  version) against ``recovery_bwd_pallas``, and the upper embed weight
  gradient (``embed_dw_upper``) against the JAX kernel, both in Pallas
  interpret mode, as tests/test_ops.py runs them, the pair rolled by the
  served offset (1, 3, 6): token cotangents 5e-5 abs; the weight and bias
  gradients, float32 sums over every token of magnitude ~100, 5e-5 x
  max |leaf|;
* the gradients of the differentiable edges ``embed_wm_train`` /
  ``recovery_wm_train`` (pair at offset (0, 0, 0)) against ``jax.grad`` of
  the XLA compositions they equal in the JAX package
  (``to_window_major(pad(patch_embed))``, ``patch_recovery`` of the
  canonicalised pair; tests/test_ops.py pins the JAX edges to them), and of
  ``down_sample_wm_train`` / ``up_sample_wm_train`` against ``jax.grad`` of
  the JAX versions in interpret mode: 5e-5 x max |leaf| (scales from ~0.2
  to ~200, printed).

Batch 2 (the recovery backward unit: batch 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.models import layers as JL
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu.ops import embed_wm as JE
from pangu_tpu.ops import recovery_wm as JR
from pangu_tpu.ops import updown_wm as JU
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.ops import embed_wm as E
from pangu_tpu_torch.ops import recovery_wm as R
from pangu_tpu_torch.ops import updown_wm as U

TOL = 5e-5
FLOOR = 1e-12     # of a leaf's scale, far below every leaf's max |leaf|
B = 2


def _storage(geom, seed):
    wz, wh, ww = geom.window
    return TP.normal((B, geom.z // wz, geom.h_padded // wh, geom.w // ww,
                      wz * wh * ww, geom.dim), seed)


def _close(got, want, scaled=False):
    want = np.asarray(want, np.float64)
    got = TP.to_np(got).astype(np.float64).reshape(want.shape)
    scale = max(FLOOR, float(np.max(np.abs(want)))) if scaled else 1.0
    err = float(np.max(np.abs(got - want)))
    print(f"max|want| {float(np.max(np.abs(want))):.3e} err {err:.3e} "
          f"rel {err / scale:.3e}" if scaled else f"err {err:.3e}")
    assert err <= TOL * scale


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=31)
    consts = synthetic_constants(TINY)
    upper = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), 32))
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * TP.normal((B, 4, TINY.lat, TINY.lon), 33))
    return jparams, params, consts, upper, surface


def test_recovery_bwd_matches_pallas(setup):
    jparams, params, _, _, _ = setup
    off = (1, 3, 6)
    g3 = TINY.stage(3)
    skip, dec = _storage(g3, 34), _storage(g3, 35)
    du = TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), 36)
    ds = TP.normal((B, 4, TINY.lat, TINY.lon), 37)
    with pltpu.force_tpu_interpret_mode():
        wdp, wsk, wdc = JR.recovery_bwd_pallas(
            jparams["patch_recovery"], jnp.asarray(skip), jnp.asarray(dec),
            jnp.asarray(du), jnp.asarray(ds), off, JAX_TINY)
    grads, gsk, gdc = R.recovery_bwd(params["patch_recovery"],
                                     torch.as_tensor(skip), torch.as_tensor(dec),
                                     torch.as_tensor(du), torch.as_tensor(ds),
                                     off, TINY)
    _close(gsk, wsk)
    _close(gdc, wdc)
    for head in ("upper", "surface"):
        for leaf in ("kernel", "bias"):
            _close(grads[head][leaf], wdp[head][leaf], scaled=True)


def test_embed_dw_upper_matches_pallas(setup):
    _, _, consts, upper, _ = setup
    dxs = _storage(TINY.stage(0), 38)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    with pltpu.force_tpu_interpret_mode():
        wdk, wdb = JE.embed_dw_upper(jnp.asarray(dxs), jnp.asarray(upper), jc,
                                     JAX_TINY)
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    dk, db = E.embed_dw_upper(torch.as_tensor(dxs), torch.as_tensor(upper), tc,
                              TINY)
    _close(dk, wdk, scaled=True)
    _close(db, wdb, scaled=True)


def _tree_close(got, want):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k])
    else:
        _close(got, want, scaled=True)


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad
            for k, v in tree.items()}


def _trainable(tree):
    return {k: _trainable(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tree.items()}


def test_embed_wm_train_grads_match_jax(setup):
    jparams, params, consts, upper, surface = setup
    g0 = TINY.stage(0)
    wt = TP.normal(_storage(g0, 0).shape, 39)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def loss(p, u, s):
        x = JL.patch_embed(p, u, s, jc, JAX_TINY)
        x = jnp.pad(x, ((0, 0), (0, 0), (0, g0.h_padded - x.shape[2]),
                        (0, 0), (0, 0)))
        return jnp.sum(JW.to_window_major(x, g0.window) * wt)

    wp, wu, ws = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jparams["patch_embed"], jnp.asarray(upper), jnp.asarray(surface))
    p = _trainable(params["patch_embed"])
    u = torch.as_tensor(upper).requires_grad_(True)
    s = torch.as_tensor(surface).requires_grad_(True)
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    (E.embed_wm_train(p, u, s, tc, TINY) * torch.as_tensor(wt)).sum().backward()
    _tree_close(_leaf_grads(p), wp)
    _close(u.grad, wu, scaled=True)
    _close(s.grad, ws, scaled=True)


def test_recovery_wm_train_grads_match_jax(setup):
    jparams, params, _, _, _ = setup
    g3 = TINY.stage(3)
    skip, dec = _storage(g3, 40), _storage(g3, 41)
    wu = TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), 42)
    ws = TP.normal((B, 4, TINY.lat, TINY.lon), 43)

    def loss(pr, ss, dd):
        canon = lambda t: JW.from_window_major(t, g3.window)[:, :, :g3.h]  # noqa: E731
        u, s = JL.patch_recovery(pr, (canon(ss), canon(dd)), JAX_TINY)
        return jnp.sum(u * wu) + jnp.sum(s * ws)

    wp, wsk, wdc = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jparams["patch_recovery"], jnp.asarray(skip), jnp.asarray(dec))
    p = _trainable(params["patch_recovery"])
    sk = torch.as_tensor(skip).requires_grad_(True)
    dc = torch.as_tensor(dec).requires_grad_(True)
    u, s = R.recovery_wm_train(p, sk, dc, (0, 0, 0), TINY)
    ((u * torch.as_tensor(wu)).sum() + (s * torch.as_tensor(ws)).sum()).backward()
    _tree_close(_leaf_grads(p), wp)
    _close(sk.grad, wsk, scaled=True)
    _close(dc.grad, wdc, scaled=True)


@pytest.mark.parametrize("which", ["down", "up"])
def test_updown_wm_train_grads_match_jax(setup, which):
    jparams, params, _, _, _ = setup
    off = (1, 3, 6)
    a, b, key = (0, 1, "downsample") if which == "down" else (2, 3, "upsample")
    jfn = JU.down_sample_wm_train if which == "down" else JU.up_sample_wm_train
    fn = U.down_sample_wm_train if which == "down" else U.up_sample_wm_train
    xs = _storage(TINY.stage(a), 44)
    wt = TP.normal(_storage(TINY.stage(b), 0).shape, 45)

    def loss(p, x):
        return jnp.sum(jfn(p, x, JAX_TINY.stage(a), JAX_TINY.stage(b), off)
                       * wt)

    with pltpu.force_tpu_interpret_mode():
        wp, wx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jparams[key],
                                                         jnp.asarray(xs))
    p = _trainable(params[key])
    x = torch.as_tensor(xs).requires_grad_(True)
    (fn(p, x, TINY.stage(a), TINY.stage(b), off)
     * torch.as_tensor(wt)).sum().backward()
    _tree_close(_leaf_grads(p), wp)
    _close(x.grad, wx, scaled=True)

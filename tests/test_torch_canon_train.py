"""The port's canonical-layout training route against the JAX package, TINY,
float32, erf GELU:

* ``block_bwd_plain`` with ``x_layout`` / ``g_layout="canon"`` (a stage's
  first block reading the lat-padded grid, its last block reading its
  cotangent as that grid, and a one-block stage with both) against
  ``_block_bwd_call`` with the same layouts in Pallas interpret mode,
  stochastic-depth scales (0.8, 1.25), batch 1;
* the training stage with canonical ends (``run_stage_train_wm(io_in=
  "canon", io_out="canon")``) at depths 2 and 3 (an odd depth ends
  unshifted), with scales from {0, 0.8, 1.25}, batch 2: its value and the
  gradient of x and of every block leaf against ``jax.vjp`` of the XLA
  reference chain of the JAX test ``test_run_stage_train_wm_matches_xla_
  with_drop_scales`` (tests/test_torch_block_bwd.py's ``_ref_chain``; the
  kernel-level layouts are the unit's).

The whole train step on this route is tests/test_torch_canon_train_step.py's.
Tolerance: per leaf max abs error <= 2e-5 x max(1, max |leaf|), the stage
value 1e-5 x max(1, max |value|) (tests/test_torch_block_bwd.py's metric)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import test_torch_block_bwd as BB
import torch_parity as TP
from pangu_tpu import config as JC
from pangu_tpu.models.layers import window_region_ids
from pangu_tpu.ops import earth_block_bwd as JB
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.ops import earth_block_bwd as W

TOL = 2e-5
HALF = (1, 3, 6)


def _errs(got, want, path=""):
    """(path, max abs error, max |want|) of every leaf of two trees."""
    if isinstance(want, dict):
        return [e for k in want for e in _errs(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        return [e for i, w in enumerate(want)
                for e in _errs(got[i], w, f"{path}/{i}")]
    w = np.asarray(want, np.float64)
    g = TP.to_np(got).astype(np.float64).reshape(w.shape)
    return [(path, float(np.max(np.abs(g - w))), float(np.max(np.abs(w))))]


def _assert_close(got, want, tol=TOL):
    bad = [(p, d, s) for p, d, s in _errs(got, want) if d > tol * max(1.0, s)]
    assert not bad, bad


@pytest.fixture(scope="module")
def params():
    return TP.jax_and_port_params(JC.TINY, seed=12)


# ---- the unit -------------------------------------------------------------

# (x layout, g layout, delta_x, delta_g, canon_add, shifted): a stage's
# first block (its cotangent from a shifted second block), a stage's last
# block after an unshifted one (even depth) and a one-block stage
UNIT_CASES = [("canon", "wm", (0, 0, 0), (-1, -3, -6), 0, False),
              ("wm", "canon", HALF, (0, 0, 0), 3, True),
              ("canon", "canon", (0, 0, 0), (0, 0, 0), 0, False)]


@pytest.mark.parametrize(
    "stage_idx,x_layout,g_layout,delta_x,delta_g,canon_add,shifted",
    [(0, *c) for c in UNIT_CASES] + [(1, *UNIT_CASES[0])])
def test_block_bwd_canon_matches_pallas_kernel(params, stage_idx, x_layout,
                                               g_layout, delta_x, delta_g,
                                               canon_add, shifted):
    jparams, ports = params
    jbp = jparams["stages"][stage_idx]["blocks"][0]
    bp = ports["stages"][stage_idx]["blocks"][0]
    geom = PC.TINY.stage(stage_idx)
    wz, wh, ww = geom.window
    grid = (1, geom.z, geom.h_padded, geom.w, geom.dim)
    wm = (1, geom.z // wz, geom.h_padded // wh, geom.w // ww, wz * wh * ww,
          geom.dim)
    xs = TP.normal(grid if x_layout == "canon" else wm, 70 + stage_idx)
    g = TP.normal(grid if g_layout == "canon" else wm, 80 + stage_idx)
    drop = np.asarray([[0.8, 1.25]], np.float32)
    ids = (window_region_ids(geom.z, geom.h_padded, geom.window) if shifted
           else None)
    with pltpu.force_tpu_interpret_mode():
        want_dx, want = JB._block_bwd_call(
            jbp, jnp.asarray(xs), jnp.asarray(g), JC.TINY.stage(stage_idx),
            delta_x, delta_g, canon_add, x_layout, g_layout,
            None if ids is None else jnp.asarray(ids), False,
            drop=jnp.asarray(drop))
    dx, grads = W.block_bwd_plain(
        bp, torch.as_tensor(xs), torch.as_tensor(g), geom, delta_x, delta_g,
        canon_add, None if ids is None else torch.as_tensor(ids),
        torch.as_tensor(drop), False, x_layout, g_layout)
    assert dx.shape == xs.shape
    _assert_close({"dx": dx, **grads}, {"dx": want_dx, **want})
    # the wrapper takes the layouts and runs the same plain version here
    dx2, _ = W.block_bwd(bp, torch.as_tensor(xs), torch.as_tensor(g), geom,
                         delta_x, delta_g, canon_add,
                         None if ids is None else torch.as_tensor(ids),
                         torch.as_tensor(drop), False, x_layout=x_layout,
                         g_layout=g_layout)
    assert torch.equal(dx2, dx)


def test_canonical_end_refuses_a_shift(params):
    _, ports = params
    bp = ports["stages"][0]["blocks"][0]
    geom = PC.TINY.stage(0)
    x = torch.zeros((1, geom.z, geom.h_padded, geom.w, geom.dim))
    with pytest.raises(ValueError, match="unshifted"):
        W.block_bwd_plain(bp, x, x, geom, HALF, (0, 0, 0), 3, None, None,
                          False, "canon", "canon")
    with pytest.raises(ValueError, match="neither end"):
        W.block_bwd_canon(bp, x, x, geom, (0, 0, 0), (0, 0, 0), 0, None,
                          None, False)


# ---- the stage ------------------------------------------------------------

def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("depth", [2, 3])
def test_canon_stage_train_matches_jax(params, depth):
    jparams, ports = params
    stage_idx = 0
    geom, jgeom = PC.TINY.stage(stage_idx), JC.TINY.stage(stage_idx)
    jsp = {"blocks": (jparams["stages"][stage_idx]["blocks"] * 2)[:depth]}
    sp = {"blocks": [_map(bp, lambda t: t.clone().requires_grad_(True))
                     for bp in (ports["stages"][stage_idx]["blocks"]
                                * 2)[:depth]]}
    rng = np.random.default_rng(90 + depth)
    drops = [rng.choice([0.0, 0.8, 1.25], size=(BB.B, 2)).astype(np.float32)
             for _ in range(depth)]
    x = TP.normal((BB.B, geom.z, geom.h, geom.w, geom.dim), 91)
    g = TP.normal(x.shape, 92)
    jd = [jnp.asarray(d) for d in drops]

    def jax_vjp(p, xx, gg):
        v, vjp = jax.vjp(lambda a, b: BB._ref_chain(a, b, jgeom, jd), p, xx)
        return v, vjp(gg)

    want, (want_p, want_x) = jax.jit(jax_vjp)(jsp, jnp.asarray(x),
                                              jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = W.run_stage_train_wm(sp, xt, geom,
                               [torch.as_tensor(d) for d in drops],
                               io_in="canon", io_out="canon")
    assert got.shape == x.shape
    _assert_close(got, want, 1e-5)
    got.backward(torch.as_tensor(g))
    grads = {"blocks": [_map(bp, lambda t: t.grad) for bp in sp["blocks"]]}
    _assert_close({"x": xt.grad, "p": grads}, {"x": want_x, "p": want_p})

"""The port's grid attention (``ops/window_attention``) against the JAX
package's: the forward's plain version against ``_grid_attention_pallas``
and the backward's against ``_grid_attention_bwd_pallas``, both in Pallas
interpret mode as tests/test_ops.py runs them, with and without region ids;
and ``GridAttention`` (the autograd Function) against ``jax.vjp`` of
``_grid_core`` (its ``pallas`` backward).  TINY stage geometries, float32,
batch 1 (interpret mode runs one program per window row), random qkv / proj
biases so their gradients are not trivial.
Tolerance: per output or gradient leaf, max abs error <= 2e-5 x that leaf's
own max |leaf| (float32 sums in another order; each leaf's scale and error
are printed: dx and the table gradient are ~1e-3, so a scale floored at 1
would be an absolute bound that passes errors of a sizeable fraction of
them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.ops import window_attention as JWA
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops import window_attention as W

TOL = 2e-5
FLOOR = 1e-12     # of a leaf's scale, only so an all-zero leaf compares
NAMES = ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dbias")


def _assert_close(got, want, names):
    bad = []
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float64)
        g = TP.to_np(g).astype(np.float64).reshape(w.shape)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(g - w)))
        print(f"{name:6s} max|leaf| {scale:.3e} err {d:.3e} "
              f"rel {d / scale:.3e}")
        if d > TOL * scale:
            bad.append((name, d, scale))
    assert not bad, bad


@pytest.fixture(scope="module")
def params():
    return TP.port_and_jax_params(TINY, seed=7)


def _case(params, stage_idx, masked):
    """Numpy inputs of one stage: x and a cotangent (B=1 grids), the
    attention weights (random biases), the table, the region ids."""
    jparams, _ = params
    geom = TINY.stage(stage_idx)
    a = jparams["stages"][stage_idx]["blocks"][0]["attn"]
    shape = (1, geom.z, geom.h_padded, geom.w, geom.dim)
    c = geom.dim
    w = (np.array(a["qkv"]["kernel"]), 0.02 * TP.normal((3 * c,), 3),
         np.array(a["proj"]["kernel"]), 0.02 * TP.normal((c,), 4),
         np.array(a["bias_table"]))
    ids = (window_region_ids(geom.z, geom.h_padded, geom.window)
           if masked else None)
    return geom, TP.normal(shape, 10 + stage_idx), TP.normal(shape, 20), w, ids


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_grid_attention_matches_pallas(params, stage_idx, masked):
    geom, x, _, w, ids = _case(params, stage_idx, masked)
    with pltpu.force_tpu_interpret_mode():
        want = JWA._grid_attention_pallas(_j(x), *map(_j, w), geom.window,
                                          ids=_j(ids))
    before = W.grid_attention.launches
    got = W.grid_attention(_t(x), *map(_t, w), geom.window, _t(ids))
    assert W.grid_attention.launches == before       # a CPU tensor: plain
    assert got.shape == x.shape
    _assert_close([got], [want], ["out"])


@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_grid_attention_bwd_matches_pallas(params, stage_idx, masked):
    geom, x, g, (wqkv, bqkv, wp, _, table), ids = _case(params, stage_idx,
                                                        masked)
    with pltpu.force_tpu_interpret_mode():
        want = JWA._grid_attention_bwd_pallas(
            _j(x), _j(g), _j(wqkv), _j(bqkv), _j(wp), _j(table), geom.window,
            ids=_j(ids))
    got = W.grid_attention_bwd(_t(x), _t(g), _t(wqkv), _t(bqkv), _t(wp),
                               _t(table), geom.window, _t(ids))
    assert got[0].shape == x.shape
    assert all(t.dtype == torch.float32 for t in got)
    _assert_close(got, want, NAMES)


@pytest.mark.parametrize("masked", [False, True])
def test_grid_attention_function_matches_jax_vjp(params, masked):
    """Value and every gradient of ``GridAttention`` against ``jax.vjp`` of
    ``_grid_core`` with the one-kernel Pallas backward."""
    geom, x, g, w, ids = _case(params, 0, masked)
    core = JWA._grid_core(geom.heads, geom.window,
                          (geom.z, geom.h_padded) if masked else None,
                          bwd_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(core, _j(x), *map(_j, w))
        want_grads = vjp(_j(g))
    leaves = [_t(a).requires_grad_(True) for a in (x, *w)]
    got = W.GridAttention.apply((geom.window, _t(ids), True), *leaves)
    got.backward(_t(g))
    _assert_close([got], [want], ["out"])
    _assert_close([t.grad for t in leaves], want_grads,
                  ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dbias"))

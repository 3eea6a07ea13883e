"""The port's windowed sdpa (``ops/window_attention.py``: ``sdpa``,
``sdpa_bwd``, ``Sdpa``) and the grid attention's ``"xla"`` backward against
the JAX package, TINY stage-0 shapes (N = 144 tokens, 2 heads of 8), float32:

* ``sdpa``'s and ``sdpa_bwd``'s plain versions against ``_sdpa_pallas`` and
  ``_sdpa_pallas_bwd`` in Pallas interpret mode, as tests/test_ops.py runs
  them, on the stage's bias table with and without the folded shifted-window
  mask;
* ``Sdpa`` against ``jax.vjp`` of ``_sdpa`` (the Pallas forward and
  backward);
* ``GridAttention`` with ``bwd_impl="xla"`` (the reference composition
  recomputed through ``Sdpa`` and differentiated) against ``jax.vjp`` of
  ``_grid_core(bwd_impl="xla")``, with and without region ids.

Tolerance: per output or gradient leaf, max abs error <= 2e-5 x that leaf's
own max |leaf| (float32 sums in another order; scales printed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.ops import window_attention as JW
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops import window_attention as W

TOL = 2e-5
FLOOR = 1e-12
GEOM = TINY.stage(0)


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


def _ids():
    return window_region_ids(GEOM.z, GEOM.h_padded, GEOM.window)


def _case(params, masked):
    """qkv (nwin 2, ntype, 3, heads, hd, N), the float32 bias (the stage's
    table, the mask folded in where ``masked``) and an output cotangent."""
    jparams, _ = params
    table = np.asarray(jparams["stages"][0]["blocks"][0]["attn"]["bias_table"])
    bias = table.astype(np.float32)
    if masked:
        ids = _ids()
        bias = bias + np.where(ids[:, None, :] != ids[:, :, None], -100.0,
                               0.0).astype(np.float32)[:, None]
    ntype, heads, n, _ = bias.shape
    hd = GEOM.dim // heads
    qkv = TP.normal((2, ntype, 3, heads, hd, n), 50)
    g = TP.normal((2, ntype, heads, hd, n), 51)
    return qkv, np.ascontiguousarray(bias), g


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_pallas(params, masked):
    qkv, bias, _ = _case(params, masked)
    with pltpu.force_tpu_interpret_mode():
        want = JW._sdpa_pallas(jnp.asarray(qkv), jnp.asarray(bias))
    before = W.sdpa.launches
    got = W.sdpa(torch.as_tensor(qkv), torch.as_tensor(bias))
    assert W.sdpa.launches == before                 # a CPU tensor: plain
    assert got.shape == want.shape
    _assert_close([got], [want], ["out"])


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_bwd_matches_pallas(params, masked):
    qkv, bias, g = _case(params, masked)
    with pltpu.force_tpu_interpret_mode():
        want = JW._sdpa_pallas_bwd(jnp.asarray(qkv), jnp.asarray(bias),
                                   jnp.asarray(g))
    got = W.sdpa_bwd(torch.as_tensor(qkv), torch.as_tensor(bias),
                     torch.as_tensor(g))
    assert got[1].dtype == torch.float32
    _assert_close(got, want, ["dqkv", "dbias"])


def test_sdpa_function_matches_jax_vjp(params):
    qkv, bias, g = _case(params, True)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(JW._sdpa, jnp.asarray(qkv), jnp.asarray(bias))
        want_grads = vjp(jnp.asarray(g))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (qkv, bias)]
    got = W.Sdpa.apply(True, *leaves)
    got.backward(torch.as_tensor(g))
    _assert_close([got], [want], ["out"])
    _assert_close([t.grad for t in leaves], want_grads, ["dqkv", "dbias"])


@pytest.mark.parametrize("masked", [False, True])
def test_grid_attention_xla_bwd_matches_jax_vjp(params, masked):
    jparams, _ = params
    a = jparams["stages"][0]["blocks"][0]["attn"]
    c = GEOM.dim
    w = (np.array(a["qkv"]["kernel"]), 0.02 * TP.normal((3 * c,), 3),
         np.array(a["proj"]["kernel"]), 0.02 * TP.normal((c,), 4),
         np.array(a["bias_table"]))
    shape = (1, GEOM.z, GEOM.h_padded, GEOM.w, c)
    x, g = TP.normal(shape, 52), TP.normal(shape, 53)
    core = JW._grid_core(GEOM.heads, GEOM.window,
                         (GEOM.z, GEOM.h_padded) if masked else None,
                         bwd_impl="xla")
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(core, jnp.asarray(x), *map(jnp.asarray, w))
        want_grads = vjp(jnp.asarray(g))
    ids = torch.as_tensor(_ids()) if masked else None
    leaves = [torch.as_tensor(t).requires_grad_(True) for t in (x, *w)]
    before = (W.grid_attention_bwd.launches, W.sdpa_bwd.launches)
    got = W.GridAttention.apply((GEOM.window, ids, True, "xla"), *leaves)
    got.backward(torch.as_tensor(g))
    assert (W.grid_attention_bwd.launches, W.sdpa_bwd.launches) == before
    _assert_close([got], [want], ["out"])
    _assert_close([t.grad for t in leaves], want_grads,
                  ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dbias"))

"""The port's ``block_layout="v2"`` training against the JAX package, TINY,
float32, erf GELU:

* the training stage (``run_stage_train``: one autograd Function per block,
  the block kernel forward, the recompute through ``GridAttention`` and the
  plain tail backward), its value and the gradient of x and of every block
  leaf against ``jax.vjp`` of the JAX ``run_stage_train`` in Pallas
  interpret mode (jitted), depth 2 at stage 0 with stochastic-depth scales
  (0.8, 1.25), (1.25, 0.8), batch 1: value 5e-5 abs, each gradient leaf
  2e-5 x its own max |leaf| (the scales are printed; several leaves are
  far below 1);
* the loss and every gradient of a whole v2 train step (``loss_and_grads``)
  against ``jax.jit(jax.value_and_grad)`` of the JAX ``forward(
  deterministic=False)`` with ``attn_impl="xla"`` and ``drop_path_max=0``:
  loss 1e-5 relative, every leaf 5e-5 x its own max |leaf| (the metric of
  tests/test_torch_train.py);
* the port's v2 and wm train steps from the same parameters and seed (the
  same stochastic-depth draws, default rates): loss 1e-6 relative, every
  leaf 1e-5 x its max (both plain compositions of the same float32
  operations on CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu import config as JC
from pangu_tpu.data.constants import norm_data as jax_norm_data
from pangu_tpu.engine import train as JT
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu.ops import earth_block_fused as JF
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.ops import earth_block_fused as F

FLOOR = 1e-12     # of a leaf's scale; the smallest leaf here is ~8e-8
V2 = dataclasses.replace(PC.TINY, block_layout="v2")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _bad_leaves(got, want, tol, floor):
    """Leaves of ``want`` (a tree) whose max abs error exceeds tol x
    max(floor, max |leaf|)."""
    got = dict(_flat(got))
    bad = []
    for path, w in _flat(want):
        w = TP.to_np(w).astype(np.float64)
        g = TP.to_np(got[path]).astype(np.float64).reshape(w.shape)
        scale = max(floor, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(g - w)))
        print(f"{path:45s} max|leaf| {scale:.3e} err {d:.3e} "
              f"rel {d / scale:.3e}")
        if d > tol * scale:
            bad.append((path, d, scale))
    return bad


def _grad_tree(tree):
    return jax.tree.map(lambda t: t.grad, tree)


def test_run_stage_train_matches_jax_vjp():
    jparams, params = TP.port_and_jax_params(PC.TINY, seed=8)
    geom = PC.TINY.stage(0)
    x = TP.normal((1, geom.z, geom.h, geom.w, geom.dim), 30)
    g = TP.normal(x.shape, 31)
    drops = [np.asarray([[0.8, 1.25]], np.float32),
             np.asarray([[1.25, 0.8]], np.float32)]

    def jax_vjp(sp, xx, gg):
        v, vjp = jax.vjp(lambda a, b: JF.run_stage_train(
            a, b, JC.TINY.stage(0), [jnp.asarray(d) for d in drops]), sp, xx)
        return v, vjp(gg)

    with pltpu.force_tpu_interpret_mode():
        want, (want_sp, want_x) = jax.jit(jax_vjp)(
            jparams["stages"][0], jnp.asarray(x), jnp.asarray(g))
    sp = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                      params["stages"][0])
    xt = torch.as_tensor(x).requires_grad_(True)
    got = F.run_stage_train(sp, xt, geom, [torch.as_tensor(d) for d in drops])
    assert got.shape == x.shape
    assert TP.max_abs_err(got, want) <= 5e-5
    got.backward(torch.as_tensor(g))
    assert not _bad_leaves({"x": xt.grad, "p": _grad_tree(sp)},
                           {"x": want_x, "p": want_sp}, 2e-5, FLOOR)


@pytest.fixture(scope="module")
def batch():
    consts = synthetic_constants(PC.TINY)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, PC.TINY.levels, PC.TINY.lat, PC.TINY.lon),
                         seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, PC.TINY.lat, PC.TINY.lon), seed + 1))
        return u, s

    (u0, s0), (u1, s1) = state(6), state(8)
    return consts, {"upper": u0, "surface": s0, "target_upper": u1,
                    "target_surface": s1}


def _port_step(params, consts, b, cfg, **kw):
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    return T.loss_and_grads(params,
                            {k: torch.as_tensor(v) for k, v in b.items()},
                            {k: torch.as_tensor(v) for k, v in consts.items()},
                            cfg, PC.TrainConfig(), device="cpu", **kw)


def test_v2_train_step_loss_and_grads_match_jax(batch):
    consts, b = batch
    jcfg = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)
    jparams, params = TP.port_and_jax_params(PC.TINY, seed=5)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jloss(p, bb):
        ou, os_ = jax_pangu.forward(p, bb["upper"], bb["surface"], jc, jcfg,
                                    deterministic=False)
        tu, ts = jax_norm_data(bb["target_upper"], bb["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, JC.TrainConfig())[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = _port_step(params, consts, b,
                                dataclasses.replace(V2, drop_path_max=0.0))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert not _bad_leaves(grads, want, 5e-5, FLOOR)


def test_v2_and_wm_train_steps_agree(batch):
    consts, b = batch
    _, params = TP.port_and_jax_params(PC.TINY, seed=5)
    lv, _, gv = _port_step(params, consts, b, V2, seed=11)
    lw, _, gw = _port_step(params, consts, b, PC.TINY, seed=11)
    np.testing.assert_allclose(float(lv), float(lw), rtol=1e-6)
    assert not _bad_leaves(gv, gw, 1e-5, FLOOR)

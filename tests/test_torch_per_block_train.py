"""The port's per-block training path against the JAX package and against
its own fused training path, TINY, float32, erf GELU, batch 1:

* the training stage block by block (``models/pangu.py::run_stage_blocks``,
  depth 2, ``drop_path_max=0``: the JAX package draws its stochastic depth
  from ``jax.random``), its value and the gradient of x and of every block
  leaf against ``jax.vjp`` of the JAX ``_run_stage`` with
  ``train_fused=False`` in Pallas interpret mode, under both grid attention
  backwards (the JAX package's ``GRID_BWD_IMPL``; the port's
  ``cfg.grid_bwd``: the grid attention backward, or the reference
  composition through ``Sdpa``), the port recomputing each block
  (``remat``): value 5e-5 abs, each gradient leaf 2e-5 x its own max |leaf|
  (printed);
* a whole train step with ``train_fused=False`` against the fused one
  (window-major trunk) from the same seed, stochastic depth at the default
  rates (``draw_drops``: one drop stream for both), ``remat`` on and off and
  both backwards: loss 1e-6 relative, every leaf 1e-5 x its max (plain
  compositions of the same float32 operations on CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu import config as JC
from pangu_tpu.models import pangu as JP
from pangu_tpu.ops import window_attention as JW
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.ops import window_attention as W

TOL = 5e-5
GRAD_TOL = 2e-5
FLOOR = 1e-12


@pytest.fixture(scope="module")
def params():
    return TP.port_and_jax_params(PC.TINY, seed=9)


def _x(geom, seed):
    return TP.normal((1, geom.z, geom.h, geom.w, geom.dim), seed)


def _bad_leaves(pairs, tol):
    bad = []
    for path, gt, w in pairs:
        w = TP.to_np(w).astype(np.float64)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(TP.to_np(gt).astype(np.float64) - w)))
        print(f"{path:40s} max|leaf| {scale:.3e} err {d:.3e} "
              f"rel {d / scale:.3e}")
        if d > tol * scale:
            bad.append((path, d, scale))
    return bad


@pytest.mark.parametrize("grid_bwd", ["pallas", "xla"])
def test_stage_grads_match_jax(params, grid_bwd, monkeypatch):
    jparams, ports = params
    geom = PC.TINY.stage(0)
    x = _x(geom, 43)
    g = TP.normal(x.shape, 44)
    monkeypatch.setattr(JW, "GRID_BWD_IMPL", grid_bwd)
    # no jax.checkpoint: Pallas interpret mode's callbacks cannot be
    # rematerialised (the port's side recomputes each block, remat=True)
    jcfg = dataclasses.replace(JC.TINY, attn_impl="pallas", train_fused=False,
                               remat=False, drop_path_max=0.0)

    def jstage(sp, xx):
        return JP._run_stage(sp, xx, jcfg, 0, rng=None, deterministic=False,
                             precision=None)

    def jax_vjp(sp, xx, gg):
        v, vjp = jax.vjp(jstage, sp, xx)
        return v, vjp(gg)

    with pltpu.force_tpu_interpret_mode():
        want_val, (want_sp, want_x) = jax.jit(jax_vjp)(
            jparams["stages"][0], jnp.asarray(x), jnp.asarray(g))
    cfg = dataclasses.replace(PC.TINY, remat=True, grid_bwd=grid_bwd,
                              drop_path_max=0.0)
    sp = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                      ports["stages"][0])
    xt = torch.as_tensor(x).requires_grad_(True)
    before = (W.sdpa.launches, W.sdpa_bwd.launches)
    got = pangu.run_stage_blocks(sp, xt, cfg, 0, deterministic=False)
    assert TP.max_abs_err(got, want_val) <= TOL
    got.backward(torch.as_tensor(g))
    assert (W.sdpa.launches, W.sdpa_bwd.launches) == before   # CPU: plain
    pairs = [("x", xt.grad, want_x)] + [
        (path, t.grad, w) for (path, t), w in zip(
            _flat(sp), jax.tree.leaves(want_sp))]
    assert not _bad_leaves(pairs, GRAD_TOL)


def _flat(tree, path=""):
    """(path, leaf) in jax.tree.leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def batch():
    consts = synthetic_constants(PC.TINY)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, PC.TINY.levels, PC.TINY.lat, PC.TINY.lon),
                         seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, PC.TINY.lat, PC.TINY.lon), seed + 1))
        return torch.as_tensor(u), torch.as_tensor(s)

    (u0, s0), (u1, s1) = state(6), state(8)
    return ({k: torch.as_tensor(v) for k, v in consts.items()},
            {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1})


def _step(params, consts, b, cfg):
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    return T.loss_and_grads(params, b, consts, cfg, PC.TrainConfig(),
                            device="cpu", seed=11)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("grid_bwd", ["pallas", "xla"])
def test_per_block_step_matches_fused_step(params, batch, remat, grid_bwd):
    consts, b = batch
    _, ports = params
    lf, _, gf = _step(ports, consts, b, PC.TINY)
    cfg = dataclasses.replace(PC.TINY, train_fused=False, remat=remat,
                              grid_bwd=grid_bwd)
    lb, _, gb = _step(ports, consts, b, cfg)
    np.testing.assert_allclose(float(lb), float(lf), rtol=1e-6)
    assert not _bad_leaves([(p, g, w) for (p, g), (_, w) in zip(
        _flat(gb), _flat(gf))], 1e-5)

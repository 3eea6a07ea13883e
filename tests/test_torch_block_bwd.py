"""The port's whole-block backward (``block_bwd_plain``) and its training
stage chain (``run_stage_train_wm``, one autograd Function per stage call)
against the JAX package: the unit against ``_block_bwd_call`` run in Pallas
interpret mode, as tests/test_ops.py runs it; the stage's value and every
gradient against the XLA reference chain of the JAX test
``test_run_stage_train_wm_matches_xla_with_drop_scales`` (jitted).  TINY,
float32, erf GELU, stochastic-depth scales from {0, 0.8, 1.25} (batch 2;
the unit at batch 1).
Tolerance: per leaf, max abs error <= 2e-5 x max(1, max |leaf|) (the JAX
test's own metric; float32 sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.models import layers as JL
from pangu_tpu.ops import earth_block_bwd as JB
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops import earth_block_bwd as W

B = 2
TOL = 2e-5


def _leaf_errors(got_tree, want_tree, path=""):
    """(path, max abs error, scale) of every leaf of two nested trees."""
    if isinstance(want_tree, dict):
        out = []
        for k in want_tree:
            out += _leaf_errors(got_tree[k], want_tree[k], f"{path}/{k}")
        return out
    if isinstance(want_tree, (list, tuple)):
        out = []
        for i, w in enumerate(want_tree):
            out += _leaf_errors(got_tree[i], w, f"{path}/{i}")
        return out
    want = np.asarray(want_tree, np.float64)
    got = TP.to_np(got_tree).astype(np.float64).reshape(want.shape)
    return [(path, float(np.max(np.abs(got - want))),
             max(1.0, float(np.max(np.abs(want)))))]


def _assert_close(got_tree, want_tree):
    bad = [(p, d, s) for p, d, s in _leaf_errors(got_tree, want_tree)
           if d > TOL * s]
    assert not bad, bad


def _drops(depth, seed):
    rng = np.random.default_rng(seed)
    return [rng.choice([0.0, 0.8, 1.25], size=(B, 2)).astype(np.float32)
            for _ in range(depth)]


@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("shifted", [False, True])
def test_block_bwd_plain_matches_pallas_kernel(stage_idx, shifted):
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=stage_idx)
    jbp = jparams["stages"][stage_idx]["blocks"][1]
    bp = params["stages"][stage_idx]["blocks"][1]
    geom = TINY.stage(stage_idx)
    wz, wh, ww = geom.window
    shape = (1, geom.z // wz, geom.h_padded // wh, geom.w // ww, wz * wh * ww,
             geom.dim)    # batch 1: interpret mode runs one program per window
    xs, g = TP.normal(shape, 30 + stage_idx), TP.normal(shape, 40 + stage_idx)
    drop = np.asarray([[0.8, 1.25]], np.float32)
    if shifted:   # a shifted block after an unshifted one, before another
        delta_x, delta_g, canon_add = (1, 3, 6), (1, 3, 6), 3
        ids = window_region_ids(geom.z, geom.h_padded, geom.window)
    else:         # an unshifted block after a shifted one, the stage's last
        delta_x, delta_g, canon_add, ids = (-1, -3, -6), (0, 0, 0), 0, None

    with pltpu.force_tpu_interpret_mode():
        want_dx, want = JB._block_bwd_call(
            jbp, jnp.asarray(xs), jnp.asarray(g), JAX_TINY.stage(stage_idx),
            delta_x, delta_g, canon_add, "wm", "wm",
            None if ids is None else jnp.asarray(ids), False,
            drop=jnp.asarray(drop))
    dx, grads = W.block_bwd(bp, torch.as_tensor(xs), torch.as_tensor(g), geom,
                            delta_x, delta_g, canon_add,
                            None if ids is None else torch.as_tensor(ids),
                            torch.as_tensor(drop), False)
    _assert_close({"dx": dx, **grads}, {"dx": want_dx, **want})


def _ref_chain(sp, x, geom, drops):
    """The JAX test's XLA reference chain of a training stage."""
    y = x
    for j, bp in enumerate(sp["blocks"]):
        roll = j % 2 == 1
        s1 = drops[j][:, 0].reshape(B, 1, 1, 1, 1)
        s2 = drops[j][:, 1].reshape(B, 1, 1, 1, 1)
        shortcut = y
        hp = geom.h_padded
        xp = jnp.pad(y, ((0, 0), (0, 0), (0, hp - geom.h), (0, 0), (0, 0)))
        mask = None
        if roll:
            xp = jnp.roll(xp, (-1, -3, -6), axis=(1, 2, 3))
            ids = jnp.asarray(JL.window_region_ids(geom.z, hp, geom.window))
            mask = jnp.where(ids[:, None, :] != ids[:, :, None],
                             jnp.float32(-100.0), jnp.float32(0.0))
        win = JL.window_partition(xp, geom.window)
        win = JL.earth_attention(bp["attn"], win, geom.heads, mask)
        xp = JL.window_reverse(win, geom.window, geom.z, hp, geom.w)
        if roll:
            xp = jnp.roll(xp, (1, 3, 6), axis=(1, 2, 3))
        y = shortcut + s1 * JL.layer_norm(bp["norm1"], xp[:, :, :geom.h])
        y = y + s2 * JL.layer_norm(bp["norm2"], JL.mlp(bp["mlp"], y))
    return y


@pytest.mark.parametrize("stage_idx,depth", [(0, 2), (1, 4)])
@pytest.mark.parametrize("kernels", [True, False])
def test_stage_function_matches_xla_chain(stage_idx, depth, kernels):
    """Value and every gradient of the stage Function (wm in, rolled wm out,
    canonicalised for the loss) against the XLA chain on the canonical grid.
    On CPU tensors both settings of ``kernels`` run the plain versions; the
    test pins that the Function carries either."""
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=stage_idx)
    jgeom, geom = JAX_TINY.stage(stage_idx), TINY.stage(stage_idx)
    jsp = {"blocks": (jparams["stages"][stage_idx]["blocks"] * 2)[:depth]}
    sp = {"blocks": (params["stages"][stage_idx]["blocks"] * 2)[:depth]}
    drops = _drops(depth, 91 + 10 * stage_idx + depth)
    x = TP.normal((B, geom.z, geom.h, geom.w, geom.dim), 60 + stage_idx)

    jd = [jnp.asarray(d) for d in drops]
    vr, gr = jax.jit(jax.value_and_grad(
        lambda p, xx: jnp.sum(_ref_chain(p, xx, jgeom, jd) ** 2),
        argnums=(0, 1)))(jsp, jnp.asarray(x))

    # JAX differentiates each list position of the repeated blocks on its
    # own: give every position its own leaves
    sp = {"blocks": [_map(bp, lambda t: t.clone().requires_grad_(True))
                     for bp in sp["blocks"]]}
    xt = torch.as_tensor(x).requires_grad_(True)
    xw = W.to_window_major(torch.nn.functional.pad(
        xt, (0, 0, 0, 0, 0, geom.h_padded - geom.h)), geom.window)
    ys, off = W.run_stage_train_wm(sp, xw, geom,
                                   [torch.as_tensor(d) for d in drops],
                                   kernels=kernels)
    from pangu_tpu_torch.ops.earth_block_wm import wm_to_canonical
    v = (wm_to_canonical(ys, off, geom) ** 2).sum()
    v.backward()

    np.testing.assert_allclose(float(v.detach()), float(vr), rtol=1e-5)
    got = {"blocks": [_map(bp, lambda t: t.grad) for bp in sp["blocks"]]}
    _assert_close({"x": xt.grad, "p": got}, {"x": gr[1], "p": gr[0]})


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_stage_drops_reach_the_gradient():
    """A zero scale cuts its branch out of the gradient: with every scale 0
    the stage is the identity and no block parameter gets a gradient."""
    _, params = TP.jax_and_port_params(JAX_TINY, seed=0)
    geom = TINY.stage(0)
    sp = {"blocks": [_map(bp, lambda t: t.clone().requires_grad_(True))
                     for bp in params["stages"][0]["blocks"]]}
    wz, wh, ww = geom.window
    x = torch.as_tensor(TP.normal((B, geom.z // wz, geom.h_padded // wh,
                                   geom.w // ww, wz * wh * ww, geom.dim), 80))
    x = W.to_window_major(W.pad_rows_zeroed(W.from_window_major(
        x, geom.window), geom, 0), geom.window).requires_grad_(True)
    drops = [torch.zeros(B, 2) for _ in sp["blocks"]]
    ys, off = W.run_stage_train_wm(sp, x, geom, drops)
    from pangu_tpu_torch.ops.earth_block_wm import wm_to_canonical
    want = W.from_window_major(x.detach(), geom.window)[:, :, :geom.h]
    torch.testing.assert_close(wm_to_canonical(ys, off, geom), want)
    ys.sum().backward()
    for bp in sp["blocks"]:
        for t in (bp["attn"]["qkv"]["kernel"], bp["mlp"]["fc1"]["kernel"],
                  bp["attn"]["bias_table"]):
            assert float(t.grad.abs().max()) == 0.0

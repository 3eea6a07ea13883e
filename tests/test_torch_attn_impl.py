"""``attn_impl="xla"``: the port's model through the plain layers only,
against the JAX package's ``attn_impl="xla"`` (its default) at TINY,
float32, erf GELU, batch 1, from the same parameters and inputs:

* the served ``forward``: max abs error 5e-4 on normalised outputs
  (tests/test_torch_forward.py's metric: float32 reassociation across 8
  blocks, down/up and the recovery);
* one train step (``loss_and_grads``, ``drop_path_max=0``: the JAX package
  draws its stochastic depth from ``jax.random``): loss 1e-5 relative, every
  leaf 5e-5 x its own max |leaf| (tests/test_torch_train.py's metric);
* the dispatch: under "xla" no kernel wrapper, and no stage, Down/UpSample
  or block route of the kernel path, is entered (each replaced by one that
  raises), served or trained, with the edge kernels asked for (the JAX
  package skips them off the window-major trunk, and so does the port);
  under "pallas" the same forward does enter them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu import config as JC
from pangu_tpu.data.constants import norm_data as jax_norm_data
from pangu_tpu.engine import train as JT
from pangu_tpu.models import pangu as JP
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import pangu

TOL = 5e-4
STEP_TOL = 5e-5
FLOOR = 1e-12
JAX_CFG = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)
CFG = dataclasses.replace(PC.TINY, attn_impl="xla", drop_path_max=0.0)


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_CFG, seed=21)
    consts = synthetic_constants(CFG)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, CFG.levels, CFG.lat, CFG.lon), seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, CFG.lat, CFG.lon), seed + 1))
        return u, s

    (u0, s0), (u1, s1) = state(22), state(24)
    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    return jparams, params, consts, batch


def test_forward_matches_jax(setup):
    jparams, params, consts, batch = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    want = jax.jit(lambda p, u, s: JP.forward(p, u, s, jc, JAX_CFG))(
        jparams, jnp.asarray(batch["upper"]), jnp.asarray(batch["surface"]))
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    with torch.no_grad():
        got = pangu.forward(params, torch.as_tensor(batch["upper"]),
                            torch.as_tensor(batch["surface"]), tc, CFG,
                            device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def test_train_step_matches_jax(setup):
    jparams, params, consts, batch = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    tcfg = JC.TrainConfig()

    def jloss(p, b):
        ou, os_ = JP.forward(p, b["upper"], b["surface"], jc, JAX_CFG,
                             deterministic=False)
        tu, ts = jax_norm_data(b["target_upper"], b["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, tcfg)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    loss, _, grads = T.loss_and_grads(
        params, {k: torch.as_tensor(v) for k, v in batch.items()},
        {k: torch.as_tensor(v) for k, v in consts.items()}, CFG,
        PC.TrainConfig(), device="cpu")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(_flat(grads))
    bad = []
    for path, w in _flat(jax.tree.map(np.asarray, want)):
        g = TP.to_np(got[path]).reshape(w.shape)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(g - w)))
        if d > STEP_TOL * scale:
            bad.append((path, d, scale))
    assert not bad, bad


# every kernel route of the port's model, by module and name
KERNEL_ROUTES = [
    ("pangu_tpu_torch.models.pangu", name) for name in (
        "forward_core_wm", "forward_core_wm_train", "run_stage_wm",
        "run_stage_train_wm", "run_stage_fused", "run_stage_train",
        "down_sample", "up_sample", "down_sample_train", "up_sample_train",
        "embed_wm", "embed_wm_train", "recovery_wm", "recovery_wm_train")
] + [("pangu_tpu_torch.ops.window_attention", name) for name in (
    "block_noroll_fused", "block_noroll_plain", "window_attention_grid")
] + [("pangu_tpu_torch.ops.block_tail", name) for name in (
    "fused_block_tail", "fused_block_tail_plain")]


def _refuse_kernel_routes(monkeypatch):
    import importlib

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel route was entered")

    for mod, name in KERNEL_ROUTES:
        monkeypatch.setattr(importlib.import_module(mod), name, refuse)


@pytest.mark.parametrize("train", [False, True])
def test_xla_enters_no_kernel_route(setup, monkeypatch, train):
    _, params, consts, batch = setup
    cfg = dataclasses.replace(CFG, edge_kernels=True, drop_path_max=0.2)
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    _refuse_kernel_routes(monkeypatch)
    if train:
        params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                              params)
        loss, _, _ = T.loss_and_grads(params, b, tc, cfg, PC.TrainConfig(),
                                      device="cpu", seed=3)
        assert np.isfinite(float(loss))
    else:
        with torch.no_grad():
            out = pangu.forward(params, b["upper"], b["surface"], tc, cfg,
                                device="cpu")
        assert all(bool(torch.isfinite(t).all()) for t in out)
    with pytest.raises(AssertionError, match="kernel route"):
        pangu.forward(params, b["upper"], b["surface"], tc,
                      dataclasses.replace(cfg, attn_impl="pallas"),
                      device="cpu")

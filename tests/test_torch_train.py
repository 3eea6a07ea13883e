"""The port's training step and engine against the JAX package at TINY,
float32, erf GELU:

* the loss and every gradient of a whole train step (``loss_and_grads``:
  the training forward, the weighted L1 loss against normalised targets,
  backward), with and without the edge kernels, against
  ``jax.jit(jax.value_and_grad)`` of the JAX ``forward(deterministic=False)``
  with ``attn_impl="xla"`` and ``drop_path_max=0`` (the stochastic-depth
  scales are held by tests/test_torch_block_bwd.py): loss 1e-5 relative,
  every leaf 5e-5 x its own max |leaf| (the leaves' scales, printed, run
  from ~8e-8 for a bias table to ~0.1: an absolute floor would pass zeros);
* ``weighted_l1_loss``, ``lr_schedule`` and three optimizer updates against
  the JAX package's (optax) on the same gradients;
* ``train_loop``'s early stopping, with fake steps as tests/test_train.py
  runs it, and the state it returns training on from the best epoch's
  params;
* ``drop_path_rates`` equal to JAX's, and ``_stage_drops`` giving {0,
  1/keep}, and ones at rate 0."""

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
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import pangu

TOL = 5e-5
FLOOR = 1e-12     # of a leaf's scale; the smallest leaf here is ~8e-8
JAX_CFG = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)
CFG = dataclasses.replace(PC.TINY, drop_path_max=0.0)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return TP.to_np(tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_CFG, seed=5)
    consts = synthetic_constants(CFG)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, CFG.levels, CFG.lat, CFG.lon), seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, CFG.lat, CFG.lon), seed + 1))
        return u, s

    (u0, s0), (u1, s1) = state(6), state(8)
    batch = {"upper": u0, "surface": s0, "target_upper": u1,
             "target_surface": s1}
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    tcfg = JC.TrainConfig()

    def jloss(p, b):
        ou, os_ = jax_pangu.forward(p, b["upper"], b["surface"], jc, JAX_CFG,
                                    deterministic=False)
        tu, ts = jax_norm_data(b["target_upper"], b["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, tcfg)[0]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, consts, batch, float(jv), _tree_np(jg)


@pytest.mark.parametrize("edge", [False, True])
def test_train_step_loss_and_grads_match_jax(setup, edge):
    params, consts, batch, want_loss, want = setup
    cfg = dataclasses.replace(CFG, edge_kernels=edge)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    loss, _, grads = T.loss_and_grads(
        params, {k: torch.as_tensor(v) for k, v in batch.items()},
        {k: torch.as_tensor(v) for k, v in consts.items()}, cfg,
        PC.TrainConfig(), device="cpu")
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = dict(_flat(grads))
    bad = []
    for path, w in _flat(want):
        g = TP.to_np(got[path]).reshape(w.shape)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(g - w)))
        print(f"{path:45s} max|leaf| {scale:.3e} err {d:.3e} "
              f"rel {d / scale:.3e}")
        if d > TOL * scale:
            bad.append((path, d, scale))
    assert not bad, bad


def test_weighted_l1_loss_matches_jax():
    rng = np.random.default_rng(0)
    ou = rng.normal(size=(2, 5, 3, 4, 6)).astype(np.float32)
    os_ = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    tu = rng.normal(size=ou.shape).astype(np.float32)
    ts = rng.normal(size=os_.shape).astype(np.float32)
    want, waux = JT.weighted_l1_loss(*map(jnp.asarray, (ou, os_, tu, ts)),
                                     JC.TrainConfig())
    got, aux = T.weighted_l1_loss(*map(torch.as_tensor, (ou, os_, tu, ts)),
                                  PC.TrainConfig())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("loss_upper", "loss_surface"):
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 249, 250, 499, 500, 10_000])
def test_lr_schedule_matches_jax(step):
    want = JT.lr_schedule(JC.TrainConfig(), steps_per_epoch=10)(step)
    got = T.lr_schedule(PC.TrainConfig(), steps_per_epoch=10)(step)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_three_optimizer_updates_match_optax():
    """Adam with L2 into the gradient and a milestone after the second
    step: three updates on the same gradients."""
    kw = dict(lr=1e-3, weight_decay=0.1, lr_milestones=(2,), lr_gamma=0.5)
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(7, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]

    tx = JT.make_optimizer(JC.TrainConfig(**kw), steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = {k: jp[k] + upd[k] for k in jp}

    opt = T.make_optimizer(PC.TrainConfig(**kw), steps_per_epoch=1)
    params = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    state = T.create_train_state(params, opt)
    for g in grads:
        for k, t in params.items():
            t.grad = torch.as_tensor(g[k])
        opt.apply(state.opt_state)
    for k in p0:
        np.testing.assert_allclose(TP.to_np(params[k]), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


def test_train_loop_early_stopping():
    """Early stop after ``patience`` validations without improvement; the
    best params come back."""
    tcfg = PC.TrainConfig(epochs=50, early_stop_patience=3)
    calls = {"train": 0, "val": 0}
    val_losses = iter([1.0, 0.5, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9])
    seeds = []

    def fake_train_step(state, batch, seed):
        calls["train"] += 1
        seeds.append(seed)
        state.params["w"] += 1.0
        return dataclasses.replace(state, step=state.step + 1), {
            "loss": torch.tensor(1.0)}

    def fake_eval_step(params, batch):
        calls["val"] += 1
        return {"loss": torch.tensor(next(val_losses))}

    state = T.TrainState(params={"w": torch.zeros(1)}, opt_state=None, step=0)
    final, hist = T.train_loop(tcfg, state, fake_train_step, fake_eval_step,
                               train_batches=lambda e: [{}],
                               val_batches=lambda: [{}], seed=7)
    # 2 improving epochs + 3 stale ones: stop at epoch 5
    assert calls["val"] == 5 and calls["train"] == 5
    assert hist["best_val_loss"] == 0.5
    np.testing.assert_allclose(hist["val_loss"], [1.0, 0.5, 0.9, 0.9, 0.9],
                               rtol=1e-6)
    assert float(final.params["w"]) == 2.0          # the params of epoch 2
    assert seeds == [7, 8, 9, 10, 11]


def test_train_loop_returns_a_state_that_trains_on(setup):
    """A 2-epoch ``train_loop`` whose first epoch validates best returns
    that epoch's params in the live leaves the optimizer holds: a further
    ``make_train_step`` step runs on the returned state and starts from
    them (its loss equals the second epoch's, taken from the same params)."""
    params, consts, batch, _, _ = setup
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tcfg = PC.TrainConfig(epochs=2)
    opt = T.make_optimizer(tcfg)
    state = T.create_train_state(T._map(params, lambda t: t.detach().clone()),
                                 opt)
    step = T.make_train_step(CFG, tcfg, consts, opt, device="cpu")
    snaps, losses = [], []

    def train_step(st, b, seed):
        st, metrics = step(st, b, seed)
        snaps.append({k: t.detach().clone() for k, t in _flat(st.params)})
        losses.append(float(metrics["loss"]))
        return st, metrics

    val_losses = iter([0.5, 0.9])
    final, hist = T.train_loop(
        tcfg, state, train_step,
        lambda p, b: {"loss": torch.tensor(next(val_losses))},
        train_batches=lambda e: [batch], val_batches=lambda: [{}], seed=3)
    assert hist["best_val_loss"] == 0.5 and len(snaps) == 2
    for k, t in _flat(final.params):
        assert t.requires_grad and torch.equal(t.detach(), snaps[0][k]), k
    final, metrics = step(final, batch, 11)
    assert final.step == 3 and float(metrics["loss"]) == losses[1]
    assert any(not torch.equal(t.detach(), snaps[0][k])
               for k, t in _flat(final.params))


@pytest.mark.parametrize("preset", ["PANGU_24", "TINY", "MID"])
def test_drop_path_rates_match_jax(preset):
    want = getattr(JC, preset).drop_path_rates()
    got = getattr(PC, preset).drop_path_rates()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert len(got) == getattr(PC, preset).total_blocks


def test_stage_drops_values():
    rates = PC.PANGU_24.drop_path_rates()
    gen = torch.Generator().manual_seed(0)
    drops = pangu._stage_drops(6, rates, 2, gen, 64)
    assert len(drops) == 6
    for j, d in enumerate(drops):
        keep = 1.0 - rates[2 + j]
        assert d.shape == (64, 2) and d.dtype == torch.float32
        vals = set(np.unique(d.numpy()).tolist())
        assert vals <= {0.0, float(np.float32(1.0) / np.float32(keep))}
    # 384 draws at rates 0.03-0.09: some samples are dropped
    assert any(float(d.min()) == 0.0 for d in drops)
    ones = pangu._stage_drops(2, rates, 0, gen, 4)[0]    # rate 0
    assert torch.equal(ones, torch.ones(4, 2))
    assert torch.equal(pangu._stage_drops(3, rates, 5, None, 4)[2],
                       torch.ones(4, 2))

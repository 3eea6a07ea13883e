"""The port's LoRA (``models/lora.py``, LoRA in ``models/pangu.py::forward``,
``engine/train.py``) against the JAX package, TINY, float32, erf GELU:

* ``merge_lora``, ``strip_lora``, ``trainable_mask`` and ``audit`` against
  the JAX functions on an adapter tree made by the JAX ``init_lora`` (B
  drawn non-zero) and carried across by ``params_from_jax`` (scalar leaves
  included): merged kernels 1e-6 abs, the rest equal;
* ``init_lora``'s sites, shapes, bound, zero B, scale and dropout leaves;
* ``forward`` with ``lora_fused`` True (merged: the window-major trunk) and
  False (unmerged: the canonical trunk, block by block where a stage
  carries adapters) against the JAX ``forward`` (``attn_impl="xla"``, the
  adapters unmerged), on a full adapter tree and a partial one (stage 1's
  first block and the UpSample's ``expand``): 5e-4 abs on normalised
  outputs (as tests/test_torch_forward.py);
* the loss and every gradient of a train step (``train_fused=False``, and
  the mixed trunk of the partial tree with ``train_fused=True``) against
  ``jax.value_and_grad`` of the JAX ``forward(deterministic=False)``,
  ``drop_path_max=0``, no LoRA dropout: loss 1e-5 relative, every leaf
  5e-5 x its own max |leaf| (the metric of tests/test_torch_train.py);
* the masked optimizer: an Adam step leaves every frozen leaf bit-equal and
  moves the LoRA factors and ``patch_recovery``."""

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
from pangu_tpu.models import lora as JLORA
from pangu_tpu.models import pangu as JP
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import lora, pangu
from pangu_tpu_torch.models.convert import params_from_jax

TOL = 5e-4
FLOOR = 1e-12
JCFG = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)
CFG = dataclasses.replace(PC.TINY, drop_path_max=0.0)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _adapters(jparams, partial: bool, seed: int = 3, **kw):
    """A JAX adapter tree (rank 4, alpha 8) with B drawn non-zero; partial:
    only stage 1's first block and the UpSample's expand keep theirs."""
    tree = JLORA.init_lora(jax.random.PRNGKey(seed), jparams, rank=4,
                           alpha=8.0, **kw)
    keep = [("stages", 1, "blocks", 0), ("upsample", "expand")]
    for i, (path, _) in enumerate(
            sorted(p for p in _paths(tree) if p[0][-1] == "lora_b")):
        site = _get(tree, path[:-1])
        if partial and not any(path[:len(k)] == k for k in keep):
            for key in JLORA.LORA_KEYS:
                site.pop(key, None)
        else:
            site["lora_b"] = 0.05 * jnp.asarray(
                TP.normal(site["lora_b"].shape, 100 + i))
    return tree


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


@pytest.fixture(scope="module")
def base():
    return TP.port_and_jax_params(PC.TINY, seed=12)


@pytest.fixture(scope="module")
def data():
    consts = synthetic_constants(PC.TINY)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, PC.TINY.levels, PC.TINY.lat, PC.TINY.lon),
                         seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, PC.TINY.lat, PC.TINY.lon), seed + 1))
        return u, s

    (u0, s0), (u1, s1) = state(20), state(22)
    return consts, {"upper": u0, "surface": s0, "target_upper": u1,
                    "target_surface": s1}


def test_merge_strip_mask_audit_match_jax(base):
    jparams, _ = base
    jtree = _adapters(jparams, False, dropout=0.1, dropout_mode="feature")
    ptree = _port(jtree)
    assert isinstance(ptree["upsample"]["mix"]["lora_scale"], torch.Tensor)
    assert ptree["upsample"]["mix"]["lora_drop_feat"].dim() == 0
    merged_j, merged_p = JLORA.merge_lora(jtree), lora.merge_lora(ptree)
    want = dict(_flat(merged_j))
    got = dict(_flat(merged_p))
    assert got.keys() == want.keys()
    for k in want:
        assert TP.max_abs_err(got[k], want[k]) <= 1e-6, k
    stripped = dict(_flat(lora.strip_lora(ptree)))
    assert stripped.keys() == dict(_flat(JLORA.strip_lora(jtree))).keys()
    assert all(torch.equal(stripped[k], v)
               for k, v in _flat(ptree) if k in stripped)
    assert lora.trainable_mask(ptree) == jax.tree.map(
        bool, JLORA.trainable_mask(jtree))
    moved_j = jax.tree.map(lambda t: t, jtree)
    moved_j["patch_recovery"]["upper"]["kernel"] = (
        moved_j["patch_recovery"]["upper"]["kernel"] + 1.0)
    for before_j, after_j in ((jtree, merged_j), (jtree, moved_j)):
        want = JLORA.audit(jax.tree.map(np.asarray, before_j),
                           jax.tree.map(np.asarray, after_j))
        got = lora.audit(_port(before_j), _port(after_j))
        assert got == want
        assert got["updated"]


@pytest.mark.parametrize("mode", ["element", "feature"])
def test_init_lora_shapes_bound_and_zero_b(base, mode):
    jparams, params = base
    tree = lora.init_lora(torch.Generator().manual_seed(0), params, rank=8,
                          alpha=4.0, dropout=0.1, dropout_mode=mode)
    sites = [p for p, _ in _paths(tree) if p[-1] == "lora_a"]
    assert len(sites) == len(JLORA._dense_sites(jparams)) == 35
    key = "lora_drop" if mode == "element" else "lora_drop_feat"
    for path in sites:
        site = _get(tree, path[:-1])
        d_in, d_out = site["kernel"].shape
        assert site["lora_a"].shape == (d_in, 8)
        assert float(site["lora_a"].abs().max()) <= np.sqrt(6.0 / d_in)
        assert float(site["lora_a"].abs().max()) > 0.5 * np.sqrt(6.0 / d_in)
        assert site["lora_b"].shape == (8, d_out)
        assert not site["lora_b"].any()
        assert float(site["lora_scale"]) == 0.5
        assert float(site[key]) == pytest.approx(0.1)
    assert "lora_a" not in params["upsample"]["mix"]        # a copy
    with pytest.raises(ValueError, match="dropout_mode"):
        lora.init_lora(torch.Generator(), params, dropout_mode="token")


@pytest.fixture(scope="module")
def jax_forwards(base, data):
    jparams, _ = base
    consts, b = data
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    fwd = jax.jit(lambda p, u, s: JP.forward(p, u, s, jc, JCFG))
    out = {}
    for partial in (False, True):
        jtree = _adapters(jparams, partial)
        out[partial] = (jtree, fwd(jtree, jnp.asarray(b["upper"]),
                                   jnp.asarray(b["surface"])))
    return out


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("lora_fused", [True, False])
def test_forward_matches_jax(jax_forwards, data, partial, lora_fused):
    consts, b = data
    jtree, want = jax_forwards[partial]
    got = pangu.forward(_port(jtree), torch.as_tensor(b["upper"]),
                        torch.as_tensor(b["surface"]),
                        {k: torch.as_tensor(v) for k, v in consts.items()},
                        dataclasses.replace(CFG, lora_fused=lora_fused),
                        device="cpu")
    for g, w in zip(got, want):
        assert TP.max_abs_err(g, w) <= TOL


@pytest.fixture(scope="module")
def jax_step(jax_forwards, data):
    consts, b = data
    jtree, _ = jax_forwards[True]
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jloss(p, bb):
        ou, os_ = JP.forward(p, bb["upper"], bb["surface"], jc, JCFG,
                             deterministic=False)
        tu, ts = jax_norm_data(bb["target_upper"], bb["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, JC.TrainConfig())[0]

    return jtree, jax.jit(jax.value_and_grad(jloss))(
        jtree, {k: jnp.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("lora_fused,train_fused", [(False, False),
                                                    (True, False),
                                                    (False, True)])
def test_train_step_matches_jax(jax_step, data, lora_fused, train_fused):
    consts, b = data
    jtree, (want_loss, want) = jax_step
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          _port(jtree))
    cfg = dataclasses.replace(CFG, lora_fused=lora_fused,
                              train_fused=train_fused)
    loss, _, grads = T.loss_and_grads(
        params, {k: torch.as_tensor(v) for k, v in b.items()},
        {k: torch.as_tensor(v) for k, v in consts.items()}, cfg,
        PC.TrainConfig(), device="cpu")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(_flat(grads))
    bad = []
    for path, w in _flat(want):
        w = TP.to_np(w).astype(np.float64)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(TP.to_np(got[path]).astype(np.float64)
                                - w.reshape(got[path].shape))))
        if d > 5e-5 * scale:
            bad.append((path, d, scale))
    assert not bad, bad


def test_masked_optimizer_leaves_frozen_bit_equal(base, data):
    _, params = base
    consts, b = data
    params = jax.tree.map(lambda t: t.clone(), params)
    tcfg = dataclasses.replace(PC.TrainConfig(), lr=1e-3, lora_dropout=0.0)
    tree, opt = T.attach_lora(torch.Generator().manual_seed(1), params, tcfg)
    before = {k: v.clone() for k, v in _flat(tree)}
    state = T.create_train_state(tree, opt)
    step = T.make_train_step(CFG, tcfg,
                             {k: torch.as_tensor(v) for k, v in consts.items()},
                             opt, device="cpu")
    state, metrics = step(state, {k: torch.as_tensor(v)
                                  for k, v in b.items()}, 3)
    assert np.isfinite(float(metrics["loss"]))
    report = lora.audit({k: v for k, v in before.items()},
                        dict(_flat(state.params)))
    updated = set(report["updated"])
    for path, leaf in _flat(state.params):
        if "lora_b" in path or "patch_recovery" in path:
            assert path in updated, path            # B from 0: every one
        elif "lora_a" not in path:
            assert torch.equal(leaf, before[path]), path

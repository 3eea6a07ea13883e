"""The canonical-layout route of the port under a (dp, sp, tp) mesh,
trained, in one 4-rank gloo world on the CPU (``parallel/launch.py``), at
TINY, float32: ``engine.train.loss_and_grads`` (one step's loss and its
gradient summed over the view the forward ran under) on every rank
against one device's from the same params, seed and batch (loss 1e-5
relative, each leaf within 5e-5 of its max |value|), and every rank
holding the same gradient bits:

* ``block_layout="v2"`` at (1, 2, 2): tp replicated, so a sum over tp
  would double every leaf;
* ``train_fused=False`` (block by block) and ``attn_impl="xla"`` at
  (1, 2, 2);
* element-mode LoRA dropout at (1, 2, 2) and at (2, 2, 1) with batch 2:
  each rank cuts its part of the one-device masks (dp rows, lon windows);
* odd depths (2, 1, 1, 2) at (1, 2, 2);
* batch 2 at (4, 1, 1): dp does not divide the batch, the view collapses
  to one rank, and the ranks replicate the whole step (a sum over dp
  would count it four times);
* v2 at (1, 2, 2) at drop-path rate 0 against ``jax.value_and_grad`` of
  the JAX package's one-device ``attn_impl="xla"`` forward, from the same
  params (``models/convert.py::params_from_jax``).  The JAX package's own
  sharded training runs Pallas kernels in interpret mode, which hang here:
  it is not run.

Trained taps still raise ``ValueError``, as on one device.  The world runs
in a thread while the one-device and JAX gradients are computed."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
import torch_world
from pangu_tpu import config as JC
from pangu_tpu.data.constants import norm_data as jax_norm_data
from pangu_tpu.engine import train as JT
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch.config import TINY, MeshConfig, TrainConfig
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.models import lora, pangu
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.parallel import launch, sharding
from pangu_tpu_torch.parallel import mesh as M

B, SEED = 2, 71
TOL_LOSS, TOL_GRAD = 1e-5, 5e-5
TCFG = TrainConfig()
V2 = dataclasses.replace(TINY, block_layout="v2")
ODD = dataclasses.replace(TINY, depths=(2, 1, 1, 2))
JAX_V2 = dataclasses.replace(V2, drop_path_max=0.0)
JAX_CFG = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)
# key -> (mesh, cfg, tree, batch)
CASES = {"v2 (1, 2, 2)": ((1, 2, 2), V2, "base", B),
         "per_block (1, 2, 2)": ((1, 2, 2),
                                 dataclasses.replace(TINY, train_fused=False),
                                 "base", B),
         "xla (1, 2, 2)": ((1, 2, 2), dataclasses.replace(TINY,
                                                          attn_impl="xla"),
                           "base", B),
         "element_lora (1, 2, 2)": ((1, 2, 2), TINY, "element", 1),
         "element_lora (2, 2, 1)": ((2, 2, 1), TINY, "element", B),
         "odd depths (1, 2, 2)": ((1, 2, 2), ODD, "odd", B),
         "batch (4, 1, 1)": ((4, 1, 1), TINY, "base", B)}
JAX_KEY = "v2 drop 0 (1, 2, 2)"


@pytest.fixture(scope="module")
def results():
    jparams, _ = TP.port_and_jax_params(TINY, seed=72)
    base = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    element = lora.init_lora(torch.Generator().manual_seed(73), base, rank=4,
                             dropout=0.3, dropout_mode="element")
    gen = torch.Generator().manual_seed(74)
    for site in lora._dense_nodes(element):     # B nonzero: A learns too
        site["lora_b"] = 0.01 * torch.randn(site["lora_b"].shape,
                                            generator=gen)
    trees = {"base": base, "element": element,
             "odd": pangu.init_params(torch.Generator().manual_seed(75), ODD,
                                      device="cpu")}
    consts = synthetic_constants(TINY)
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    shape_u = (B, 5, TINY.levels, TINY.lat, TINY.lon)
    shape_s = (B, 4, TINY.lat, TINY.lon)
    batch = {"upper": um + us * TP.normal(shape_u, 76),
             "surface": sm + ss * TP.normal(shape_s, 77),
             "target_upper": um + us * TP.normal(shape_u, 78),
             "target_surface": sm + ss * TP.normal(shape_s, 79)}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    cases = [(key, shape, cfg, trees[tree], b)
             for key, (shape, cfg, tree, b) in CASES.items()]
    cases.append((JAX_KEY, (1, 2, 2), JAX_V2, base, B))
    box = {}

    def world():
        try:
            box["world"] = launch.run(torch_world.canon_train, 4, cases, TCFG,
                                      tc, tb, SEED, device="cpu",
                                      timeout_s=150)
        except Exception as e:           # re-raised in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jloss(p, bt):
        ou, os_ = jax_pangu.forward(p, bt["upper"], bt["surface"], jc,
                                    JAX_CFG, deterministic=False)
        tu, ts = jax_norm_data(bt["target_upper"], bt["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, JC.TrainConfig())[0]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    single = {}
    for key, _, cfg, tree, b in cases[:-1]:
        single[key] = torch_world.grads_case(
            cfg, tree, TCFG, tc, {k: v[:b] for k, v in tb.items()}, SEED)
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    return {"world": box["world"], "single": single,
            "jax": (float(jv), jax.tree.map(np.asarray, jg)),
            "params": base, "consts": tc, "batch": tb}


def _worst(got, want):
    """The leaves whose max |got - want| exceeds TOL_GRAD of max |want|."""
    bad = []
    for (path, g), (_, w) in zip(sharding._paths(got), sharding._paths(want)):
        if w is None:
            assert g is None, path
            continue
        g, w = TP.to_np(g).reshape(np.shape(w)), TP.to_np(w)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        if err > TOL_GRAD * scale:
            bad.append((path, err, scale))
    return bad


def _ranks(results, key, shape):
    ranks = [r[key] for r in results["world"][:int(np.prod(shape))]]
    assert len(ranks) == int(np.prod(shape))
    return ranks


@pytest.mark.parametrize("key", sorted(CASES))
def test_trained_route_matches_one_device(results, key):
    want_loss, want = results["single"][key]
    for r in _ranks(results, key, CASES[key][0]):
        assert abs(float(r["loss"]) - float(want_loss)) <= (
            TOL_LOSS * abs(float(want_loss)))
        assert not _worst(r["grads"], want), key


@pytest.mark.parametrize("key", sorted(CASES))
def test_every_rank_holds_the_same_gradient(results, key):
    shape = CASES[key][0]
    ranks = _ranks(results, key, shape)
    for r in ranks[1:]:
        for (path, a), (_, b) in zip(sharding._paths(r["grads"]),
                                     sharding._paths(ranks[0]["grads"])):
            assert (a is None and b is None) or torch.equal(a, b), path
    # a view of one rank exchanges nothing; a sharded one sums its gradient
    sums = ranks[0]["by_op"].get("all_reduce", [0])[0]
    assert (sums > 0) == (key != "batch (4, 1, 1)"), ranks[0]["by_op"]


def test_v2_on_a_mesh_matches_jax(results):
    want_loss, want = results["jax"]
    for r in _ranks(results, JAX_KEY, (1, 2, 2)):
        np.testing.assert_allclose(float(r["loss"]), want_loss,
                                   rtol=TOL_LOSS)
        assert not _worst(r["grads"], want)


def test_trained_taps_raise_under_a_mesh(results):
    """Taps are collected by the served forward only, on one device and
    under a mesh alike."""
    mesh = M.Mesh(cfg=MeshConfig(1, 2, 2), coords={"dp": 0, "sp": 0, "tp": 0},
                  lines={}, groups={}, device=torch.device("cpu"),
                  host_staged=False)
    b = results["batch"]
    with sharding.use_mesh(mesh), pytest.raises(ValueError, match="taps"):
        pangu.forward(results["params"], b["upper"], b["surface"],
                      results["consts"], TINY, device="cpu", taps={},
                      deterministic=False)

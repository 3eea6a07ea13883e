"""The port's training under a (dp, sp, tp) mesh, in one 4-rank gloo world
on the CPU (``parallel/launch.py``), at TINY, float32, batch 2, for the
meshes (1, 2, 2) (both halos, the tables sliced over tp) and (2, 1, 2)
(the batch over dp):

* the differentiable collectives: the backward of ``_lon_shift_wm`` /
  ``_z_shift_wm`` on sp = 2 / tp = 2 shards, gathered, equals the backward
  of the one-device shift and ``jax.vjp`` of the JAX shift (exact: both
  only move values); the backward of ``Mesh.all_gather`` is the rank's
  slice, with no exchange; ``Mesh.all_reduce`` sums over the named axes
  only;
* two ``make_train_step`` steps (drop-path rate 0.2, the same seeds) on
  every rank against the port's one-device steps from the same params
  (``models/convert.py::params_from_jax``): each loss within 1e-6
  relative, every leaf of the first step's gradient within 1e-5 of the
  leaf's max |value|, the params bit-equal across ranks after each step
  and within 2e-6 of one device's after two (0.4 x the learning rate: a
  step moves a leaf by at most ~lr);
* a feature-mode LoRA tree under (1, 2, 2): the factors' gradients match
  one device's (1e-5 of each leaf's max) and the frozen base keeps its
  bits;
* ``block_bwd`` on a shard whose shift would read across shards raises;
  and ``launch.run`` asks for the card unless told otherwise.  (What the
  window-major trunk does not train under a mesh trains through the
  canonical route: ``tests/test_torch_parallel_canon_train.py``.)

The world runs in a thread while the one-device steps are computed, so
the file stays well inside its time; the sharded step against the JAX
package is ``tests/test_torch_parallel_train_jax.py``'s."""

import dataclasses
import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
import torch_world
from pangu_tpu.ops import earth_block_wm as JW
from pangu_tpu_torch.config import TINY, MeshConfig, TrainConfig
from pangu_tpu_torch.data.constants import synthetic_constants
from pangu_tpu_torch.engine import train as T
from pangu_tpu_torch.models import lora
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops.earth_block_bwd import block_bwd
from pangu_tpu_torch.ops.earth_block_wm import _lon_shift_wm, _z_shift_wm
from pangu_tpu_torch.parallel import launch
from pangu_tpu_torch.parallel import sharding

MESHES = [(1, 2, 2), (2, 1, 2)]
B, STEPS, SEED = 2, 2, 31
TOL_LOSS, TOL_GRAD, TOL_PARAMS = 1e-6, 1e-5, 2e-6
TCFG = TrainConfig()
LORA_TCFG = dataclasses.replace(TCFG, lora_rank=4,
                                lora_dropout_mode="feature")
G0 = TINY.stage(0)
NZ = G0.z // G0.window[0]
LON_SHIFTS, Z_SHIFTS = (6, -6), (1, -1)


def _storage(seed):
    wz, wh, ww = G0.window
    return TP.normal((1, NZ, G0.h_padded // wh, G0.w // ww, wz * wh * ww,
                      G0.dim), seed)


def _runs(params, lora_tree, meshes):
    runs = []
    for m in meshes:
        mc = MeshConfig(*m)
        runs.append((("drop",) + m, mc, TINY, params, False, STEPS))
    runs.append((("lora",) + meshes[0], MeshConfig(*meshes[0]), TINY,
                 lora_tree, True, 1))
    return runs


@pytest.fixture(scope="module")
def results():
    # the port's draws as the JAX tree, then back through params_from_jax
    # (quicker than tracing the JAX init)
    jparams, _ = TP.port_and_jax_params(TINY, seed=17)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    consts = synthetic_constants(TINY)
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    batch = {"upper": um + us * TP.normal((B, 5, TINY.levels, TINY.lat,
                                           TINY.lon), 18),
             "surface": sm + ss * TP.normal((B, 4, TINY.lat, TINY.lon), 19),
             "target_upper": um + us * TP.normal((B, 5, TINY.levels,
                                                  TINY.lat, TINY.lon), 20),
             "target_surface": sm + ss * TP.normal((B, 4, TINY.lat,
                                                    TINY.lon), 21)}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tc = {k: torch.as_tensor(v) for k, v in consts.items()}
    lora_tree = lora.init_lora(torch.Generator().manual_seed(22), params,
                               rank=LORA_TCFG.lora_rank, dropout=0.1,
                               dropout_mode="feature")
    gen = torch.Generator().manual_seed(23)
    for site in lora._dense_nodes(lora_tree):      # B nonzero: A learns too
        site["lora_b"] = 0.01 * torch.randn(site["lora_b"].shape,
                                            generator=gen)
    xs, cot = _storage(24), _storage(25)

    box = {}

    def world():
        try:
            box["world"] = launch.run(
                torch_world.train_world, 4,
                (torch.as_tensor(xs), G0.window, LON_SHIFTS, Z_SHIFTS,
                 torch.as_tensor(cot)),
                (_runs(params, lora_tree, MESHES), TCFG, tc, tb, SEED),
                device="cpu", timeout_s=120)
        except Exception as e:           # re-raised in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    single = torch_world.train(
        [(k[:1], MeshConfig(), cfg, tree, masked, steps)
         for k, _, cfg, tree, masked, steps in _runs(params, lora_tree,
                                                     MESHES[:1])],
        TCFG, tc, tb, SEED)
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    return {"world": box["world"], "single": single, "lora_tree": lora_tree,
            "xs": xs, "cot": cot, "params": params, "consts": tc, "batch": tb}


def _worst(got, want):
    """The worst leaf's max |got - want| / max |want| and its path."""
    worst = (0.0, None)
    for (path, g), (_, w) in zip(sharding._paths(got), sharding._paths(want)):
        if w is None:
            assert g is None, path
            continue
        g, w = TP.to_np(g).reshape(np.shape(w)), TP.to_np(w)
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w))) / max(scale, 1e-30)
        if scale and err > worst[0]:
            worst = (err, path)
    return worst


# ---- the collectives -------------------------------------------------------

@pytest.mark.parametrize("kind,d", [("lon", d) for d in LON_SHIFTS]
                         + [("z", d) for d in Z_SHIFTS])
def test_halo_backward_matches_one_device_and_jax(results, kind, d):
    xs, cot = results["xs"], results["cot"]
    fn, k, key = ((_lon_shift_wm, G0.window[2], (2, 1, d)) if kind == "lon"
                  else (_z_shift_wm, G0.window[0], (1, 2, d)))
    x = torch.as_tensor(xs).clone().requires_grad_()
    fn(x, d, k).backward(torch.as_tensor(cot))
    jfn = JW._lon_shift_wm if kind == "lon" else JW._z_shift_wm
    _, vjp = jax.vjp(lambda t: jfn(t, d, k, None, 1), jnp.asarray(xs))
    want_jax = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_array_equal(x.grad.numpy(), want_jax)
    ranks = [r["collectives"] for r in results["world"][:2]]
    for r in ranks:
        np.testing.assert_array_equal(r[key].numpy(), x.grad.numpy())


def test_all_gather_backward_is_the_rank_slice(results):
    # (1, 2, 2): rank r has sp coordinate r // 2; the cotangent is 0..5
    for rank, r in enumerate(results["world"]):
        c = r["collectives"]
        sp = rank // 2
        assert c["all_gather_grad"].tolist() == [3.0 * sp + i
                                                 for i in range(3)]
        # two reduces over one axis, one over two, one gather: the
        # backward exchanged nothing
        assert c["all_gather_exchanges"] == 5


def test_all_reduce_sums_over_the_named_axes_only(results):
    for rank, r in enumerate(results["world"]):
        c = r["collectives"]
        # (1, 2, 2): rank = sp * 2 + tp, the value rank + 1
        tp, sp = rank % 2, rank // 2
        assert c[("all_reduce", 1, 2, 2)] == {
            ("sp",): (tp + 1) + (tp + 3), ("tp",): (2 * sp + 1) + (2 * sp + 2),
            ("sp", "tp"): 10.0}
        # (2, 1, 2): rank = dp * 2 + tp; sp has one rank: no sum
        dp = rank // 2
        assert c[("all_reduce", 2, 1, 2)] == {
            ("dp",): (tp + 1) + (tp + 3), ("sp",): rank + 1.0}


# ---- the sharded train step ------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_steps_match_one_device(results, mesh):
    single = results["single"][("drop",)]
    ranks = [r["train"][("drop",) + mesh] for r in results["world"]]
    for rank in ranks:
        for got, want in zip(rank["loss"], single["loss"]):
            assert abs(float(got) - float(want)) <= TOL_LOSS * abs(float(want))
        err, path = _worst(rank["grads"], single["grads"])
        print(mesh, "worst gradient leaf", path, f"{err:.2e}")
        assert err <= TOL_GRAD, path
        assert rank["exchanges"] > 0
        for a, b in zip(T._leaves(rank["params"][-1]),
                        T._leaves(single["params"][-1])):
            assert float((a - b).abs().max()) <= TOL_PARAMS
    for i in range(STEPS):       # every rank holds the same bits
        for rank in ranks[1:]:
            for a, b in zip(T._leaves(rank["params"][i]),
                            T._leaves(ranks[0]["params"][i])):
                assert torch.equal(a, b)
            assert torch.equal(rank["grad_norm"][i], ranks[0]["grad_norm"][i])


def test_lora_tree_under_a_mesh(results):
    single = results["single"][("lora",)]
    before = results["lora_tree"]
    mask = lora.trainable_mask(before)
    for r in results["world"]:
        rec = r["train"][("lora",) + MESHES[0]]
        assert abs(float(rec["loss"][0]) - float(single["loss"][0])) <= (
            TOL_LOSS * abs(float(single["loss"][0])))
        after = rec["params"][0]
        for (path, m), (_, g), (_, w), (_, a), (_, b0) in zip(
                sharding._paths(mask), sharding._paths(rec["grads"]),
                sharding._paths(single["grads"]), sharding._paths(after),
                sharding._paths(before)):
            if m and path[-1] in ("lora_a", "lora_b"):
                # zero where both samples dropped the branch
                scale = float(w.abs().max())
                assert float((g - w).abs().max()) <= TOL_GRAD * scale, path
                assert not torch.equal(a, b0), path   # trained (L2 at least)
            elif not m:
                assert torch.equal(a, b0), path        # the frozen base


# ---- what raises -----------------------------------------------------------

def test_block_bwd_on_a_shard_raises_on_a_read_across_shards(results):
    bp = results["params"]["stages"][0]["blocks"][1]
    xs = torch.as_tensor(results["xs"])
    ids = torch.as_tensor(window_region_ids(G0.z, G0.h_padded, G0.window))
    nlat = G0.h_padded // G0.window[1]
    z_shard = xs[:, :1].contiguous()
    table = bp["attn"]["bias_table"][:nlat]
    zp = {**bp, "attn": {**bp["attn"], "bias_table": table}}
    # a lat-only shift on the z shard runs, with the sliced ids and table
    dx, grads = block_bwd(zp, z_shard, z_shard, G0, (0, 3, 0), (0, 0, 0), 3,
                          ids[:nlat], None, False)
    assert dx.shape == z_shard.shape
    assert grads["attn"]["bias_table"].shape == table.shape
    lon_shard = xs[:, :, :, :2].contiguous()
    for x, dx_, dg in ((z_shard, (1, 3, 0), (0, 0, 0)),
                       (z_shard, (0, 3, 0), (-1, 0, 0)),
                       (lon_shard, (0, 3, 6), (0, 0, 0))):
        p = zp if x is z_shard else bp
        with pytest.raises(ValueError, match="reads across shards"):
            block_bwd(p, x, x, G0, dx_, dg, 3, None, None, False)


def test_launch_defaults_to_the_card():
    assert inspect.signature(launch.run).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.run(torch_world.cli_main, 2, [])

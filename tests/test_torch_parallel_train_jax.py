"""The port's sharded train step against the JAX package, in one 4-rank gloo
world on the CPU (``parallel/launch.py``), at TINY, float32, batch 2,
drop-path rate 0: one ``make_train_step`` step under the meshes (1, 2, 2)
and (2, 1, 2), every rank's loss and summed gradient against
``jax.value_and_grad`` of the JAX ``forward(deterministic=False)`` at
``attn_impl="xla"`` on one device, from the same params (the port's draws
through ``models/convert.py::params_from_jax``), with
``tests/test_torch_train.py``'s tolerances: loss 1e-5 relative, each leaf
5e-5 of its own max |value|.  (The JAX package's own sharded training runs
Pallas kernels in interpret mode, which hang here: it is not run.)

The world runs in a thread while the JAX gradient is computed."""

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
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.parallel import launch, sharding

MESHES = [(1, 2, 2), (2, 1, 2)]
B, SEED = 2, 41
TOL_LOSS, TOL_GRAD = 1e-5, 5e-5
CFG = dataclasses.replace(TINY, drop_path_max=0.0)
JAX_CFG = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0)


@pytest.fixture(scope="module")
def results():
    jparams, _ = TP.port_and_jax_params(CFG, seed=42)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    consts = synthetic_constants(CFG)
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    shape_u = (B, 5, CFG.levels, CFG.lat, CFG.lon)
    shape_s = (B, 4, CFG.lat, CFG.lon)
    batch = {"upper": um + us * TP.normal(shape_u, 43),
             "surface": sm + ss * TP.normal(shape_s, 44),
             "target_upper": um + us * TP.normal(shape_u, 45),
             "target_surface": sm + ss * TP.normal(shape_s, 46)}
    box = {}

    def world():
        try:
            box["world"] = launch.run(
                torch_world.train,
                4, [(m, MeshConfig(*m), CFG, params, False, 1) for m in MESHES],
                TrainConfig(), {k: torch.as_tensor(v) for k, v in
                                consts.items()},
                {k: torch.as_tensor(v) for k, v in batch.items()}, SEED,
                device="cpu", timeout_s=120)
        except Exception as e:           # re-raised in the test's thread
            box["error"] = e

    thread = threading.Thread(target=world)
    thread.start()
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jloss(p, b):
        ou, os_ = jax_pangu.forward(p, b["upper"], b["surface"], jc, JAX_CFG,
                                    deterministic=False)
        tu, ts = jax_norm_data(b["target_upper"], b["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, JC.TrainConfig())[0]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = (float(jv), jax.tree.map(np.asarray, jg))
    thread.join(timeout=300)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    return box["world"], want


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_jax(results, mesh):
    world, (want_loss, want) = results
    for r in world:
        rec = r[mesh]
        np.testing.assert_allclose(float(rec["loss"][0]), want_loss,
                                   rtol=TOL_LOSS)
        bad = []
        for (path, g), (_, w) in zip(sharding._paths(rec["grads"]),
                                     sharding._paths(want)):
            g = TP.to_np(g).reshape(w.shape)
            scale = float(np.max(np.abs(w)))
            err = float(np.max(np.abs(g - w)))
            if err > TOL_GRAD * scale:
                bad.append((path, err, scale))
        assert not bad, bad

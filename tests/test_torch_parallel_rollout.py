"""The port's sharded forward and token-space rollout in one 4-rank gloo
world on the CPU (``parallel/launch.py``), at TINY, float32, batch 2, for
the meshes (dp, sp, tp) = (1, 2, 2) (both halos) and (2, 1, 2) (the JAX
package's ``tests/test_parallel.py`` mesh: the batch over dp):

* ``forward`` and a 2-step ``make_rollout(token_space=True)`` on every rank
  against the port's single-device run of the same params and inputs, max
  abs error within 1e-5 of the max (the plain versions on CPU tensors move
  each value as one device does);
* the sharded rollout against the JAX single-device ``make_rollout(CFG,
  consts, 2)`` (``attn_impl="xla"``), max abs error 5e-4 on normalised
  outputs, the tolerance of ``tests/test_torch_forward.py``;
* every rank returns the whole batch, the same on every rank, and the
  trunk exchanged halos."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import torch_parity as TP
import torch_world
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine.rollout import make_rollout as jax_make_rollout
from pangu_tpu_torch.config import TINY, MeshConfig
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.engine.rollout import make_rollout
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.parallel import launch

TOL_PORT = 1e-5
TOL_JAX = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")
MESHES = [(1, 2, 2), (2, 1, 2)]
B, STEPS = 2, 2


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.port_and_jax_params(TINY, seed=13)
    consts = synthetic_constants(TINY)
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    upper = um + us * TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), 14)
    surface = sm + ss * TP.normal((B, 4, TINY.lat, TINY.lon), 15)
    return jparams, params, consts, upper, surface


@pytest.fixture(scope="module")
def world(setup):
    _, params, consts, upper, surface = setup
    return launch.run(torch_world.serve, 4, [MeshConfig(*m) for m in MESHES],
                      TINY, params, consts, torch.as_tensor(upper),
                      torch.as_tensor(surface), STEPS, device="cpu", timeout_s=60)


@pytest.fixture(scope="module")
def single(setup):
    _, params, consts, upper, surface = setup
    u, s = torch.as_tensor(upper), torch.as_tensor(surface)
    return {"forward": pangu.forward(params, u, s, consts, TINY, device="cpu"),
            "rollout": make_rollout(TINY, consts, STEPS, token_space=True,
                                    device="cpu")(params, u, s)}


def _rel(got, want):
    return TP.max_abs_err(got, want) / float(want.abs().max())


@pytest.mark.parametrize("entry", ["forward", "rollout"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_matches_the_single_device_port(world, single, mesh, entry):
    for rank in world:
        got = rank[mesh][entry]
        for g, w in zip(got, single[entry]):
            assert g.shape == w.shape
            assert _rel(g, w) <= TOL_PORT
    assert all(r[mesh]["exchanges"] > 0 for r in world)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_rollout_matches_jax(setup, world, mesh):
    jparams, _, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    want = jax_make_rollout(JAX_CFG, jc, STEPS)(
        jparams, jnp.asarray(upper), jnp.asarray(surface))
    t = {k: torch.as_tensor(v) for k, v in consts.items()}
    got = world[0][mesh]["rollout"]
    for g, w in zip(norm_data(*got, t),
                    norm_data(*(torch.as_tensor(TP.to_np(x)) for x in want),
                              t)):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL_JAX


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_returns_the_same_whole_batch(world, mesh):
    for entry in ("forward", "rollout"):
        first = world[0][mesh][entry]
        assert first[0].shape[0] == B
        for rank in world[1:]:
            assert all(torch.equal(a, b)
                       for a, b in zip(rank[mesh][entry], first))

"""The port's hierarchical rollout (``greedy_schedule``,
``make_hierarchical_rollout``, one device) against the JAX package's.  Two
TINY parameter sets stand for the 24 h and 6 h models; a 54 h horizon gives
the schedule [24, 24, 6]: a group of two steps (one model's own transition
between them) and a hand-off (the 24 h model's recovery into the 6 h
model's embed).  Full-step, token-space, and token-space with the edge
kernels, all against the JAX full-step hierarchy with ``attn_impl="xla"``
(one function), float32.  Tolerance: max abs error 5e-4 on normalised
outputs, as for the single-model rollouts."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine.rollout import greedy_schedule as jax_greedy_schedule
from pangu_tpu.engine.rollout import \
    make_hierarchical_rollout as jax_make_hierarchical_rollout
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.engine.rollout import (greedy_schedule,
                                            make_hierarchical_rollout)

TOL = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")
HORIZON, MODELS = 54, (24, 6)


@pytest.mark.parametrize("horizon,available", [
    (24, (24, 6, 3, 1)), (30, (24, 6, 3, 1)), (31, (24, 6, 3, 1)),
    (168, (24, 6, 3, 1)), (54, (24, 6)), (9, (6, 3)), (1, (24, 1))])
def test_greedy_schedule_matches_jax(horizon, available):
    got = greedy_schedule(horizon, available)
    assert got == jax_greedy_schedule(horizon, available)
    assert sum(got) == horizon and got == sorted(got, reverse=True)


@pytest.mark.parametrize("horizon,available", [(5, (24, 6, 3)), (0, (24,)),
                                               (-24, (24, 6))])
def test_greedy_schedule_rejects_what_jax_rejects(horizon, available):
    with pytest.raises(ValueError):
        jax_greedy_schedule(horizon, available)
    with pytest.raises(ValueError):
        greedy_schedule(horizon, available)


@pytest.fixture(scope="module")
def setup():
    ja, pa = TP.jax_and_port_params(JAX_CFG, seed=3)
    jb, pb = TP.jax_and_port_params(JAX_CFG, seed=4)
    consts = synthetic_constants(TINY)
    upper = consts["upper_mean"][None] + consts["upper_std"][None] * TP.normal(
        (1, 5, TINY.levels, TINY.lat, TINY.lon), 1)
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * TP.normal((1, 4, TINY.lat, TINY.lon), 2))
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    rollout, schedule = jax_make_hierarchical_rollout(JAX_CFG, jc, HORIZON,
                                                      MODELS)
    want = rollout({24: ja, 6: jb}, jnp.asarray(upper), jnp.asarray(surface))
    return {24: pa, 6: pb}, consts, upper, surface, schedule, want


@pytest.mark.parametrize("token_space,edge", [(False, False), (True, False),
                                              (True, True)])
def test_hierarchical_rollout_matches_jax(setup, token_space, edge):
    params, consts, upper, surface, want_schedule, want = setup
    cfg = dataclasses.replace(TINY, edge_kernels=edge)
    rollout, schedule = make_hierarchical_rollout(
        cfg, consts, HORIZON, MODELS, token_space=token_space, device="cpu")
    assert schedule == want_schedule == [24, 24, 6]
    got = rollout(params, torch.as_tensor(upper), torch.as_tensor(surface))
    t = {k: torch.as_tensor(v) for k, v in consts.items()}
    for g, w in zip(norm_data(*got, t),
                    norm_data(*(torch.as_tensor(TP.to_np(w)) for w in want),
                              t)):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


def test_hierarchical_rollout_uses_each_model(setup):
    """Swapping the two models changes the result: the hand-off really
    switches parameter sets."""
    params, consts, upper, surface, _, _ = setup
    rollout, _ = make_hierarchical_rollout(TINY, consts, 30, MODELS,
                                           token_space=True, device="cpu")
    a = rollout(params, torch.as_tensor(upper), torch.as_tensor(surface))
    b = rollout({24: params[6], 6: params[24]}, torch.as_tensor(upper),
                torch.as_tensor(surface))
    assert not torch.allclose(a[0], b[0])


def test_hierarchical_token_space_refuses_lora(setup):
    """Named for the slices that refused LoRA leaves: the token-space
    hierarchy now takes them, unmerged, on the canonical chain (block by
    block where a stage carries adapters), and agrees with the same rollout
    of the merged tree (the window-major chain); the adapters count."""
    from pangu_tpu_torch.models import lora
    params, consts, upper, surface, _, _ = setup
    tree = lora.init_lora(torch.Generator().manual_seed(5), params[24],
                          rank=2, alpha=2.0)
    site = tree["stages"][0]["blocks"][0]["attn"]["qkv"]
    site["lora_b"] = 0.1 * torch.as_tensor(TP.normal(site["lora_b"].shape, 9))
    rollout, _ = make_hierarchical_rollout(TINY, consts, 30, MODELS,
                                           token_space=True, device="cpu")
    args = (torch.as_tensor(upper), torch.as_tensor(surface))
    got = rollout({24: tree, 6: params[6]}, *args)
    merged = rollout({24: lora.merge_lora(tree), 6: params[6]}, *args)
    base = rollout({24: params[24], 6: params[6]}, *args)
    c = {k: torch.as_tensor(v) for k, v in consts.items()}
    for g, m, b in zip(norm_data(*got, c), norm_data(*merged, c),
                       norm_data(*base, c)):
        assert TP.max_abs_err(g, m) <= 1e-5
        assert TP.max_abs_err(g, b) > 1e-3


def test_hierarchical_rollout_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_hierarchical_rollout(TINY, synthetic_constants(TINY), 30, MODELS)

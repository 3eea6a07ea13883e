"""The port's ``block_layout="v2"`` served paths against the JAX package
(``attn_impl="xla"``, one jitted 24 h step chained for the multi-step
references) at TINY, float32, erf GELU, from the same parameters and inputs:
the forward; the full-step and token-space rollouts (3 steps, with and
without the trajectory); the hierarchical rollout (two parameter sets, 54 h:
schedule [24, 24, 6]), full-step and token-space; ``forward(taps=...)``,
every tap; and a forward at odd depths (2, 3, 3, 2), which the window-major
trunk refuses and where stages 1 and 2 run as two chains.  Tolerance: max
abs error 5e-4 on normalised outputs and taps (float32 reassociation across
the blocks, down / up and the recovery, as tests/test_torch_forward.py).

The port's v2 and wm forwards from the same parameters agree to 1e-5 (both
plain compositions of the same float32 operations on CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.engine.rollout import single_step as jax_single_step
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.engine.rollout import (make_hierarchical_rollout,
                                            make_rollout)
from pangu_tpu_torch.models import pangu

TOL = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")
V2 = dataclasses.replace(TINY, block_layout="v2")
STEPS = 3
TAPS = ["embed", "stage0", "downsample", "stage1", "stage2", "upsample",
        "stage3"]


@pytest.fixture(scope="module")
def setup():
    (ja, pa), (jb, pb) = (TP.port_and_jax_params(TINY, seed=s) for s in (3, 4))
    consts = synthetic_constants(TINY)
    upper = consts["upper_mean"][None] + consts["upper_std"][None] * TP.normal(
        (1, 5, TINY.levels, TINY.lat, TINY.lon), 1)
    surface = (consts["surface_mean"][None] + consts["surface_std"][None]
               * TP.normal((1, 4, TINY.lat, TINY.lon), 2))
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    step = jax.jit(lambda p, u, s: jax_single_step(p, u, s, jc, JAX_CFG))
    return {"jax": (ja, jb), "port": (pa, pb), "consts": consts,
            "upper": upper, "surface": surface, "jc": jc, "step": step}


def _chain(setup, models):
    """JAX states after each step of the given parameter sets."""
    u, s = jnp.asarray(setup["upper"]), jnp.asarray(setup["surface"])
    out = []
    for p in models:
        u, s = setup["step"](p, u, s)
        out.append((u, s))
    return out


def _assert_states_close(setup, got, want):
    t = {k: torch.as_tensor(v) for k, v in setup["consts"].items()}
    for g, w in zip(norm_data(*got, t),
                    norm_data(*(torch.as_tensor(TP.to_np(a)) for a in want),
                              t)):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


def _inputs(setup):
    return torch.as_tensor(setup["upper"]), torch.as_tensor(setup["surface"])


def test_v2_forward_matches_jax(setup):
    ja, pa = setup["jax"][0], setup["port"][0]
    want = jax.jit(lambda p, u, s: jax_pangu.forward(p, u, s, setup["jc"],
                                                     JAX_CFG))(
        ja, jnp.asarray(setup["upper"]), jnp.asarray(setup["surface"]))
    got = pangu.forward(pa, *_inputs(setup), setup["consts"], V2,
                        device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


@pytest.mark.parametrize("token_space", [False, True])
@pytest.mark.parametrize("return_trajectory", [False, True])
def test_v2_rollout_matches_jax(setup, token_space, return_trajectory):
    want = _chain(setup, [setup["jax"][0]] * STEPS)
    got = make_rollout(V2, setup["consts"], STEPS, token_space=token_space,
                       return_trajectory=return_trajectory, device="cpu")(
        setup["port"][0], *_inputs(setup))
    if return_trajectory:
        final, (tu, ts) = got
        assert tu.shape[0] == ts.shape[0] == STEPS
        for i in range(STEPS):
            _assert_states_close(setup, (tu[i], ts[i]), want[i])
        got = final
    _assert_states_close(setup, got, want[-1])


@pytest.mark.parametrize("token_space", [False, True])
def test_v2_hierarchical_rollout_matches_jax(setup, token_space):
    (ja, jb), (pa, pb) = setup["jax"], setup["port"]
    rollout, schedule = make_hierarchical_rollout(
        V2, setup["consts"], 54, (24, 6), token_space=token_space,
        device="cpu")
    assert schedule == [24, 24, 6]
    got = rollout({24: pa, 6: pb}, *_inputs(setup))
    _assert_states_close(setup, got, _chain(setup, [ja, ja, jb])[-1])


@pytest.fixture(scope="module")
def taps_both(setup):
    ja, pa = setup["jax"][0], setup["port"][0]

    def jax_fwd(p, u, s):
        taps = {}
        out = jax_pangu.forward(p, u, s, setup["jc"], JAX_CFG, taps=taps)
        return out, taps

    want = jax.jit(jax_fwd)(ja, jnp.asarray(setup["upper"]),
                            jnp.asarray(setup["surface"]))
    taps = {}
    got = pangu.forward(pa, *_inputs(setup), setup["consts"], V2,
                        device="cpu", taps=taps)
    return want, (got, taps)


@pytest.mark.parametrize("name", TAPS + ["output"])
def test_v2_taps_match_jax(taps_both, name):
    (want_out, want), (got_out, got) = taps_both
    assert set(got) == set(want) == set(TAPS)
    pairs = (list(zip(got_out, want_out)) if name == "output"
             else [(got[name], want[name])])
    for g, w in pairs:
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


def test_v2_forward_at_odd_depths_matches_jax(setup):
    """Odd depths under v2, and (accepted there too, as by the JAX package)
    under the window-major layout, whose stages then run the canonical
    stage chain (``run_stage_wm(io_layout="canon")``)."""
    depths = (2, 3, 3, 2)
    cfg = dataclasses.replace(V2, depths=depths)
    jparams, params = TP.port_and_jax_params(cfg, seed=5)
    jcfg = dataclasses.replace(JAX_CFG, depths=depths)
    want = jax.jit(lambda p, u, s: jax_pangu.forward(p, u, s, setup["jc"],
                                                     jcfg))(
        jparams, jnp.asarray(setup["upper"]), jnp.asarray(setup["surface"]))
    for c in (cfg, dataclasses.replace(TINY, depths=depths)):
        got = pangu.forward(params, *_inputs(setup), setup["consts"], c,
                            device="cpu")
        for g, w in zip(got, want):
            assert TP.max_abs_err(g, w) <= TOL


def test_v2_and_wm_forwards_agree(setup):
    pa = setup["port"][0]
    v2 = pangu.forward(pa, *_inputs(setup), setup["consts"], V2, device="cpu")
    wm = pangu.forward(pa, *_inputs(setup), setup["consts"], TINY,
                       device="cpu")
    for a, b in zip(v2, wm):
        assert TP.max_abs_err(a, b) <= 1e-5

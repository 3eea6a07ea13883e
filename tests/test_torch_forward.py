"""The port's served forward and chained rollout against the JAX package
(``forward`` and ``make_rollout(token_space=False)`` with
``attn_impl="xla"``) at TINY, float32, erf GELU, from the same parameters
and inputs.  Tolerance: max abs error 5e-4 on normalised outputs (float32
reassociation across 8 blocks, down/up and the recovery).

The edge-kernel forward (embed_wm -> trunk -> recovery_wm) and the
token-space rollout (``make_rollout(token_space=True)``, 3 steps) are held
against the same JAX XLA path, ``forward`` and ``make_rollout(token_space=
False)``: they compute the same function.  The token-space rollout composes
recovery and embed into one matrix per token type, which reassociates
float32 sums once more per chained step; it stays within the same 5e-4 on
normalised outputs, so the looser atol 5e-3 / rtol 1e-3 in physical units
that ``tests/test_transition.py`` allows the JAX token-space rollout is not
needed.

``forward(taps=...)`` (the canonical-layout trunk) is held against the JAX
``forward(taps=...)``: every tap (canonical activations) and the output,
5e-4 abs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.data.constants import synthetic_constants as jax_constants
from pangu_tpu.engine.rollout import make_rollout as jax_make_rollout
from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.engine.rollout import make_rollout
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.models.convert import params_from_jax

TOL = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")
TINY_EDGE = dataclasses.replace(TINY, edge_kernels=True)
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_CFG, seed=3)
    consts = synthetic_constants(TINY)
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    upper = um + us * TP.normal((1, 5, TINY.levels, TINY.lat, TINY.lon), 1)
    surface = sm + ss * TP.normal((1, 4, TINY.lat, TINY.lon), 2)
    return jparams, params, consts, upper, surface


def _normalised(u, s, consts):
    t = {k: torch.as_tensor(v) for k, v in consts.items()}
    return norm_data(torch.as_tensor(TP.to_np(u)), torch.as_tensor(TP.to_np(s)), t)


def test_constants_match_jax():
    want = jax_constants(JAX_TINY)
    got = synthetic_constants(TINY)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def jax_forward(setup):
    jparams, _, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    return jax.jit(lambda p, u, s: jax_pangu.forward(p, u, s, jc, JAX_CFG))(
        jparams, jnp.asarray(upper), jnp.asarray(surface))


def test_forward_matches_jax(setup, jax_forward):
    jparams, params, consts, upper, surface = setup
    want = jax_forward
    got = pangu.forward(params, torch.as_tensor(upper), torch.as_tensor(surface),
                        consts, TINY, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


@pytest.mark.parametrize("return_trajectory", [False, True])
def test_rollout_matches_jax(setup, return_trajectory):
    jparams, params, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    want = jax_make_rollout(JAX_CFG, jc, 2, return_trajectory=return_trajectory)(
        jparams, jnp.asarray(upper), jnp.asarray(surface))
    got = make_rollout(TINY, consts, 2, return_trajectory=return_trajectory,
                       device="cpu")(params, torch.as_tensor(upper),
                                     torch.as_tensor(surface))
    pairs = [(got, want)]
    if return_trajectory:
        pairs = [(got[0], want[0])] + [((got[1][0][i], got[1][1][i]),
                                        (want[1][0][i], want[1][1][i]))
                                       for i in range(2)]
    for (gu, gs), (wu, ws) in pairs:
        assert gu.shape == wu.shape and gs.shape == ws.shape
        for g, w in zip(_normalised(gu, gs, consts), _normalised(wu, ws, consts)):
            assert TP.max_abs_err(g, w) <= TOL


def test_forward_edge_kernels_matches_jax(setup, jax_forward):
    jparams, params, consts, upper, surface = setup
    want = jax_forward
    got = pangu.forward(params, torch.as_tensor(upper), torch.as_tensor(surface),
                        consts, TINY_EDGE, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL


@pytest.fixture(scope="module")
def jax_trajectory(setup):
    """JAX's 3-step full-step rollout with its trajectory (the final state is
    its last entry)."""
    jparams, _, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    return jax_make_rollout(JAX_CFG, jc, STEPS, return_trajectory=True)(
        jparams, jnp.asarray(upper), jnp.asarray(surface))


@pytest.mark.parametrize("edge", [True, False])
@pytest.mark.parametrize("return_trajectory", [False, True])
def test_token_space_rollout_matches_jax(setup, jax_trajectory, edge,
                                         return_trajectory):
    _, params, consts, upper, surface = setup
    cfg = TINY_EDGE if edge else TINY
    got = make_rollout(cfg, consts, STEPS, return_trajectory=return_trajectory,
                       token_space=True, device="cpu")(
        params, torch.as_tensor(upper), torch.as_tensor(surface))
    want_final, (wu, ws) = jax_trajectory
    pairs = [(got[0] if return_trajectory else got, want_final)]
    if return_trajectory:
        assert got[1][0].shape == wu.shape and got[1][1].shape == ws.shape
        pairs += [((got[1][0][i], got[1][1][i]), (wu[i], ws[i]))
                  for i in range(STEPS)]
    for (gu, gs), (wu_, ws_) in pairs:
        assert gu.shape == wu_.shape and gs.shape == ws_.shape
        for g, w in zip(_normalised(gu, gs, consts),
                        _normalised(wu_, ws_, consts)):
            assert TP.max_abs_err(g, w) <= TOL


def test_token_space_rollout_plain_equals_kernel_path_on_cpu(setup):
    _, params, consts, upper, surface = setup
    a = make_rollout(TINY_EDGE, consts, 2, token_space=True, device="cpu")(
        params, torch.as_tensor(upper), torch.as_tensor(surface))
    b = make_rollout(TINY_EDGE, consts, 2, token_space=True, device="cpu",
                     kernels=False)(
        params, torch.as_tensor(upper), torch.as_tensor(surface))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_init_params_matches_jax_tree():
    """Same key paths and shapes as the JAX tree, including the bias tables
    (types, heads, 144, 144); same parameter count."""
    jparams = jax_pangu.init_params(jax.random.PRNGKey(0), JAX_TINY)
    params = pangu.init_params(torch.Generator().manual_seed(0), TINY,
                               device="cpu")
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {jax.tree_util.keystr(p): tuple(v.shape)
           for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert got == want
    assert pangu.param_count(params) == jax_pangu.param_count(jparams)
    table = params["stages"][1]["blocks"][0]["attn"]["bias_table"]
    assert table.shape == (TINY.stage(1).num_window_types, 4, 144, 144)
    assert float(table.abs().max()) <= 0.04


@pytest.mark.parametrize("entry", ["forward", "init_params", "make_rollout",
                                   "params_from_jax"])
def test_default_device_is_the_card(entry, setup, monkeypatch):
    """Entry points default to device="cuda" and raise where there is no
    card, rather than dropping quietly to the CPU."""
    jparams, params, consts, upper, surface = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "forward": lambda: pangu.forward(params, torch.as_tensor(upper),
                                         torch.as_tensor(surface), consts,
                                         TINY),
        "init_params": lambda: pangu.init_params(torch.Generator(), TINY),
        "make_rollout": lambda: make_rollout(TINY, consts, 1),
        "params_from_jax": lambda: params_from_jax(
            jax.tree.map(np.asarray, jparams)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_forward_plain_path_equals_kernel_path_on_cpu(setup):
    """On CPU tensors the wrappers run their plain versions, so
    ``kernels=False`` and the default give the same result bit for bit."""
    _, params, consts, upper, surface = setup
    a = pangu.forward(params, torch.as_tensor(upper), torch.as_tensor(surface),
                      consts, TINY, device="cpu")
    b = pangu.forward(params, torch.as_tensor(upper), torch.as_tensor(surface),
                      consts, TINY, device="cpu", kernels=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


TAPS = ["embed", "stage0", "downsample", "stage1", "stage2", "upsample",
        "stage3"]


@pytest.fixture(scope="module")
def taps_both(setup):
    """(JAX (output, taps), port (output, taps)) of one forward with taps."""
    jparams, params, consts, upper, surface = setup
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jax_fwd(p, u, s):
        taps = {}
        out = jax_pangu.forward(p, u, s, jc, JAX_CFG, taps=taps)
        return out, taps

    want = jax.jit(jax_fwd)(jparams, jnp.asarray(upper), jnp.asarray(surface))
    taps = {}
    got = pangu.forward(params, torch.as_tensor(upper),
                        torch.as_tensor(surface), consts, TINY, device="cpu",
                        taps=taps)
    return want, (got, taps)


@pytest.mark.parametrize("name", TAPS)
def test_forward_taps_match_jax(taps_both, name):
    (_, want), (_, got) = taps_both
    assert set(got) == set(want) == set(TAPS)
    assert got[name].shape == want[name].shape
    assert TP.max_abs_err(got[name], want[name]) <= TOL


def test_forward_with_taps_output_matches_jax(taps_both, jax_forward):
    (want, _), (got, _) = taps_both
    for g, w, w_plain in zip(got, want, jax_forward):
        assert g.shape == w.shape
        assert TP.max_abs_err(g, w) <= TOL
        assert TP.max_abs_err(g, w_plain) <= TOL


def test_forward_taps_plain_path_equals_kernel_path_on_cpu(setup, taps_both):
    _, params, consts, upper, surface = setup
    _, (got, taps) = taps_both
    plain_taps = {}
    plain = pangu.forward(params, torch.as_tensor(upper),
                          torch.as_tensor(surface), consts, TINY, device="cpu",
                          taps=plain_taps, kernels=False)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    for name in TAPS:
        assert torch.equal(taps[name], plain_taps[name])

"""The port's score functions against the JAX package's on the same inputs,
at (5, L, lat, lon) and (4, lat, lon): within 1e-6 relative (the two differ
in summation order only); the latitude weights to the digit (float32, the
reference's 3.1416)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangu_tpu.metrics import score as jax_score
from pangu_tpu_torch.metrics import score

RTOL = 1e-6
SHAPES = [(5, 13, 37, 48), (4, 37, 48), (2, 3, 721, 16)]


def _pair(shape, seed):
    r = np.random.default_rng(seed)
    pred = r.normal(size=shape).astype(np.float32)
    target = (0.8 * pred + 0.6 * r.normal(size=shape)).astype(np.float32)
    return pred, target


def _close(got, want, rtol=RTOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("num_lat", [721, 49, 37, 2])
def test_latitude_weights(num_lat):
    got = score.latitude_weights(num_lat)
    want = np.asarray(jax_score.latitude_weights(num_lat))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    assert got.dtype == torch.float32
    assert float(got.mean()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["weighted_rmse_channels",
                                  "weighted_acc_channels",
                                  "unweighted_acc_channels"])
def test_channel_scores_match_jax(shape, name):
    pred, target = _pair(shape, 0)
    got = getattr(score, name)(torch.from_numpy(pred), torch.from_numpy(target))
    want = getattr(jax_score, name)(jnp.asarray(pred), jnp.asarray(target))
    assert got.shape == shape[:-2]
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_masked_acc_matches_jax(shape):
    pred, target = _pair(shape, 1)
    mask = (np.random.default_rng(2).uniform(size=shape[-2:]) > 0.3
            ).astype(np.float32)
    got = score.weighted_acc_masked_channels(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    want = jax_score.weighted_acc_masked_channels(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    _close(got, want)


def test_bf16_inputs_score_in_float32():
    pred, target = _pair((4, 37, 48), 3)
    p16, t16 = (torch.from_numpy(a).bfloat16() for a in (pred, target))
    got = score.weighted_rmse_channels(p16, t16)
    want = score.weighted_rmse_channels(p16.float(), t16.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_unlog_tp_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 20)).astype(np.float32)
    _close(score.unlog_tp(torch.from_numpy(x)), jax_score.unlog_tp(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 5, 30, 40), (3, 4, 37, 48)])
def test_top_quantiles_error_matches_jax(shape):
    pred, target = _pair(shape, 5)
    got = score.top_quantiles_error(torch.from_numpy(pred),
                                    torch.from_numpy(target))
    want = jax_score.top_quantiles_error(jnp.asarray(pred), jnp.asarray(target))
    assert got.shape == shape[:2]
    # a mean of differences of quantiles: relative to the quantiles' scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RTOL * float(np.abs(target).max()) * 4)

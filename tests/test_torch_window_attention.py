"""The port's fused window attention (``window_attention_pallas``, the drop-in
for ``earth_attention`` on partitioned windows) against the JAX package's
``window_attention_pallas`` in Pallas interpret mode, at the shapes of
tests/test_ops.py (B 1, 2 longitude windows, 3 window types, N 144, C 16,
2 heads), float32:

* the forward (on CPU tensors: ``window_attention_plain``, the kernel's
  plain version) with the shifted-window mask (region ids here, the dense
  (ntype, N, N) mask built from the same ids there) and without;
* every gradient (x, the qkv and proj kernels and biases, the bias table)
  of a random cotangent: the port's ``WindowAttention`` backward (autograd
  of the reference composition through ``Sdpa``) against ``_fused_core``'s
  ``jax.vjp`` of its ``ref`` (through ``_sdpa``);
* with LoRA leaves at qkv: ``earth_attention`` itself, in both packages.

Tolerances: forward max abs error 2e-5 (float32 sums in another order on
O(1) values); gradients per leaf 2e-5 x max(1, max |leaf|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.models import layers as JL
from pangu_tpu.ops import window_attention as JW
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.ops import window_attention as W

B, NLON, NTYPE, N, C, HEADS = 1, 2, 3, 144, 16, 2
TOL = 2e-5


def _params(seed, lora=False):
    rng = np.random.default_rng(seed)

    def r(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    p = {"qkv": {"kernel": r(C, 3 * C), "bias": r(3 * C)},
         "proj": {"kernel": r(C, C), "bias": r(C)},
         "bias_table": r(NTYPE, HEADS, N, N)}
    if lora:
        p["qkv"].update(lora_a=r(C, 2, s=1.0), lora_b=r(2, 3 * C),
                        lora_scale=np.asarray(1.0, np.float32))
    return jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")


def _ids():
    """Region ids of the first NTYPE window types of a (4, 18) grid."""
    return L.window_region_ids(4, 18, (2, 6, 12))[:NTYPE]


def _jax_mask(ids):
    ids = jnp.asarray(ids)
    return jnp.where(ids[:, None, :] != ids[:, :, None], jnp.float32(-100.0),
                     jnp.float32(0.0))


@pytest.mark.parametrize("masked", [True, False])
def test_forward_matches_jax(masked):
    jp, p = _params(1)
    x = TP.normal((B, NLON, NTYPE, N, C), 2)
    ids = _ids() if masked else None
    with pltpu.force_tpu_interpret_mode():
        want = JW.window_attention_pallas(
            jp, jnp.asarray(x), HEADS, None if ids is None else _jax_mask(ids))
    got = W.window_attention_pallas(
        p, torch.as_tensor(x), HEADS,
        None if ids is None else torch.as_tensor(ids))
    assert got.shape == x.shape
    assert TP.max_abs_err(got, want) <= TOL
    plain = W.window_attention_pallas(
        p, torch.as_tensor(x), HEADS,
        None if ids is None else torch.as_tensor(ids), kernels=False)
    assert torch.equal(plain, got)


def _bad(got, want):
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        d = float(np.max(np.abs(TP.to_np(g).astype(np.float64) - w)))
        if d > TOL * max(1.0, float(np.max(np.abs(w)))):
            bad.append((i, d))
    return bad


@pytest.mark.parametrize("masked", [True, False])
def test_gradients_match_jax(masked):
    jp, p = _params(3)
    x = TP.normal((B, NLON, NTYPE, N, C), 4)
    g = TP.normal(x.shape, 5)
    ids = _ids() if masked else None
    mask = None if ids is None else _jax_mask(ids)

    def jfn(pp, xx):
        return JW.window_attention_pallas(pp, xx, HEADS, mask)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
        want_p, want_x = vjp(jnp.asarray(g))
    p = jax.tree.map(lambda t: t.clone().requires_grad_(True), p)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = W.window_attention_pallas(
        p, xt, HEADS, None if ids is None else torch.as_tensor(ids))
    y.backward(torch.as_tensor(g))
    leaves = [xt, p["qkv"]["kernel"], p["qkv"]["bias"], p["proj"]["kernel"],
              p["proj"]["bias"], p["bias_table"]]
    want = [want_x, want_p["qkv"]["kernel"], want_p["qkv"]["bias"],
            want_p["proj"]["kernel"], want_p["proj"]["bias"],
            want_p["bias_table"]]
    assert not _bad([t.grad for t in leaves], want)


def test_lora_fallback_is_earth_attention():
    jp, p = _params(6, lora=True)
    x = TP.normal((B, 1, NTYPE, N, C), 7)
    want = JW.window_attention_pallas(jp, jnp.asarray(x), HEADS, None)
    got = W.window_attention_pallas(p, torch.as_tensor(x), HEADS)
    assert TP.max_abs_err(got, want) <= TOL
    assert torch.equal(got, L.earth_attention(p, torch.as_tensor(x), HEADS))
    np.testing.assert_allclose(
        np.asarray(want), np.asarray(JL.earth_attention(jp, jnp.asarray(x),
                                                        HEADS, None)))


def test_bias_table_must_match_heads():
    _, p = _params(8)
    with pytest.raises(ValueError, match="heads"):
        W.window_attention_pallas(p, torch.zeros(B, 1, NTYPE, N, C), 4)

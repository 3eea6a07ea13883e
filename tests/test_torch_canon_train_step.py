"""A whole train step on the port's canonical training route
(``loss_and_grads``) against the JAX package, TINY, float32, erf GELU,
batch 1:

* adapters only at ``downsample.reduce``, ``upsample.expand`` and
  ``upsample.mix`` (rank 4, B non-zero) with ``lora_fused=False``: the tree
  fails ``wm_core_supported``, so every stage trains through
  ``run_stage_train_wm(io_in="canon", io_out="canon")`` (stages 1 and 2 as
  one chain) and Down/UpSample through ``L.down_sample`` / ``L.up_sample``
  with their adapters unmerged;
* without adapters, odd depths (2, 3, 3, 2) under ``block_layout="wm"``: each
  stage trains through the same canonical stage (stages 1 and 2 apart; the
  odd stages end unshifted);

loss and every gradient against ``jax.value_and_grad`` of the JAX
``forward(deterministic=False)`` with ``attn_impl="xla"`` (the same
function through the JAX package's XLA layers; ``drop_path_max=0``: the JAX
package draws its stochastic depth from ``jax.random``).  Tolerance: loss
1e-5 relative, every leaf 5e-5 x its own max |leaf| (tests/
test_torch_train.py's metric).  (The odd depths served: tests/
test_torch_forward_v2.py's ``test_v2_forward_at_odd_depths_matches_jax``.)"""

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
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.ops import earth_block_bwd as W

STEP_TOL = 5e-5
FLOOR = 1e-12


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _batch(cfg):
    consts = synthetic_constants(cfg)

    def state(seed):
        u = (consts["upper_mean"][None] + consts["upper_std"][None]
             * TP.normal((1, 5, cfg.levels, cfg.lat, cfg.lon), seed))
        s = (consts["surface_mean"][None] + consts["surface_std"][None]
             * TP.normal((1, 4, cfg.lat, cfg.lon), seed + 1))
        return u, s

    (u0, s0), (u1, s1) = state(6), state(8)
    return consts, {"upper": u0, "surface": s0, "target_upper": u1,
                    "target_surface": s1}


def _adapters_at_updown(tree):
    """LoRA factors on Down/UpSample only (rank 4, B non-zero so the
    adapters change the output)."""
    out = JLORA.init_lora(jax.random.PRNGKey(3), tree, rank=4, alpha=8.0)
    out = {**out, "stages": JLORA.strip_lora({"s": out["stages"]})["s"]}
    rng = np.random.default_rng(5)
    for site in (out["downsample"]["reduce"], out["upsample"]["expand"],
                 out["upsample"]["mix"]):
        site["lora_b"] = jnp.asarray(
            0.02 * rng.normal(size=site["lora_b"].shape), site["lora_b"].dtype)
    return out


STEP_CASES = {"adapters at Down/Up": dict(),
              "odd depths": dict(depths=(2, 3, 3, 2))}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_canon_train_step_matches_jax(case):
    change = STEP_CASES[case]
    jcfg = dataclasses.replace(JC.TINY, attn_impl="xla", drop_path_max=0.0,
                               **change)
    cfg = dataclasses.replace(PC.TINY, drop_path_max=0.0, lora_fused=False,
                              **change)
    jparams = JP.init_params(jax.random.PRNGKey(13), jcfg)
    if case == "adapters at Down/Up":
        jparams = _adapters_at_updown(jparams)
    consts, batch = _batch(cfg)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    tcfg = JC.TrainConfig()

    def jloss(p, b):
        ou, os_ = JP.forward(p, b["upper"], b["surface"], jc, jcfg,
                             deterministic=False)
        tu, ts = jax_norm_data(b["target_upper"], b["target_surface"], jc)
        return JT.weighted_l1_loss(ou, os_, tu, ts, tcfg)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    ports = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert not pangu.wm_core_supported(ports, cfg)
    ports = jax.tree.map(lambda t: t.clone().requires_grad_(True), ports)
    before = W.block_bwd_canon.launches
    loss, _, grads = T.loss_and_grads(
        ports, {k: torch.as_tensor(v) for k, v in batch.items()},
        {k: torch.as_tensor(v) for k, v in consts.items()}, cfg,
        PC.TrainConfig(), device="cpu")
    assert W.block_bwd_canon.launches == before      # CPU: plain versions
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = dict(_flat(grads))
    bad = []
    for path, w in _flat(jax.tree.map(np.asarray, want)):
        g = TP.to_np(got[path]).reshape(w.shape)
        scale = max(FLOOR, float(np.max(np.abs(w))))
        d = float(np.max(np.abs(g - w)))
        print(f"{path:45s} max|leaf| {scale:.3e} err {d:.3e} "
              f"rel {d / scale:.3e}")
        if d > STEP_TOL * scale:
            bad.append((path, d, scale))
    assert not bad, bad


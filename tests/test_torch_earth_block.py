"""The port's per-block path (``models/layers.py::earth_block``,
``models/pangu.py::run_stage_blocks``) against the JAX package at TINY,
float32, erf GELU, batch 1:

* ``earth_block`` served, unshifted and shifted, without LoRA (the port's
  CPU tensors run the plain versions of the no-roll block, the grid
  attention and the block tail) against ``L.earth_block(attn_impl=
  "pallas")`` in Pallas interpret mode and against ``attn_impl="xla"``;
* the no-roll block's plain version against ``_block_fused_pallas`` in
  interpret mode, on a lat-padded grid whose pad rows hold data;
* a block with LoRA leaves (attention sites only, MLP sites only, all four;
  B drawn non-zero) against the JAX block, served.

The training side is in tests/test_torch_per_block_train.py.  Tolerance:
5e-5 abs (float32 sums in another order; values are O(1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu import config as JC
from pangu_tpu.models import layers as JL
from pangu_tpu.models import lora as JLORA
from pangu_tpu.ops import window_attention as JW
from pangu_tpu_torch import config as PC
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.ops import window_attention as W

TOL = 5e-5


@pytest.fixture(scope="module")
def params():
    return TP.port_and_jax_params(PC.TINY, seed=9)


def _x(geom, seed):
    return TP.normal((1, geom.z, geom.h, geom.w, geom.dim), seed)


def _with_lora(jblock, sites, seed):
    """The JAX block with LoRA leaves at ``sites`` (init_lora, then B drawn
    non-zero) and its port conversion."""
    jb = JLORA.init_lora(jax.random.PRNGKey(seed), jblock, rank=4, alpha=8.0)
    for path in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                 ("mlp", "fc2")):
        site = jb[path[0]][path[1]]
        if path[1] not in sites:
            for k in JLORA.LORA_KEYS:
                site.pop(k, None)
        else:
            site["lora_b"] = 0.05 * jnp.asarray(
                TP.normal(site["lora_b"].shape, seed + len(path[1])))
    return jb, params_from_jax(jax.tree.map(np.asarray, jb), device="cpu")


@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_earth_block_matches_jax(params, roll, attn_impl):
    jparams, ports = params
    geom = PC.TINY.stage(0)
    x = _x(geom, 40)
    jb = jparams["stages"][0]["blocks"][1]
    with pltpu.force_tpu_interpret_mode():
        want = JL.earth_block(jb, jnp.asarray(x), JC.TINY.stage(0), roll,
                              attn_impl=attn_impl)
    before = dict(W.block_noroll_fused.__dict__)
    got = L.earth_block(ports["stages"][0]["blocks"][1], torch.as_tensor(x),
                        geom, roll)
    assert W.block_noroll_fused.launches == before["launches"]  # CPU: plain
    assert got.shape == x.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("stage_idx", [0, 1])
def test_block_noroll_matches_pallas(params, stage_idx):
    jparams, ports = params
    geom = PC.TINY.stage(stage_idx)
    xg = TP.normal((1, geom.z, geom.h_padded, geom.w, geom.dim), 41)
    jb = jparams["stages"][stage_idx]["blocks"][0]
    at = jb["attn"]
    with pltpu.force_tpu_interpret_mode():
        want = JW._block_fused_pallas(
            jnp.asarray(xg), at["qkv"]["kernel"], at["qkv"]["bias"],
            at["proj"]["kernel"], at["proj"]["bias"], at["bias_table"],
            jb["norm1"]["scale"], jb["norm1"]["bias"], jb["norm2"]["scale"],
            jb["norm2"]["bias"], jb["mlp"]["fc1"]["kernel"],
            jb["mlp"]["fc1"]["bias"], jb["mlp"]["fc2"]["kernel"],
            jb["mlp"]["fc2"]["bias"], geom.window, False)
    got = W.block_noroll_fused(ports["stages"][stage_idx]["blocks"][0],
                               torch.as_tensor(xg), geom, False)
    assert got.shape == xg.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("sites", [("qkv", "proj"), ("fc1", "fc2"),
                                   ("qkv", "proj", "fc1", "fc2")])
@pytest.mark.parametrize("roll", [False, True])
def test_lora_block_matches_jax(params, sites, roll):
    jparams, _ = params
    geom = PC.TINY.stage(0)
    x = _x(geom, 42)
    jb, pb = _with_lora(jparams["stages"][0]["blocks"][0], sites, 5)
    with pltpu.force_tpu_interpret_mode():
        want = JL.earth_block(jb, jnp.asarray(x), JC.TINY.stage(0), roll,
                              attn_impl="pallas")
    assert W.block_noroll_fused(pb, torch.as_tensor(x), geom, False) is None
    got = L.earth_block(pb, torch.as_tensor(x), geom, roll)
    assert TP.max_abs_err(got, want) <= TOL
    # the adapters count: the block without them differs
    plain = L.earth_block(params[1]["stages"][0]["blocks"][0],
                          torch.as_tensor(x), geom, roll)
    assert TP.max_abs_err(plain, want) > 100 * TOL

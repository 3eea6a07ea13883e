"""The port's rolled-coordinate grid block and stages (``ops/
earth_block_fused``, the ``block_layout="v2"`` trunk) against the JAX
package's: ``block_v2`` (its plain version on CPU tensors) against
``_block_v2_call`` in Pallas interpret mode at the three shifts a v2 stage
chains (unshifted, the half-window shift with region ids, its negation), with
and without stochastic-depth scales; ``run_stage_fused`` at stages 0 and 1
with depths 2 and 3 (an odd depth ends unshifted and rolls nothing back)
against the JAX ``run_stage_fused`` (the training stage is held by
tests/test_torch_train_v2.py).  TINY, float32, erf GELU, batch 1 (interpret
mode runs one program per window row; the JAX calls jitted).  Tolerance: max
abs error 5e-5 on block and stage outputs (float32 reassociation through two
LayerNorms a block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import earth_block_fused as JF
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.models.layers import window_region_ids
from pangu_tpu_torch.ops import earth_block_fused as F

TOL = 5e-5
HALF = (1, 3, 6)


@pytest.fixture(scope="module")
def params():
    return TP.port_and_jax_params(TINY, seed=8)


@pytest.mark.parametrize("stage_idx,delta,canon_add,shifted,drop", [
    (0, (0, 0, 0), 0, False, None),
    (0, HALF, 3, True, (0.8, 1.25)),
    (0, (-1, -3, -6), 0, False, None),
    (1, (0, 0, 0), 0, False, (1.25, 0.0)),
    (1, HALF, 3, True, None),
    (1, (-1, -3, -6), 0, False, (0.0, 0.8))])
def test_block_v2_matches_pallas(params, stage_idx, delta, canon_add, shifted,
                                 drop):
    jparams, ports = params
    geom = TINY.stage(stage_idx)
    x = TP.normal((1, geom.z, geom.h_padded, geom.w, geom.dim),
                  40 + stage_idx)
    ids = (window_region_ids(geom.z, geom.h_padded, geom.window)
           if shifted else None)
    d = None if drop is None else np.asarray([drop], np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda bp, xx, dd: JF._block_v2_call(
            bp, xx, JAX_TINY.stage(stage_idx), delta, canon_add,
            None if ids is None else jnp.asarray(ids), False, drop=dd))(
            jparams["stages"][stage_idx]["blocks"][1], jnp.asarray(x),
            None if d is None else jnp.asarray(d))
    before = F.block_v2.launches
    got = F.block_v2(ports["stages"][stage_idx]["blocks"][1],
                     torch.as_tensor(x), geom, delta, canon_add,
                     None if ids is None else torch.as_tensor(ids), False,
                     None if d is None else torch.as_tensor(d))
    assert F.block_v2.launches == before            # a CPU tensor: plain
    assert got.shape == x.shape
    assert TP.max_abs_err(got, want) <= TOL


@pytest.mark.parametrize("stage_idx,depth", [(0, 2), (0, 3), (1, 2), (1, 3)])
def test_run_stage_fused_matches_jax(params, stage_idx, depth):
    jparams, ports = params
    geom = TINY.stage(stage_idx)
    x = TP.normal((1, geom.z, geom.h, geom.w, geom.dim), 50 + stage_idx)
    jblocks = jparams["stages"][stage_idx]["blocks"]
    blocks = ports["stages"][stage_idx]["blocks"]
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda sp, xx: JF.run_stage_fused(
            sp, xx, JAX_TINY.stage(stage_idx)))(
            {"blocks": (jblocks * 2)[:depth]}, jnp.asarray(x))
    got = F.run_stage_fused({"blocks": (blocks * 2)[:depth]},
                            torch.as_tensor(x), geom)
    assert got.shape == x.shape and got.is_contiguous()
    assert TP.max_abs_err(got, want) <= TOL


def test_lora_blocks_are_refused(params):
    _, ports = params
    geom = TINY.stage(0)
    bp = ports["stages"][0]["blocks"][0]
    lora = {**bp, "mlp": {**bp["mlp"], "fc1": {**bp["mlp"]["fc1"],
                                               "lora_a": torch.zeros(1)}}}
    assert F.stage_supports_fused({"blocks": [bp]})
    assert not F.stage_supports_fused({"blocks": [bp, lora]})
    x = torch.zeros((1, geom.z, geom.h, geom.w, geom.dim))
    # the fused stage refuses them; models/pangu.py runs such a stage
    # block by block
    with pytest.raises(ValueError, match="LoRA"):
        F.run_stage_fused({"blocks": [lora]}, x, geom)

"""The port's block tail (``ops/block_tail.py::fused_block_tail``: on a CPU
tensor its plain version) against the JAX package's ``fused_block_tail`` in
Pallas interpret mode, TINY stage 0 and 1 shapes (cropped token grids,
batch 1; the Pallas kernel pads the tokens to 2048-row programs), float32,
both GELU forms (erf; tanh, the perf config's), random LayerNorm and bias
values so every term counts.  Tolerance: max abs error 5e-5 (float32 sums
in another order, outputs O(1))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.ops import block_tail as JBT
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.ops import block_tail as BT

TOL = 5e-5


def _block(stage_idx, seed):
    """Block params with non-trivial norms and biases, as numpy."""
    g = TINY.stage(stage_idx)
    c, hid = g.dim, TINY.mlp_ratio * g.dim
    r = np.random.default_rng(seed)

    def v(*shape, scale=0.1, base=0.0):
        return (base + scale * r.normal(size=shape)).astype(np.float32)

    return {"norm1": {"scale": v(c, base=1.0), "bias": v(c)},
            "norm2": {"scale": v(c, base=1.0), "bias": v(c)},
            "mlp": {"fc1": {"kernel": v(c, hid, scale=0.2), "bias": v(hid)},
                    "fc2": {"kernel": v(hid, c, scale=0.2), "bias": v(c)}}}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("stage_idx", [0, 1])
@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_block_tail_matches_pallas(stage_idx, gelu):
    geom = TINY.stage(stage_idx)
    p = _block(stage_idx, 60 + stage_idx)
    shape = (1, geom.z, geom.h, geom.w, geom.dim)
    a, s = TP.normal(shape, 61), TP.normal(shape, 62)
    with pltpu.force_tpu_interpret_mode():
        want = JBT.fused_block_tail(
            _tree(p, jnp.asarray), jnp.asarray(a), jnp.asarray(s),
            fast_math="tanh" if gelu == "tanh" else False)
    before = BT.fused_block_tail.launches
    got = BT.fused_block_tail(_tree(p, torch.as_tensor), torch.as_tensor(a),
                              torch.as_tensor(s), gelu == "tanh")
    assert BT.fused_block_tail.launches == before    # a CPU tensor: plain
    assert got.shape == shape
    assert TP.max_abs_err(got, want) <= TOL

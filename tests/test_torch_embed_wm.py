"""The port's ``embed_wm`` (on CPU tensors: its plain version) against the
JAX package's ``embed_wm`` in Pallas interpret mode, as ``tests/test_ops.py``
runs it: TINY, float32, batch 2, the same parameters, constants and inputs.
Tolerance: max abs error 5e-5 (float32 reassociation of a 192-term sum).
The latitude-pad token rows must be exact zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parity as TP
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.ops import embed_wm as JE
from pangu_tpu_torch.config import TINY, embed_supported
from pangu_tpu_torch.data.constants import synthetic_constants, to_device
from pangu_tpu_torch.models import layers as L
from pangu_tpu_torch.ops import embed_wm as E
from pangu_tpu_torch.ops.earth_block_wm import (from_window_major,
                                                to_window_major)

TOL = 5e-5
B = 2


@pytest.fixture(scope="module")
def setup():
    jparams, params = TP.jax_and_port_params(JAX_TINY, seed=11)
    consts = synthetic_constants(TINY)
    upper = TP.normal((B, 5, TINY.levels, TINY.lat, TINY.lon), 12)
    surface = TP.normal((B, 4, TINY.lat, TINY.lon), 13)
    got = E.embed_wm(params["patch_embed"], torch.as_tensor(upper),
                     torch.as_tensor(surface), to_device(consts, "cpu"), TINY)
    return jparams, params, consts, upper, surface, got


def test_embed_wm_matches_jax(setup):
    jparams, _, consts, upper, surface, got = setup
    assert embed_supported(TINY) and JE.embed_supported(JAX_TINY)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    with pltpu.force_tpu_interpret_mode():
        want = JE.embed_wm(jparams["patch_embed"], jnp.asarray(upper),
                           jnp.asarray(surface), jc, JAX_TINY)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert TP.max_abs_err(got, want) <= TOL


def test_embed_wm_pad_rows_are_exact_zeros(setup):
    got = setup[-1]
    grid = from_window_major(got, TINY.stage(0).window)
    assert grid.shape[2] == TINY.stage(0).h_padded > TINY.h_tokens
    assert torch.count_nonzero(grid[:, :, TINY.h_tokens:]) == 0
    assert torch.count_nonzero(grid[:, :, :TINY.h_tokens]) == grid[:, :, :TINY.h_tokens].numel()


def test_embed_wm_equals_patch_embed_then_window_major(setup):
    """In float32 the kernel's plain version is the served embed followed
    by the lat pad and the wm relayout (same sums, another order)."""
    _, params, consts, upper, surface, got = setup
    g = TINY.stage(0)
    x = L.patch_embed(params["patch_embed"], torch.as_tensor(upper),
                      torch.as_tensor(surface), to_device(consts, "cpu"), TINY)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, g.h_padded - x.shape[2]))
    assert TP.max_abs_err(got, to_window_major(x, g.window)) <= TOL


def test_embed_wm_on_cpu_runs_the_plain_version(setup):
    _, params, consts, upper, surface, got = setup
    want = E.embed_wm_plain(params["patch_embed"], torch.as_tensor(upper),
                            torch.as_tensor(surface), to_device(consts, "cpu"),
                            TINY)
    assert torch.equal(got, want)
    assert E.embed_wm.launches == 0

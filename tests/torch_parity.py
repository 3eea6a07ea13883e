"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same parameters and inputs, made from a seed, for the JAX package and its
PyTorch port, passed between them as numpy arrays."""

from __future__ import annotations

import jax
import numpy as np
import torch

from pangu_tpu.models import pangu as jax_pangu
from pangu_tpu_torch.models.convert import params_from_jax


def jax_and_port_params(jax_cfg, seed: int = 0):
    """JAX ``init_params`` -> (JAX tree, the port's tree on the CPU)."""
    params = jax_pangu.init_params(jax.random.PRNGKey(seed), jax_cfg)
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


def port_and_jax_params(port_cfg, seed: int = 0):
    """The port's ``init_params`` on the CPU -> (the JAX-shaped tree of the
    same values, the port's tree): quicker than tracing the JAX init where
    only equal parameters matter."""
    from pangu_tpu_torch.models import pangu
    params = pangu.init_params(torch.Generator().manual_seed(seed), port_cfg,
                               device="cpu")
    return jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), params), params


def normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.array(x, dtype=np.float32)


def max_abs_err(a, b) -> float:
    return float(np.max(np.abs(to_np(a) - to_np(b))))

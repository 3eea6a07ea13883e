"""Sharding rules: how parameters, batches and activations lay out over the
(dp, sp, tp) mesh; the counterpart of ``pangu_tpu/parallel/sharding.py``.

A spec says which dimension splits over which mesh axis, one entry per
dimension (None: whole on every rank), as a ``PartitionSpec`` does:

  * dp splits the batch;
  * sp splits longitude: the stage grids' longitude windows;
  * tp splits the z windows of the window-major trunk and, with them, the
    earth-specific bias tables along their z-type-major type axis (the
    layout the wm trunk's z-window sharding reads, ``models/pangu.py::
    wm_core_mesh``).  The megatron split of fc1 / fc2 / proj that
    :func:`param_spec` names serves only the JAX package's GSPMD paths,
    which the port does not have: :func:`shard_params` slices the bias
    tables alone.

The active mesh lives in a module-level context, as ``jax.set_mesh`` sets
it: ``with use_mesh(mesh): ...``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

Spec = Tuple[Optional[str], ...]

# the batch axis of the fields and of the prediction
BATCH_SPEC: Spec = ("dp",)
# a rank's share of its dp slice of the canonical (B, Z, H, W, C) token grid:
# z windows over tp, longitude windows over sp (the window-major trunk's)
TOKEN_SPEC: Spec = (None, "tp", None, "sp", None)

_ACTIVE = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``parallel.mesh.Mesh``, or None) the active mesh
    within the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _ACTIVE


def multi_device_mesh_active() -> bool:
    """True under an active mesh of more than one rank: the paths that
    serve one device only refuse to run there."""
    return _ACTIVE is not None and _ACTIVE.size > 1


def _split(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n}")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` (whole on every rank) under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _split(x, dim, mesh.shape[axis], mesh.coords[axis])
    return x


def unshard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor on every rank from each rank's slice under
    ``spec``: an all-gather along each split dimension, last first."""
    for dim in reversed(range(len(spec))):
        if spec[dim] is not None:
            x = mesh.all_gather(x, spec[dim], dim)
    return x


# ---- parameter layout ----------------------------------------------------

def param_spec(path: tuple, leaf) -> Spec:
    """The spec of one parameter leaf, by its path of dict keys and list
    indices (the JAX package's rule, leaf by leaf)."""
    names = list(path)
    if leaf.ndim == 0 or any(isinstance(n, str) and n.startswith("lora")
                             for n in names):
        return ()   # scalars + LoRA factors (tiny) stay replicated
    if "bias_table" in names:
        # (ntype, heads, N, N): the z-type-major type axis, the layout the
        # wm trunk's tp (z-window) sharding consumes directly
        return ("tp", None, None, None)
    if "mlp" in names and "fc1" in names:
        return (None, "tp") if leaf.ndim == 2 else ("tp",)
    if "mlp" in names and "fc2" in names:
        return ("tp", None) if leaf.ndim == 2 else (None,)
    if "attn" in names and "proj" in names and leaf.ndim == 2:
        # proj input rows are head-major: row-shard aligns with
        # head-parallel attention outputs
        return ("tp", None)
    return ()


def shard_params(params, mesh):
    """The param tree this rank serves with: each bias table cut to its tp
    shard of types (a copy, so the whole table can be freed: the tables are
    most of the weights), every other leaf as it is.  The tables must be
    whole."""
    if mesh is None or mesh.shape["tp"] == 1:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if "bias_table" in path:
            return shard(tree, param_spec(path, tree), mesh).clone()
        return tree

    return walk(params, ())


"""Sharding rules: how parameters, batches and activations lay out over the
(dp, sp, tp) mesh; the counterpart of ``pangu_tpu/parallel/sharding.py``.

A spec says which dimension splits over which mesh axis, one entry per
dimension (None: whole on every rank), as a ``PartitionSpec`` does:

  * dp splits the batch;
  * sp splits longitude: the stage grids' longitude windows;
  * tp splits the z windows of the window-major trunk and, with them, the
    earth-specific bias tables along their z-type-major type axis (the
    layout the wm trunk's z-window sharding reads, ``models/pangu.py::
    wm_core_mesh``).  The canonical-layout route runs under a view of the
    mesh with tp collapsed (:func:`canon_view`): its tp ranks replicate
    the work with the whole tables.  The megatron split of fc1 / fc2 / proj that
    :func:`param_spec` names serves only the JAX package's GSPMD paths,
    which the port does not have: :func:`shard_params` slices the bias
    tables alone.

The active mesh lives in a module-level context, as ``jax.set_mesh`` sets
it: ``with use_mesh(mesh): ...``.

Training: :func:`shard` (a slice) and :func:`unshard` (gathers whose
backward is this rank's slice) are differentiable, ``shard_params(...,
copy=False)`` slices the bias tables as views of the whole ones, and
:func:`reduce_grads` sums each leaf's gradient over the ranks that split
its work, so every rank holds one device's gradient of the global-batch
loss (the sum ``shard_map``'s transpose makes in the JAX package).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional, Tuple

import torch

from pangu_tpu_torch.parallel.mesh import AXES

Spec = Tuple[Optional[str], ...]

# the batch axis of the fields and of the prediction
BATCH_SPEC: Spec = ("dp",)
# a rank's share of its dp slice of the canonical (B, Z, H, W, C) token grid:
# z windows over tp, longitude windows over sp (the window-major trunk's)
TOKEN_SPEC: Spec = (None, "tp", None, "sp", None)
# the canonical-layout route's share of its dp slice of that grid: longitude
# over sp, z whole (the JAX package's TOKEN_SPEC without its dp entry)
CANON_TOKEN_SPEC: Spec = (None, None, None, "sp", None)
# a canonical grid of the whole batch on the canonical-layout route, and the
# same grid partitioned into windows (B, nlon, ntype, N, C), lon outermost:
# how a rank cuts its part of a draw made at the one-device shape
GRID_SPEC: Spec = ("dp", None, None, "sp", None)
WINDOWS_SPEC: Spec = ("dp", "sp", None, None, None)

_ACTIVE = None
_LOGGED = set()     # the collapses canon_view has logged


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


def serving_view(mesh, batch: int):
    """The mesh a served batch of ``batch`` samples runs under: ``mesh``
    where dp divides the batch, else ``mesh`` with dp collapsed
    (``Mesh.without``): each dp line serves the whole batch over its sp and
    tp shards, and the dp replicas compute the same values.  (A validation
    or test batch of 1 under a training mesh with dp > 1.)"""
    if mesh is None or batch % mesh.shape["dp"] == 0:
        return mesh
    return mesh.without("dp")


def canon_view(mesh, lon_windows, batch: int):
    """The view of ``mesh`` the canonical-layout route runs under, for a
    batch of ``batch`` samples and the stages' longitude window counts
    ``lon_windows``: tp always collapsed (its ranks replicate the work with
    the whole bias tables), sp collapsed where it does not divide every
    stage's longitude windows (a shard holds whole windows), dp collapsed
    where it does not divide the batch (:func:`serving_view`).  Each
    collapse is logged once per process: its ranks compute the same
    values."""
    view = serving_view(mesh, batch)
    if view.shape["dp"] < mesh.shape["dp"]:
        _collapsed("dp", mesh.shape["dp"],
                   f"it does not divide the batch of {batch}")
    if view.shape["tp"] > 1:
        _collapsed("tp", view.shape["tp"], "the canonical-layout route "
                   "shards no z: its tp ranks replicate the work")
        view = view.without("tp")
    if view.shape["sp"] > 1 and any(n % view.shape["sp"]
                                    for n in lon_windows):
        _collapsed("sp", view.shape["sp"], "it does not divide every "
                   f"stage's longitude windows {tuple(lon_windows)}")
        view = view.without("sp")
    return view


def _collapsed(axis: str, size: int, why: str):
    """Log, once per process and reason, that the canonical-layout route
    collapsed ``axis`` of ``size`` ranks."""
    msg = (f"canonical-layout route: {axis} {size} collapsed ({why}); its "
           f"{size} ranks compute the same values")
    if msg not in _LOGGED:
        _LOGGED.add(msg)
        logging.getLogger("pangu_tpu").warning(msg)


def global_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of the whole tensor whose slice under ``spec`` has
    ``shape`` (the inverse of :func:`shard`'s cut)."""
    return tuple(n * (1 if a is None else mesh.shape[a])
                 for n, a in zip(shape, tuple(spec) + (None,) * len(shape)))


def lon_view(mesh):
    """The view a canonical-layout layer resolves longitude halos over:
    None without one or at sp 1; raises ValueError under tp > 1 (the
    canonical route collapses tp, :func:`canon_view`)."""
    if mesh is not None and mesh.shape["tp"] > 1:
        raise ValueError("the canonical-layout route shards longitude only: "
                         "run it under a view with tp collapsed")
    return None if mesh is None or mesh.shape["sp"] == 1 else mesh


def lon_shift(xs: torch.Tensor, dw: int, mesh=None) -> torch.Tensor:
    """``torch.roll(xs, -dw, dims=3)`` of the whole grid on a tensor whose
    dimension 3 (longitude) may be this rank's sp shard: columns that
    leave the shard come from the neighbour rank, an ``|dw|``-column
    ``Mesh.ppermute`` halo (differentiable), as the JAX package's
    ``_lon_shift``.  A local roll without a mesh or at sp 1."""
    if dw == 0:
        return xs
    if mesh is None or mesh.shape["sp"] == 1:
        return torch.roll(xs, -dw, dims=3)
    if abs(dw) > xs.shape[3]:
        raise ValueError(f"lon_shift: {dw} columns on a shard of "
                         f"{xs.shape[3]}")
    if dw > 0:      # the tail comes from the next rank's head
        halo = mesh.ppermute(xs[:, :, :, :dw], "sp", 1)
        return torch.cat([xs[:, :, :, dw:], halo], dim=3)
    halo = mesh.ppermute(xs[:, :, :, dw:], "sp", -1)
    return torch.cat([halo, xs[:, :, :, :dw]], dim=3)


def grid_roll(xs: torch.Tensor, shifts, mesh=None) -> torch.Tensor:
    """``torch.roll(xs, shifts, dims=(1, 2, 3))`` of the whole (B, Z, H, W,
    ...) grid: one roll without a mesh or at sp 1; on a longitude shard, z
    and latitude locally, then a longitude halo (:func:`lon_shift`)."""
    if mesh is None or mesh.shape["sp"] == 1:
        return (torch.roll(xs, shifts=tuple(shifts), dims=(1, 2, 3))
                if any(shifts) else xs)
    if any(shifts[:2]):
        xs = torch.roll(xs, shifts=tuple(shifts[:2]), dims=(1, 2))
    return lon_shift(xs, -shifts[2], mesh)


def _split(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n}")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` (whole on every rank) under ``spec``: a
    view, differentiable."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _split(x, dim, mesh.shape[axis], mesh.coords[axis])
    return x


def unshard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor on every rank from each rank's slice under
    ``spec``: an all-gather along each split dimension, last first
    (differentiable: the backward is this rank's slice)."""
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


def shard_params(params, mesh, *, copy: bool = True):
    """The param tree this rank runs with: each bias table cut to its tp
    shard of types, every other leaf as it is.  ``copy=True`` (serving)
    takes a copy, so the whole table can be freed: the tables are most of
    the weights; ``copy=False`` (training) a view of the whole table, which
    the table's gradient reaches through.  The tables must be whole."""
    if mesh is None or mesh.shape["tp"] == 1:
        return params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if "bias_table" in path:
            t = shard(tree, param_spec(path, tree), mesh)
            return t.clone() if copy else t
        return tree

    return walk(params, ())


# ---- the gradient sum ----------------------------------------------------

def grad_axes(path: tuple) -> Tuple[str, ...]:
    """The axes whose ranks split one leaf's work, by its path, under the
    sharded training forward (``models/pangu.py``): every rank embeds its
    dp slice and keeps its (tp, sp) share of the tokens, and runs the trunk
    on that shard, so a trunk or embed leaf sums over the whole mesh; the
    patch recovery runs on the gathered tokens of the rank's dp slice, so
    it sums over dp alone (over the whole mesh it would count sp * tp
    times); a bias table is sliced over tp, so each slice sums over dp
    and sp, and the slices are then gathered over tp.  An axis the view
    collapsed has one rank: its sum is none."""
    if "patch_recovery" in path:
        return ("dp",)
    if "bias_table" in path:
        return ("dp", "sp")
    return AXES


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


def reduce_grads(params, grads, mesh):
    """Sum ``grads`` (a tree like ``params``, this rank's gradients of the
    sharded training forward; None leaves stay None) over ``mesh``, the
    view the forward ran under (``models/pangu.py::serving_mesh``: a
    collapsed axis replicated the work, and a sum over it would count the
    work once per replica), leaf by leaf by :func:`grad_axes`, in place in
    ``grads`` and in each param's ``.grad``; returns ``grads``.
    Afterwards every rank holds the same bits: one device's gradient of
    the global-batch loss.

    The leaves of one rule go as one float32 buffer, one exchange per axis:
    the trunk and embed leaves over dp, sp and tp; the recovery leaves over
    dp; this rank's tp slice of every bias table over dp and sp, then one
    gather of the slices over tp (whole tables of zeros never travel)."""
    if mesh is None or mesh.size == 1:
        return grads
    tp, pos = mesh.shape["tp"], mesh.coords["tp"]
    groups = {}
    for (path, p), (_, g) in zip(_paths(params), _paths(grads)):
        if g is not None:
            key = (grad_axes(path), "bias_table" in path and tp > 1)
            groups.setdefault(key, []).append((path, p))
    for (axes, table), group in groups.items():
        chunks, shapes = [], []
        for path, _ in group:
            g = _get(grads, path)
            part = (g.narrow(0, pos * (g.shape[0] // tp), g.shape[0] // tp)
                    if table else g)
            shapes.append((g.shape, g.dtype, part.shape))
            chunks.append(part.reshape(-1).float())
        flat = torch.cat(chunks)
        del chunks, g, part
        for path, p in group:       # the old gradients are in the buffer
            _set(grads, path, None)
            if isinstance(p, torch.Tensor):
                p.grad = None
        flat = mesh.all_reduce(flat, axes)
        if table:     # (tp, L): row r holds rank r's slices
            flat = mesh.all_gather(flat, "tp", 0).reshape(tp, -1)
        at = 0
        for (path, p), (shape, dtype, part_shape) in zip(group, shapes):
            k = part_shape.numel()
            whole = (flat[:, at:at + k].reshape(tp, *part_shape)
                     if table else flat[at:at + k]).reshape(shape)
            at += k
            g = whole.to(dtype)
            _set(grads, path, g)
            if isinstance(p, torch.Tensor) and p.requires_grad:
                p.grad = g
    return grads

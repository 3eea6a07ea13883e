"""Checkpoint and resume on ``torch.save`` / ``torch.load``: the counterpart
of ``pangu_tpu/utils/checkpoint.py``.

Layout under a result directory: ``<root>/models/<key>.pt`` (periodic,
rotated to the ``max_to_keep`` newest) and ``<root>/models/best.pt``.  Each
write goes to a temporary file in the same directory first and then
``os.replace``-s the target, so a reader never sees half a file.  Saves are
synchronous: ``wait`` and ``close`` have nothing to wait for.

A state is a parameter tree (nested dicts / lists of tensors), or a train
state with ``params``, ``opt_state`` (``{"adam": torch.optim.Adam, "count":
int}``, ``engine/train.py``) and ``step``: its Adam moments and step counts
are saved with it and restored into the template's optimizer, and the
restored values are copied into the template's parameter tensors in place,
so the optimizer keeps training them.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Any, Optional

import torch

from pangu_tpu_torch import _device


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _cpu(tree):
    return _map(tree, lambda t: t.detach().cpu()
                if isinstance(t, torch.Tensor) else t)


def _atomic_save(obj, path: str):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _is_train_state(state) -> bool:
    return all(hasattr(state, a) for a in ("params", "opt_state", "step"))


def _payload(state):
    if not _is_train_state(state):
        return {"tree": _cpu(state)}
    opt = state.opt_state
    return {"params": _cpu(state.params), "step": int(state.step),
            "adam": opt["adam"].state_dict(), "count": int(opt["count"])}


def _copy_into(template, saved):
    """Copy a saved tree into the template's tensors in place."""
    with torch.no_grad():
        for live, val in zip(_leaves(template), _leaves(saved), strict=True):
            if isinstance(live, torch.Tensor):
                live.copy_(val)
    return template


def _restore(template, payload):
    if not _is_train_state(template):
        return _copy_into(_map(template, lambda t: t.clone()
                               if isinstance(t, torch.Tensor) else t),
                          payload["tree"])
    _copy_into(template.params, payload["params"])
    template.opt_state["adam"].load_state_dict(payload["adam"])
    template.opt_state["count"] = payload["count"]
    return dataclasses.replace(template, step=payload["step"])


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


class Checkpointer:
    """Periodic and best-on-validation checkpoints of one result directory."""

    def __init__(self, root: str, max_to_keep: int = 5):
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "models")
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: int) -> str:
        return os.path.join(self.dir, f"{key}.pt")

    def all_steps(self) -> list:
        keys = (re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(self.dir))
        return sorted(int(m.group(1)) for m in keys if m)

    # -- periodic ----------------------------------------------------------
    def save(self, state: Any, epoch: int = 0, step: Optional[int] = None,
             batch: int = 0):
        """Periodic checkpoint keyed by global step (the epoch where no step
        is given).  ``batch`` = train batches already consumed in ``epoch``,
        so a resume restarts mid-epoch at the same loader position."""
        key = int(step if step is not None else epoch)
        if key in self.all_steps():
            return   # an epoch boundary coinciding with a step-interval save
        _atomic_save({"state": _payload(state),
                      "progress": {"epoch": int(epoch), "batch": int(batch)}},
                     self._path(key))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def restore_latest(self, template: Any) -> tuple[Any, Optional[int], dict]:
        """``(state, key, progress)``; progress = {"epoch", "batch"}, the
        position the next training step runs at.  No checkpoint: the
        template, None and epoch 1, batch 0."""
        keys = self.all_steps()
        if not keys:
            return template, None, {"epoch": 1, "batch": 0}
        saved = _load(self._path(keys[-1]))
        return (_restore(template, saved["state"]), keys[-1],
                {k: int(v) for k, v in saved["progress"].items()})

    # -- best-on-validation ------------------------------------------------
    @property
    def best_path(self) -> str:
        return os.path.join(self.dir, "best.pt")

    def save_best(self, state: Any):
        _atomic_save(_payload(state), self.best_path)

    def restore_best(self, template: Any) -> Any:
        return _restore(template, _load(self.best_path))

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        self.wait()


def save_params(path: str, params: Any):
    """One parameter tree (e.g. converted pretrained weights) into one file,
    as CPU tensors."""
    _atomic_save(_cpu(params), path)


def load_params(path: str, *, device: _device.DeviceLike = "cuda",
                dtype: Optional[str] = None) -> Any:
    """A tree written by :func:`save_params`, on ``device``; floating leaves
    cast to ``dtype`` ("float32" / "bfloat16") where given."""
    dev = _device.resolve(device)
    dt = None if dtype is None else _device.dtype_of(dtype)
    return _map(_load(path), lambda t: t.to(dev, dt)
                if dt is not None and t.is_floating_point() else t.to(dev))

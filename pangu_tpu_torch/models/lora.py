"""LoRA fine-tuning as a transform of the parameter tree: the counterpart of
``pangu_tpu/models/lora.py``.

LoRA factors are extra leaves on each target dense dict (``lora_a`` (in, r),
``lora_b`` (r, out), the scalar ``lora_scale`` = alpha / r, and with dropout
the scalar rate ``lora_drop`` (element mode) or ``lora_drop_feat`` (feature
mode)), with the JAX package's key names and shapes, so ``params_from_jax``
carries an adapter tree across.  ``models/layers.py::linear`` evaluates them
unmerged; ``merge_lora`` folds them into the kernels (``forward`` does so per
step under ``cfg.lora_fused`` where that is exact, so the fused trunks run);
``trainable_mask`` freezes everything but the factors and ``patch_recovery``
(``engine/train.py::make_optimizer``); ``audit`` reports what a run changed.

Targets as the reference's: every Linear layer (qkv, proj, fc1, fc2, reduce,
expand, mix), not the Conv1d patch embed and recovery; ``patch_recovery``
is trained fully.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

LINEAR_SITES: Tuple[str, ...] = ("qkv", "proj", "fc1", "fc2",
                                 "reduce", "expand", "mix")
MODULES_TO_SAVE: Tuple[str, ...] = ("patch_recovery",)
LORA_KEYS = ("lora_a", "lora_b", "lora_scale", "lora_drop",
             "lora_drop_feat")


def _is_dense(node) -> bool:
    return isinstance(node, dict) and "kernel" in node


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _copy(tree):
    """The tree's dicts and lists copied, its tensors shared."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return tree


def _dense_nodes(tree):
    """Every dense dict at a LoRA target site, in tree order."""
    def rec(node, key):
        if _is_dense(node) and key in LINEAR_SITES:
            yield node
        elif isinstance(node, dict):
            for k, v in node.items():
                yield from rec(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from rec(v, None)
    return list(rec(tree, None))


def init_lora(gen: torch.Generator, params, *, rank: int = 16,
              alpha: float = 16.0, dropout: float = 0.0,
              dropout_mode: str = "element") -> Dict:
    """A copy of ``params`` with LoRA leaves on every target dense dict: A
    uniform in +-sqrt(6 / in) (kaiming-uniform), drawn in float32 from
    ``gen`` (on its device) site by site, B zero (the model is unchanged),
    both in the kernel's dtype on its device; ``lora_scale`` = alpha / rank
    in the kernel's dtype.  ``dropout`` > 0 adds the float32 rate leaf:
    ``lora_drop`` ("element": per-token masks, no merged form) or
    ``lora_drop_feat`` ("feature": one token-constant mask per step, merged
    exactly by :func:`merge_lora`)."""
    if dropout_mode not in ("element", "feature"):
        raise ValueError(f"dropout_mode must be 'element' or 'feature', "
                         f"got {dropout_mode!r}")
    params = _copy(params)
    for site in _dense_nodes(params):
        k = site["kernel"]
        d_in, d_out = k.shape
        bound = float(np.sqrt(6.0 / d_in))
        a = torch.rand((d_in, rank), generator=gen, device=gen.device)
        site["lora_a"] = ((2 * a - 1) * bound).to(k.device, k.dtype)
        site["lora_b"] = torch.zeros((rank, d_out), dtype=k.dtype,
                                     device=k.device)
        site["lora_scale"] = torch.tensor(alpha / rank, dtype=k.dtype,
                                          device=k.device)
        if dropout > 0.0:
            key = "lora_drop" if dropout_mode == "element" else "lora_drop_feat"
            site[key] = torch.tensor(dropout, dtype=torch.float32,
                                     device=k.device)
    return params


def _has_key(tree, key: str) -> bool:
    return any(path and path[-1] == key for path, _ in _walk(tree))


def has_lora(params) -> bool:
    """True when any dense site carries LoRA factors."""
    return _has_key(params, "lora_a")


def has_lora_dropout(params, key: str = "lora_drop") -> bool:
    """True when any site stores the given dropout-rate leaf: the default
    ``"lora_drop"`` (element mode) has no merged form; ``"lora_drop_feat"``
    (feature mode) merges exactly."""
    return _has_key(params, key)


def merge_lora(params, gen: Optional[torch.Generator] = None) -> Dict:
    """A copy of ``params`` with each site's factors folded into its kernel,
    kernel + round(A @ B) * scale in the kernel's dtype, and the LoRA leaves
    dropped.  Differentiable: gradients reach A and B through the merge.
    With ``gen`` and a feature-mode rate, the step's feature mask (one
    Bernoulli draw per input feature, site by site from ``gen``) is folded
    into A exactly: drop(x) @ A == x @ (diag(m) / keep A).  Element-mode
    rates are ignored (they have no merged form: callers check
    :func:`has_lora_dropout` first)."""
    merged = _copy(params)
    for site in _dense_nodes(merged):
        if "lora_a" not in site:
            continue
        a = site["lora_a"]
        if gen is not None and "lora_drop_feat" in site:
            keep = 1.0 - site["lora_drop_feat"]
            m = torch.rand((a.shape[0], 1), generator=gen,
                           device=gen.device).to(a.device) < keep
            a = torch.where(m, a / keep.to(a.dtype),
                            torch.zeros((), dtype=a.dtype, device=a.device))
        k = site["kernel"]
        lo = (a.float() @ site["lora_b"].float()).to(k.dtype)
        site["kernel"] = k + lo * site["lora_scale"].to(k.dtype)
        for key in LORA_KEYS:
            site.pop(key, None)
    return merged


def strip_lora(params) -> Dict:
    """A copy of ``params`` without LoRA leaves (the frozen base)."""
    stripped = _copy(params)
    for path, _ in list(_walk(stripped)):
        if path[-1] in LORA_KEYS:
            node = stripped
            for k in path[:-1]:
                node = node[k]
            del node[path[-1]]
    return stripped


def trainable_mask(params) -> Any:
    """A tree of bools like ``params``: True for ``lora_a`` / ``lora_b`` and
    everything under MODULES_TO_SAVE, False (frozen) elsewhere."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, path + (i,)) for i, v in enumerate(node)]
        if any(p in MODULES_TO_SAVE for p in path if isinstance(p, str)):
            return True
        return path[-1] in ("lora_a", "lora_b")

    return rec(params, ())


def audit(before, after, atol: float = 0.0) -> Dict[str, List[str]]:
    """Updated-vs-frozen report of a fine-tuning run (the reference's
    post-training check): dotted paths of the leaves of ``after`` that
    differ from ``before`` (``np.allclose`` at ``atol``) or are new, and of
    those that do not."""
    def host(t):
        return t.detach().float().cpu().numpy()

    report = {"updated": [], "frozen": []}
    b = dict(_walk(before))
    for path, leaf in _walk(after):
        name = ".".join(str(p) for p in path)
        old = b.get(path)
        if old is None:
            report["updated"].append(name)
            continue
        same = np.allclose(host(old), host(leaf), atol=atol)
        report["frozen" if same else "updated"].append(name)
    return report

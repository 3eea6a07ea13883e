"""Four-panel maps (input, ground truth, prediction, bias) per variable: the
counterpart of ``pangu_tpu/utils/viz.py``, with its panel layout and PNG
names.  matplotlib is imported inside the plotting functions: the module
imports without it, and a plot without it raises ``ImportError``."""

from __future__ import annotations

import os
from typing import Sequence


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the evaluation figures need matplotlib, which is "
                          "not installed; pass visualize=False (--no-viz)"
                          ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _four_panel(fields, titles, fname):
    plt = _pyplot()
    fig = plt.figure(figsize=(16, 2))
    order = [3, 2, 1, 4]  # the reference's panel order: input, gt, pred, bias
    for data, title, slot in zip(fields, titles, order):
        ax = fig.add_subplot(1, 4, slot)
        im = ax.imshow(data, cmap="RdBu")
        plt.colorbar(im, ax=ax, fraction=0.05, pad=0.05)
        ax.title.set_text(title)
    plt.tight_layout()
    plt.savefig(fname=fname)
    plt.close(fig)


def plot_upper(pred, target, inp, var: str, level_idx: int, step, path: str,
               variables: Sequence[str] = ("z", "q", "t", "u", "v")):
    """pred/target/inp: numpy (vars, levels, lat, lon)."""
    v = list(variables).index(var)
    _four_panel(
        [pred[v, level_idx], target[v, level_idx], inp[v, level_idx],
         pred[v, level_idx] - target[v, level_idx]],
        ["pred", "gt", "input", "bias"],
        os.path.join(path, f"{step}_{var}_Z{level_idx}"))


def plot_surface(pred, target, inp, var: str, step, path: str,
                 variables: Sequence[str] = ("msl", "u10", "v10", "t2m")):
    """pred/target/inp: numpy (vars, lat, lon)."""
    v = list(variables).index(var)
    _four_panel(
        [pred[v], target[v], inp[v], pred[v] - target[v]],
        ["pred", "gt", "input", "bias"],
        os.path.join(path, f"{step}_{var}"))


def mkdirs(paths):
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)

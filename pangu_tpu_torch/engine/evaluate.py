"""Evaluation: per-timestamp lat-weighted RMSE / ACC and the 12 CSVs, the
counterpart of ``pangu_tpu/engine/evaluate.py``.

The forward, de-normalisation and every score run on the device; only each
batch's score table comes back to the host.  The same 12 CSVs as the JAX
package ({rmse,acc}_upper_{z,q,t,u,v}, {rmse,acc}_surface), row keys the
target timestamps, written byte for byte as its pandas writer writes them,
with the ``csv`` module.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import Config, ModelConfig
from pangu_tpu_torch.data.constants import denorm_data, to_device
from pangu_tpu_torch.metrics.score import (weighted_acc_channels,
                                           weighted_rmse_channels)
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.utils import viz
from pangu_tpu_torch.utils.logging import device_timer

UPPER_NAMES = ("z", "q", "t", "u", "v")


def score_names(upper_vars: int) -> List[str]:
    """The 12 score tables' names (fewer upper ones for fewer variables)."""
    return ([f"{e}_upper_{v}" for e in ("rmse", "acc")
             for v in UPPER_NAMES[:upper_vars]]
            + ["rmse_surface", "acc_surface"])


def score_fields(pu, ps, tu, ts, constants) -> Dict[str, torch.Tensor]:
    """Per-sample scores of predicted against target fields in physical
    units: RMSE on the fields, ACC on the anomalies (the climatological
    mean subtracted).  (B, vars, levels, lat, lon) / (B, 4, lat, lon) in,
    ``{name: (B, levels) or (B, 4)}`` float32 out."""
    um, sm = constants["upper_mean"], constants["surface_mean"]
    scores = {}
    for i, var in enumerate(UPPER_NAMES[:pu.shape[1]]):
        scores[f"rmse_upper_{var}"] = weighted_rmse_channels(pu[:, i], tu[:, i])
    scores["rmse_surface"] = weighted_rmse_channels(ps, ts)
    pu_a, tu_a = pu - um, tu - um
    ps_a, ts_a = ps - sm, ts - sm
    for i, var in enumerate(UPPER_NAMES[:pu.shape[1]]):
        scores[f"acc_upper_{var}"] = weighted_acc_channels(pu_a[:, i],
                                                           tu_a[:, i])
    scores["acc_surface"] = weighted_acc_channels(ps_a, ts_a)
    return scores


def make_score_step(cfg: ModelConfig, constants,
                    forward_fn: Callable = pangu.forward, *,
                    device: _device.DeviceLike = "cuda",
                    kernels: bool = True) -> Callable:
    """``(params, upper, surface, target_upper, target_surface) -> (scores,
    (out_upper, out_surface))`` on ``device``: the served forward
    (``forward_fn(params, upper, surface, constants, cfg, device=,
    kernels=)``), de-normalised, scored per sample by
    :func:`score_fields`.  ``kernels=False`` runs every kernel's plain
    version."""
    dev = _device.resolve(device)
    consts = to_device(constants, dev)

    @torch.no_grad()
    def score_step(params, upper, surface, target_upper, target_surface):
        out_u, out_s = forward_fn(params, upper, surface, consts, cfg,
                                  device=dev, kernels=kernels)
        out_u, out_s = denorm_data(out_u, out_s, consts)
        scores = score_fields(out_u, out_s, target_upper.to(dev),
                              target_surface.to(dev), consts)
        return scores, (out_u, out_s)

    return score_step


def _cell(v) -> str:
    # pandas' to_csv of a float32 column: the shortest repr of the float32,
    # an empty cell for NaN
    return "" if math.isnan(v) else str(np.float32(v))


def save_error_scores(csv_path: str, tables: Dict[str, Dict[str, np.ndarray]],
                      levels: Iterable[str], surface_vars: Iterable[str]):
    """Write the {rmse,acc}_* CSVs: rows the target timestamps, columns the
    pressure levels (upper) or the surface variables, the bytes of the JAX
    package's pandas writer."""
    os.makedirs(csv_path, exist_ok=True)
    levels, surface_vars = list(levels), list(surface_vars)
    for name, table in tables.items():
        cols = surface_vars if name.endswith("surface") else levels
        with open(os.path.join(csv_path, f"{name}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + cols)
            for key, row in table.items():
                row = np.asarray(row, dtype=np.float32).reshape(-1)
                if row.size != len(cols):
                    raise ValueError(f"{name}: row {key} has {row.size} "
                                     f"values for {len(cols)} columns")
                w.writerow([key] + [_cell(v) for v in row])


def _host(x) -> np.ndarray:
    return (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def evaluate(params, batches: Iterable, cfg: Config, constants, *,
             res_path: Optional[str], forward_fn: Callable = pangu.forward,
             visualize: bool = True, logger=None,
             device: _device.DeviceLike = "cuda", kernels: bool = True,
             timing: Optional[dict] = None
             ) -> Dict[str, Dict[str, np.ndarray]]:
    """The test sweep.  ``batches`` yields dicts with upper / surface /
    target_upper / target_surface (arrays or tensors) and "times": (input,
    target), each a string or one per sample.  A short last batch runs as
    it is.  Returns ``{score_name: {target_time: vector}}`` and writes the
    CSVs under ``<res_path>/csv`` and (``visualize``) the PNGs of each
    batch's first sample under ``<res_path>/png``; nothing is written
    without a ``res_path`` (the ranks of a mesh but rank 0).  ``timing``: a dict
    whose "device_s" gathers the seconds of each batch's score step
    (``device_timer``)."""
    dev = _device.resolve(device)
    score_step = make_score_step(cfg.model, constants, forward_fn,
                                 device=dev, kernels=kernels)
    names = score_names(cfg.model.upper_vars)
    tables: Dict[str, Dict[str, np.ndarray]] = {n: {} for n in names}

    visualize = visualize and res_path is not None
    png_path = os.path.join(res_path, "png") if visualize else None
    for i, batch in enumerate(batches):
        fields = [torch.as_tensor(batch[k]).to(dev) for k in
                  ("upper", "surface", "target_upper", "target_surface")]
        B = fields[1].shape[0]
        target_time = batch.get("times", (str(i), str(i)))[1]
        row_keys = ([str(t) for t in target_time]
                    if isinstance(target_time, (tuple, list))
                    else [str(target_time)])
        if len(row_keys) != B:
            raise ValueError(
                f"batch {i} carries {B} samples but {len(row_keys)} target "
                f"timestamps: refusing to make up CSV row keys (rows would "
                f"be mislabelled)")
        with device_timer(dev) as t:
            scores, (out_u, out_s) = score_step(params, *fields)
        if timing is not None:
            timing["device_s"] += t.seconds
        if logger is not None:
            logger.info(f"predict on {i} -> {row_keys[0]}")
        for name in names:
            arr = _host(scores[name])          # (B, ...) per sample
            for b, key in enumerate(row_keys):
                tables[name][key] = arr[b]

        if visualize:
            viz.mkdirs(png_path)
            viz.plot_upper(_host(out_u[0]), _host(fields[2][0]),
                           _host(fields[0][0]), var="t",
                           level_idx=min(2, cfg.model.levels - 1),
                           step=row_keys[0], path=png_path)
            viz.plot_surface(_host(out_s[0]), _host(fields[3][0]),
                             _host(fields[1][0]), var="u10",
                             step=row_keys[0], path=png_path)

    if res_path is not None:
        save_error_scores(os.path.join(res_path, "csv"), tables,
                          levels=cfg.data.levels_hpa[:cfg.model.levels],
                          surface_vars=cfg.data.surface_variables)
    return tables

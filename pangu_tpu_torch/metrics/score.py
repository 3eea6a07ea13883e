"""Latitude-weighted RMSE / ACC scoring in PyTorch, on the input's device:
the counterpart of ``pangu_tpu/metrics/score.py``.

The reference's 3.1416 (not math.pi) stays in the latitude weights, and the
latitudes are computed in float32 as the JAX package computes them, so the
weights agree with its to the digit and the scores are comparable with the
published tables (``fig/tab1.png``, ``fig/tab2.png``).
"""

from __future__ import annotations

import torch

_REF_PI = 3.1416  # the reference's constant


def _lat_deg(num_lat: int, device=None) -> torch.Tensor:
    j = torch.arange(num_lat, dtype=torch.float32, device=device)
    return 90.0 - j * 180.0 / (num_lat - 1)


def latitude_weights(num_lat: int, device=None) -> torch.Tensor:
    """w_j = num_lat * cos(lat_j) / sum(cos), float32."""
    cos = torch.cos(_REF_PI / 180.0 * _lat_deg(num_lat, device))
    return num_lat * cos / torch.sum(cos)


def _weights(x: torch.Tensor) -> torch.Tensor:
    return latitude_weights(x.shape[-2], x.device)[:, None]


def weighted_rmse_channels(pred, target):
    """Latitude-weighted RMSE over the last two axes, per leading channel:
    pred/target (..., C, lat, lon) -> (..., C)."""
    pred, target = pred.float(), target.float()
    return torch.sqrt(torch.mean(_weights(pred) * (pred - target) ** 2,
                                 dim=(-1, -2)))


def weighted_acc_channels(pred, target):
    """Latitude-weighted anomaly correlation per channel; expects *anomaly*
    inputs (the climatological mean subtracted by the caller)."""
    pred, target = pred.float(), target.float()
    w = _weights(pred)
    num = torch.sum(w * pred * target, dim=(-1, -2))
    den = torch.sqrt(torch.sum(w * pred * pred, dim=(-1, -2))
                     * torch.sum(w * target * target, dim=(-1, -2)))
    return num / den


def unweighted_acc_channels(pred, target):
    pred, target = pred.float(), target.float()
    num = torch.sum(pred * target, dim=(-1, -2))
    den = torch.sqrt(torch.sum(pred * pred, dim=(-1, -2))
                     * torch.sum(target * target, dim=(-1, -2)))
    return num / den


def unlog_tp(x, eps: float = 1e-5):
    """Inverse log-transform for total precipitation."""
    return eps * (torch.exp(x) - 1.0)


def top_quantiles_error(pred, target, qs: int = 100, qlim: int = 3,
                        qcut: float = 0.1):
    """Mean error over the top quantiles, pred/target (n, c, ...) -> (n, c).
    ``torch.quantile`` (linear interpolation, as ``jnp.quantile``) takes at
    most 2^24 elements per row: a full-width channel is 1,038,240."""
    pred, target = pred.float(), target.float()
    n, c = pred.shape[0], pred.shape[1]
    qtile = 1.0 - torch.logspace(-qlim, -qcut, steps=qs, dtype=torch.float32,
                                 device=pred.device)
    p_tar = torch.quantile(target.reshape(n, c, -1), qtile, dim=-1)
    p_pred = torch.quantile(pred.reshape(n, c, -1), qtile, dim=-1)
    # mean over the quantile axis (axis 0 of the (qs, n, c) stack)
    return torch.mean(p_pred - p_tar, dim=0)


def weighted_acc_masked_channels(pred, target, mask):
    """Masked latitude-weighted ACC: ``mask`` is a {0,1} field broadcastable
    against (..., lat, lon)."""
    pred, target, mask = pred.float(), target.float(), mask.float()
    w = _weights(pred)
    num = torch.sum(mask * w * pred * target, dim=(-1, -2))
    den = torch.sqrt(torch.sum(mask * w * pred * pred, dim=(-1, -2))
                     * torch.sum(mask * w * target * target, dim=(-1, -2)))
    return num / den

"""Logging and timing: the counterpart of ``pangu_tpu/utils/logging.py``
(``setup_logger``, ``StepTimer``, ``profile_trace`` on ``torch.profiler``,
``get_writer``), and ``device_timer``, the seconds a piece of device work
takes (CUDA events on a card)."""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Iterator, Optional

import torch


def setup_logger(name: str, log_path: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    """File + stream logger; idempotent per name."""
    log = logging.getLogger(name)
    if log.handlers:
        return log
    log.setLevel(level)
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d : %(message)s",
                            datefmt="%y-%m-%d %H:%M:%S")
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path, mode="a")
        fh.setFormatter(fmt)
        log.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    log.addHandler(sh)
    return log


class StepTimer:
    """Rolling per-step wall-clock stats for the hot loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)


class _Elapsed:
    seconds: float = 0.0


@contextlib.contextmanager
def device_timer(device: torch.device) -> Iterator[_Elapsed]:
    """``with device_timer(dev) as t: ...`` leaves in ``t.seconds`` the time
    the block's work took: CUDA events on the current stream of a CUDA
    device (synchronised at the end), the host clock elsewhere."""
    out = _Elapsed()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield out
        end.record()
        end.synchronize()
        out.seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        yield out
        out.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity), written as a Chrome trace ``trace.json`` into
    ``logdir``; a no-op when logdir is empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def get_writer(path: str):
    """TensorBoard writer (tensorboardX), or a silent stub if unavailable."""
    try:
        from tensorboardX import SummaryWriter
        os.makedirs(path, exist_ok=True)
        return SummaryWriter(path)
    except ImportError:
        class _Null:
            def add_scalars(self, *a, **k): pass
            def add_scalar(self, *a, **k): pass
            def close(self): pass
        return _Null()

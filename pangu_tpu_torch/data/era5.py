"""Host-side ERA5 data pipeline: the counterpart of ``pangu_tpu/data/era5.py``.

  * the reference's on-disk contract: monthly ``surface/surface_YYYYMM.nc``
    and daily ``upper/upper_YYYYMMDD.nc``, variables z/q/t/u/v (13 levels)
    and msl/u10/v10/t2m on the 721 x 1440 grid, ERA5T ``expver`` (expver 5
    taken where present), the level axis flipped so index 0 is 1000 hPa;
  * readers: xarray where installed, else a built-in h5py netCDF4 reader
    (CF ``scale_factor`` / ``add_offset`` packing undone by
    ``data/fastpack``); both imported inside the reader, so the module
    imports without them; synthetic fields (``SyntheticEra5Dataset``) with
    the JAX package's draws, bit for bit;
  * ``date_keys`` parses the frequencies the configs use (``"<n>h"``,
    ``"<n>D"``, ``"h"``, ``"D"``) without pandas;
  * ``Loader``: a thread pool decodes samples ahead of the consumer within a
    bounded window; batches are host numpy arrays, and its ``shard_fn``
    (``device_put_fn(device)``) moves each batch, whole, to the device in
    the consumer, on the thread that iterates.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import itertools
import os
import queue
import re
import threading
from datetime import datetime, timedelta
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import DataConfig, ModelConfig
from pangu_tpu_torch.data import fastpack

UPPER_VARS = ("z", "q", "t", "u", "v")
SURFACE_VARS = ("msl", "u10", "v10", "t2m")


# ---------------------------------------------------------------------------
# Low-level file readers
# ---------------------------------------------------------------------------

def _decode_nc_time(raw: np.ndarray, units: str) -> np.ndarray:
    """Decode CF time ('<unit> since <epoch>') to numpy datetime64[s]."""
    unit, _, epoch = units.partition(" since ")
    epoch = epoch.strip().split(".")[0]
    base = np.datetime64(epoch.replace(" ", "T"), "s")
    scale = {"seconds": 1, "minutes": 60, "hours": 3600,
             "days": 86400}[unit.strip()]
    return base + (raw.astype("int64") * scale).astype("timedelta64[s]")


def _read_h5_var(ds, time_idx: int, expver_idx: Optional[int]) -> np.ndarray:
    """Read one timestep of a variable, undoing CF int16 packing."""
    if expver_idx is not None and ds.ndim >= 3:
        raw = ds[time_idx, expver_idx]
    else:
        raw = ds[time_idx]
    raw = np.asarray(raw)
    attrs = ds.attrs
    fill = attrs.get("_FillValue", attrs.get("missing_value"))
    fill = None if fill is None else int(np.asarray(fill).item())
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    scale = 1.0 if scale is None else float(np.asarray(scale).item())
    offset = 0.0 if offset is None else float(np.asarray(offset).item())

    if raw.dtype == np.int16:
        return fastpack.unpack_i16(raw, scale, offset, fill)
    data = raw.astype(np.float32)
    if fill is not None:
        data = np.where(raw == fill, np.nan, data)
    return (data * np.float32(scale) + np.float32(offset)).astype(np.float32)


def read_netcdf_fields(path: str, variables: Sequence[str],
                       when: datetime) -> Dict[str, np.ndarray]:
    """Read ``variables`` at timestamp ``when`` from a netCDF file: through
    xarray where installed, else h5py.  ERA5T files carry an ``expver``
    axis: expver 5 is taken where present."""
    try:
        import xarray as xr
    except ImportError:
        xr = None
    if xr is not None:
        ds = xr.open_dataset(path)
        try:
            sel = (ds.sel(time=when, expver=5) if "expver" in ds
                   else ds.sel(time=when))
            return {v: sel[v].values.astype(np.float32) for v in variables}
        finally:
            ds.close()

    import h5py
    with h5py.File(path, "r") as f:
        tname = "time" if "time" in f else "valid_time"
        units = f[tname].attrs["units"]
        times = _decode_nc_time(np.asarray(f[tname]),
                                units.decode() if isinstance(units, bytes)
                                else units)
        idx = np.where(times == np.datetime64(when, "s"))[0]
        if idx.size == 0:
            raise KeyError(f"{when} not found in {path}")
        ti = int(idx[0])
        expver_idx = None
        if "expver" in f:
            hit = np.where(np.asarray(f["expver"]) == 5)[0]
            expver_idx = int(hit[0]) if hit.size else 0
        return {v: _read_h5_var(f[v], ti, expver_idx) for v in variables}


def stack_state(upper_fields: Dict[str, np.ndarray],
                surface_fields: Dict[str, np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-variable fields into the canonical arrays
    (5, levels, lat, lon) / (4, lat, lon), the level axis flipped so index
    0 == 1000 hPa."""
    upper = fastpack.stack_flip([upper_fields[v] for v in UPPER_VARS])
    surface = np.stack([surface_fields[v] for v in SURFACE_VARS])
    return upper.astype(np.float32), surface.astype(np.float32)


# ---------------------------------------------------------------------------
# Dataset over a date range
# ---------------------------------------------------------------------------

_FREQ = re.compile(r"(\d*)([hD])")


def date_keys(start: str, end: str, freq: str) -> List[datetime]:
    """Init-time keys over [start, end] (both ends included where on the
    grid) every ``freq``: ``"<n>h"``, ``"<n>D"``, ``"h"`` or ``"D"``, the
    forms the configs use; start and end as ``YYYYMMDD`` or ISO 8601."""
    m = _FREQ.fullmatch(freq)
    if m is None or m.group(1) == "0":
        raise ValueError(f"unsupported frequency {freq!r}: use '<n>h', "
                         "'<n>D', 'h' or 'D'")
    n = int(m.group(1) or 1)
    step = timedelta(hours=n) if m.group(2) == "h" else timedelta(days=n)
    t, stop = datetime.fromisoformat(start), datetime.fromisoformat(end)
    keys = []
    while t <= stop:
        keys.append(t)
        t += step
    return keys


@dataclasses.dataclass
class Era5Sample:
    upper: np.ndarray
    surface: np.ndarray
    target_upper: np.ndarray
    target_surface: np.ndarray
    times: Tuple[str, str]       # (input 'YYYYMMDDHH', target 'YYYYMMDDHH')

    def as_batch(self) -> Dict[str, np.ndarray]:
        return {
            "upper": self.upper[None], "surface": self.surface[None],
            "target_upper": self.target_upper[None],
            "target_surface": self.target_surface[None],
            "times": self.times,
        }


class Era5Dataset:
    """Map-style dataset of (state_t, state_{t+horizon}) pairs."""

    def __init__(self, dcfg: DataConfig, split: str = "train",
                 mcfg: Optional[ModelConfig] = None):
        self.dcfg = dcfg
        start, end, freq = {
            "train": (dcfg.train_start, dcfg.train_end, dcfg.train_freq),
            "val": (dcfg.val_start, dcfg.val_end, dcfg.val_freq),
            "test": (dcfg.test_start, dcfg.test_end, dcfg.test_freq),
        }[split]
        self.keys = date_keys(start, end, freq)
        self.horizon = dcfg.horizon
        # keep headroom so key + horizon stays inside the range
        step_h = max(1, int((self.keys[1] - self.keys[0]).total_seconds()
                            // 3600)) if len(self.keys) > 1 else 1
        drop = -(-self.horizon // step_h)
        self.length = max(len(self.keys) - drop, 0)

    def __len__(self) -> int:
        return self.length

    def _state_at(self, when: datetime) -> Tuple[np.ndarray, np.ndarray]:
        root = self.dcfg.nc_path
        sfc_path = os.path.join(root, "surface", f"surface_{when:%Y%m}.nc")
        up_path = os.path.join(root, "upper", f"upper_{when:%Y%m%d}.nc")
        surface = read_netcdf_fields(sfc_path, SURFACE_VARS, when)
        upper = read_netcdf_fields(up_path, UPPER_VARS, when)
        return stack_state(upper, surface)

    def __getitem__(self, index: int) -> Era5Sample:
        t0 = self.keys[index]
        t1 = t0 + timedelta(hours=self.horizon)
        upper, surface = self._state_at(t0)
        tgt_upper, tgt_surface = self._state_at(t1)
        return Era5Sample(upper, surface, tgt_upper, tgt_surface,
                          (f"{t0:%Y%m%d%H}", f"{t1:%Y%m%d%H}"))


class SyntheticEra5Dataset(Era5Dataset):
    """Deterministic synthetic fields keyed by timestamp (the JAX package's
    draws, bit for bit)."""

    def __init__(self, dcfg: DataConfig, split: str = "train",
                 mcfg: Optional[ModelConfig] = None):
        super().__init__(dcfg, split)
        self.mcfg = mcfg or ModelConfig()

    def _state_at(self, when: datetime):
        m = self.mcfg
        seed = int(when.timestamp()) % (2 ** 31)
        r = np.random.default_rng(seed)
        upper = r.normal(size=(m.upper_vars, m.levels, m.lat, m.lon)
                         ).astype(np.float32)
        surface = r.normal(size=(m.surface_vars, m.lat, m.lon)
                           ).astype(np.float32)
        return upper, surface


def make_dataset(dcfg: DataConfig, split: str,
                 mcfg: Optional[ModelConfig] = None,
                 synthetic: Optional[bool] = None) -> Era5Dataset:
    """Synthetic where asked, or (``synthetic=None``) where ``nc_path`` holds
    no ``surface/`` directory."""
    if synthetic is None:
        synthetic = not os.path.isdir(os.path.join(dcfg.nc_path, "surface"))
    cls = SyntheticEra5Dataset if synthetic else Era5Dataset
    return cls(dcfg, split, mcfg=mcfg)


# ---------------------------------------------------------------------------
# Threaded loading
# ---------------------------------------------------------------------------

def batch_samples(samples: Sequence[Era5Sample]) -> Dict[str, np.ndarray]:
    return {
        "upper": np.stack([s.upper for s in samples]),
        "surface": np.stack([s.surface for s in samples]),
        "target_upper": np.stack([s.target_upper for s in samples]),
        "target_surface": np.stack([s.target_surface for s in samples]),
        "times": tuple(zip(*[s.times for s in samples])),
    }


class Loader:
    """Threaded loader: a worker pool decodes samples, a producer thread
    assembles batches, at most ``prefetch`` of them wait for the consumer.

    ``shard_fn(host_batch) -> batch`` (e.g. :func:`device_put_fn`) runs in
    the consumer, on the thread that iterates :meth:`epoch`, so device
    copies are made where the device work is issued.
    ``process_index`` / ``process_count`` shard the sample indices.
    """

    def __init__(self, dataset: Era5Dataset, batch_size: int, *,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 4, prefetch: int = 2,
                 shard_fn=None,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.shard_fn = shard_fn
        self.process_index = process_index
        self.process_count = process_count

    def _indices(self, epoch: int) -> List[int]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return list(idx[self.process_index::self.process_count])

    def __len__(self) -> int:
        n = len(self._indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices(epoch)
        if self.drop_last:
            indices = indices[:len(indices) - len(indices) % self.batch_size]
        if not indices:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def q_put(item) -> bool:
            # a put that re-checks stop: when the consumer abandons the
            # epoch early (--limit), a plain put() would block forever and
            # leak this thread and its pool
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pool = cf.ThreadPoolExecutor(self.num_workers)
            try:
                # a bounded in-flight window: the pool width plus the
                # queue's worth of batches (a full-size sample pair is
                # ~0.5 GB, so submitting every index up front would hold
                # O(dataset) host memory while the consumer is slow)
                window = self.num_workers + self.prefetch * self.batch_size
                index_iter = iter(indices)
                pending = collections.deque(
                    pool.submit(self.dataset.__getitem__, i)
                    for i in itertools.islice(index_iter, window))
                group = []
                while pending:
                    if stop.is_set():
                        return
                    result = pending.popleft().result()
                    nxt = next(index_iter, None)
                    if nxt is not None:
                        pending.append(
                            pool.submit(self.dataset.__getitem__, nxt))
                    group.append(result)
                    if len(group) == self.batch_size:
                        if not q_put(batch_samples(group)):
                            return
                        group = []
                if group and not self.drop_last:
                    q_put(batch_samples(group))
            except BaseException as e:  # raised again in the consumer
                q_put(e)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
                q_put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item if self.shard_fn is None else self.shard_fn(item)
        finally:
            stop.set()


def device_put_fn(device: _device.DeviceLike = "cuda"):
    """A ``shard_fn`` that moves a batch's arrays to ``device`` as float32
    tensors (other entries, such as "times", pass as they are).  Under a
    mesh every rank holds the whole batch this way: the served forward
    takes its dp slice itself and hands every rank the whole prediction,
    as a JAX global array is seen whole."""
    dev = _device.resolve(device)

    def put(batch):
        return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                    else v)
                for k, v in batch.items()}
    return put


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute_statistics(loader: Loader, epoch: int = 0):
    """Offline per-variable mean/std over a loader, averaging per-batch
    spatial moments (the reference's computeStatistics tool), as float32
    arrays in the canonical broadcast-ready shapes."""
    sums = None
    n = 0
    for batch in loader.epoch(epoch):
        u, s = _host(batch["upper"]), _host(batch["surface"])
        cur = {
            "upper_mean": u.mean(axis=(0, -1, -2)),
            "upper_std": u.std(axis=(0, -1, -2)),
            "surface_mean": s.mean(axis=(0, -1, -2)),
            "surface_std": s.std(axis=(0, -1, -2)),
        }
        sums = cur if sums is None else {k: sums[k] + cur[k] for k in sums}
        n += 1
    if not n:
        raise ValueError("empty loader")
    return {k: (v / n).astype(np.float32)[..., None, None]
            for k, v in sums.items()}

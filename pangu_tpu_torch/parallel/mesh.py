"""The process group and the (dp, sp, tp) mesh of ``torch.distributed``
ranks: the counterpart of ``pangu_tpu/parallel/mesh.py``.

Axis conventions, as in the JAX package:
  dp - batch data parallelism;
  sp - longitude: the stage grids' longitude windows split over sp;
  tp - the z windows of the window-major trunk, and with them the
       z-type-major earth-specific bias tables.

A rank's mesh coordinates follow ``jax.make_mesh``'s device order: rank
``r = (dp_i * sp + sp_i) * tp + tp_i``, tp fastest.  Ranks at or past the
mesh size stay idle (``build_mesh`` returns None there), as ``jax.make_mesh``
takes the first n devices.

The backend is chosen by rule (:func:`backend_for`), never on an error:
``nccl`` where every rank of the machine has a card of its own, ``gloo`` on
the CPU or where ranks share a card (the only way one card holds a world).
Under gloo the two collectives move CUDA tensors through host buffers, on
every call.  Every exchange is counted with its bytes (``Mesh.exchanges``,
``Mesh.exchange_bytes``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import MeshConfig

AXES = ("dp", "sp", "tp")
TIMEOUT_S = 600.0     # a collective that waits longer fails the rank


def _should_initialize(environ=None) -> bool:
    """True when the environment describes a multi-process launch: a world
    of more than one rank with a rendezvous address (torchrun) or a
    multi-task SLURM allocation."""
    env = os.environ if environ is None else environ
    try:
        if int(env.get("WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in env:
            return True
        return int(env.get("SLURM_NTASKS", "1")) > 1
    except ValueError:
        return False


def backend_for(device: _device.DeviceLike, local_world: int) -> str:
    """``gloo`` on the CPU or where the ``local_world`` ranks of this
    machine outnumber its cards (ranks share a card: NCCL refuses two ranks
    on one device), else ``nccl``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(*, device: _device.DeviceLike = "cuda") -> bool:
    """Join the process group where the environment describes a
    multi-process launch (idempotent); True where a group is up.  torchrun
    sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR``
    / ``MASTER_PORT`` (and its agent's store, which ``env://`` joins); under
    SLURM the rank and world come from ``SLURM_PROCID`` / ``SLURM_NTASKS``,
    and ``MASTER_ADDR`` / ``MASTER_PORT`` must be set."""
    if dist.is_initialized():
        return True
    env = os.environ
    if not _should_initialize(env):
        return False
    world = int(env.get("WORLD_SIZE", env.get("SLURM_NTASKS", "1")))
    local_world = int(env.get("LOCAL_WORLD_SIZE",
                              env.get("SLURM_NTASKS_PER_NODE", str(world))))
    if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
        raise RuntimeError("a multi-process launch needs MASTER_ADDR and "
                           "MASTER_PORT")
    dist.init_process_group(
        backend=backend_for(device, local_world), init_method="env://",
        rank=int(env.get("RANK", env.get("SLURM_PROCID", "0"))),
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def world() -> tuple:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: _device.DeviceLike = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    "cuda", the CPU for "cpu"."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    _device.resolve("cuda")          # raises where there is no card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """x's storage as a flat uint8 tensor: every backend moves bytes."""
    return x.contiguous().reshape(-1).view(torch.uint8)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, sp, tp) mesh: the sizes, its
    coordinates, the global ranks of its line along each axis (ordered by
    coordinate), one process group per line with more than one rank, its
    device and whether the collectives stage through host buffers."""

    cfg: MeshConfig
    coords: Dict[str, int]
    lines: Dict[str, List[int]]
    groups: Dict[str, object]
    device: torch.device
    host_staged: bool
    exchanges: int = 0
    exchange_bytes: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self.cfg, a) for a in AXES}

    @property
    def size(self) -> int:
        return self.cfg.size

    def reset_counts(self) -> None:
        self.exchanges = self.exchange_bytes = 0

    def _count(self, t: torch.Tensor) -> None:
        self.exchanges += 1
        self.exchange_bytes += t.numel() * t.element_size()

    def ppermute(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """The neighbour rotate of ``lax.ppermute`` along ``axis``: returns
        the ``x`` of the rank ``step`` places further along the line
        (cyclic), and hands this rank's ``x`` to the rank ``step`` places
        back.  Every rank of the line must call it together."""
        n = self.shape[axis]
        if n == 1:
            return x
        pos, line = self.coords[axis], self.lines[axis]
        src = _as_bytes(x)
        if self.host_staged:
            src = src.cpu()
        buf = torch.empty_like(src)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, line[(pos - step) % n],
                       self.groups[axis]),
            dist.P2POp(dist.irecv, buf, line[(pos + step) % n],
                       self.groups[axis])])
        for r in reqs:
            r.wait()
        self._count(src)
        return buf.to(x.device).view(x.dtype).reshape(x.shape)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The line's ``x`` (equal shapes) concatenated along ``dim`` in
        coordinate order.  Every rank of the line must call it together."""
        n = self.shape[axis]
        if n == 1:
            return x
        src = _as_bytes(x)
        if self.host_staged:
            src = src.cpu()
        bufs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(bufs, src, group=self.groups[axis])
        self._count(src)
        parts = [b.to(x.device).view(x.dtype).reshape(x.shape) for b in bufs]
        return torch.cat(parts, dim=dim)


def _coords(rank: int, cfg: MeshConfig) -> Dict[str, int]:
    return {"dp": rank // (cfg.sp * cfg.tp), "sp": rank // cfg.tp % cfg.sp,
            "tp": rank % cfg.tp}


def _rank(c: Dict[str, int], cfg: MeshConfig) -> int:
    return (c["dp"] * cfg.sp + c["sp"]) * cfg.tp + c["tp"]


def build_mesh(cfg: MeshConfig, *, device: _device.DeviceLike = "cuda"
               ) -> Optional[Mesh]:
    """This rank's :class:`Mesh` of ``cfg`` over the process group (or over
    this process alone for a mesh of size 1 without a group).  Every rank
    of the world must call it: the groups are made in the same order
    everywhere.  Ranks past ``cfg.size`` get None (idle), with a warning."""
    rank, n_world = world()
    if cfg.size > n_world:
        raise ValueError(f"mesh {cfg} needs {cfg.size} ranks, the world has "
                         f"{n_world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)      # "cuda" now means this rank's card
    groups: Dict[str, object] = {}
    lines: Dict[str, List[int]] = {}
    mine = _coords(rank, cfg) if rank < cfg.size else None
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        n = getattr(cfg, axis)
        seen = set()
        for r in range(cfg.size):       # one line per fixing of the others
            c = _coords(r, cfg)
            key = tuple(c[a] for a in others)
            if key in seen:
                continue
            seen.add(key)
            line = [_rank({**c, axis: i}, cfg) for i in range(n)]
            group = dist.new_group(line) if n > 1 else None
            if mine is not None and tuple(mine[a] for a in others) == key:
                lines[axis], groups[axis] = line, group
    if mine is None:
        logging.getLogger("pangu_tpu").warning(
            "build_mesh: rank %d is idle: the mesh %s takes ranks 0-%d of "
            "%d", rank, cfg, cfg.size - 1, n_world)
        return None
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(cfg=cfg, coords=mine, lines=lines, groups=groups, device=dev,
                host_staged=dev.type == "cuda" and backend == "gloo")


def auto_mesh_config(n_devices: int, *, lon_windows: int = 30,
                     max_heads: int = 6, batch: int = 0) -> MeshConfig:
    """Choose (dp, sp, tp) with dp | batch, sp | lon_windows (half-res
    longitude window count) and tp | max_heads (smallest head count).

    Searches all exact factorisations, preferring (in order) total devices
    used, then sp (longitude sharding cuts the dominant activation memory),
    then dp, then tp.  May return a mesh smaller than n_devices when no
    exact factorisation satisfies the divisibility constraints (e.g. batch
    1 on 8 ranks); callers that require the full world should pick a batch
    size that factors."""
    batch = batch or 1
    best = None
    for dp in range(1, n_devices + 1):
        if batch % dp:
            continue
        for sp in range(1, n_devices // dp + 1):
            if dp * sp > n_devices or lon_windows % sp:
                continue
            for tp in range(1, n_devices // (dp * sp) + 1):
                size = dp * sp * tp
                if size > n_devices or max_heads % tp:
                    continue
                key = (size, sp, dp, tp)
                if best is None or key > best[0]:
                    best = (key, MeshConfig(dp=dp, sp=sp, tp=tp))
    assert best is not None
    if best[1].size < n_devices:
        logging.getLogger("pangu_tpu").warning(
            "auto_mesh_config: no (dp,sp,tp) factorisation uses all "
            "%d devices (batch=%d, lon_windows=%d, heads=%d); using %s "
            "= %d devices — %d idle. Pick a batch size that factors.",
            n_devices, batch, lon_windows, max_heads, best[1], best[1].size,
            n_devices - best[1].size)
    return best[1]

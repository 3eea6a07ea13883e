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
Under gloo the collectives move CUDA tensors through host buffers, on every
call.  Where every rank of the world runs on this machine, a gloo mesh
moves the data through shared memory (:class:`HostSlots`: a slot per rank
in ``/dev/shm``, gloo carrying only the barriers) instead of gloo's TCP
streams.  Every exchange is counted with its bytes (``Mesh.exchanges``,
``Mesh.exchange_bytes``, and per collective ``Mesh.by_op``).

``Mesh.ppermute`` and ``Mesh.all_gather`` are differentiable: the backward
of a rotate is the opposite rotate, and that of a gather this rank's slice
of the cotangent (every rank computes the same loss from the gathered
tensor, so the copies' cotangents are one cotangent, not n to be summed).
``Mesh.all_reduce`` sums over the lines of one or more axes (the gradient
sum of ``parallel/sharding.py::reduce_grads``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import mmap
import os
import secrets
from typing import Dict, List, Optional, Sequence

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


SHM_DIR = "/dev/shm"
# the exchanges of this process by line of ranks, shared by its meshes
_SLOTS: Dict[tuple, "HostSlots"] = {}


def _map(fd: int, size: int) -> torch.Tensor:
    """The file ``fd``'s first ``size`` bytes as a uint8 tensor, mapped
    shared with its pages populated in one call (not a fault a page)."""
    mem = mmap.mmap(fd, size, flags=mmap.MAP_SHARED
                    | getattr(mmap, "MAP_POPULATE", 0),
                    prot=mmap.PROT_READ | mmap.PROT_WRITE)
    return torch.frombuffer(mem, dtype=torch.uint8)


class HostSlots:
    """The shared-memory exchange of one line of ranks on this machine: one
    slot per rank, a file in ``SHM_DIR`` that its owner writes and the
    others read, mapped by every rank of the line (its pages populated at
    once) and unlinked once all have mapped it (nothing is left behind).
    A call writes this rank's bytes into its slot, waits on a barrier of
    the line's group, reads the slots it needs, and :meth:`release` waits
    on a second barrier before any slot is written again.  The slots grow
    to the largest call; the ranks of a line pass equal sizes, so they
    grow together.  The meshes a process builds share one per line
    (:func:`build_mesh`), so a slot grows once."""

    def __init__(self, group, line: Sequence[int], pos: int, token: str):
        self.group, self.pos = group, pos
        self.stem = os.path.join(
            SHM_DIR, f"pangu_mesh_{token}_{'-'.join(map(str, line))}")
        self.n, self.cap, self.gen = len(line), 0, 0
        self.slots: List[torch.Tensor] = []

    def _grow(self, nbytes: int) -> None:
        self.gen += 1
        cap = -(-nbytes // (1 << 20)) << 20
        names = [f"{self.stem}_{self.gen}_{i}" for i in range(self.n)]
        fd = os.open(names[self.pos], os.O_RDWR | os.O_CREAT | os.O_EXCL,
                     0o600)
        try:
            os.ftruncate(fd, cap)
            slots = [None] * self.n
            slots[self.pos] = _map(fd, cap)         # the pages, allocated
            dist.barrier(group=self.group)          # every slot exists
            for i, name in enumerate(names):
                if i != self.pos:
                    other = os.open(name, os.O_RDWR)
                    try:
                        slots[i] = _map(other, cap)
                    finally:
                        os.close(other)
            dist.barrier(group=self.group)          # every slot is mapped
        finally:
            os.close(fd)
            os.unlink(names[self.pos])
        self.slots, self.cap = slots, cap

    def exchange(self, src: torch.Tensor, reads: Sequence[int]
                 ) -> List[torch.Tensor]:
        """Write ``src`` (flat uint8, any device) into this rank's slot;
        return the slots of the line positions ``reads`` (host views, good
        until :meth:`release`)."""
        n = src.numel()
        if n > self.cap:
            self._grow(n)
        self.slots[self.pos][:n].copy_(src)
        dist.barrier(group=self.group)
        return [self.slots[i][:n] for i in reads]

    def release(self) -> None:
        """Wait until every rank of the line has read its slots."""
        dist.barrier(group=self.group)


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
    # per collective ("ppermute", "all_gather", "all_reduce"): [n, bytes];
    # one dict for a mesh and the views made from it (``without``)
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    # per axis of more than one rank, where the world is on this machine
    # under gloo: its line's shared-memory exchange
    slots: Dict[str, HostSlots] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: getattr(self.cfg, a) for a in AXES}

    @property
    def size(self) -> int:
        return self.cfg.size

    @property
    def exchanges(self) -> int:
        return sum(n for n, _ in self.by_op.values())

    @property
    def exchange_bytes(self) -> int:
        return sum(b for _, b in self.by_op.values())

    def without(self, axis: str) -> "Mesh":
        """This mesh with ``axis`` collapsed to this rank's own place: the
        ranks along it become replicas that compute the same values (the
        other axes keep their lines and groups; the view's exchanges count
        in this mesh's counts)."""
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, **{axis: 1}),
            coords={**self.coords, axis: 0},
            lines={**self.lines, axis: [self.lines[axis][self.coords[axis]]]},
            groups={**self.groups, axis: None},
            slots={a: v for a, v in self.slots.items() if a != axis})

    def reset_counts(self) -> None:
        self.by_op.clear()

    def _count(self, t: torch.Tensor, op: str) -> None:
        n = t.numel() * t.element_size()
        rec = self.by_op.setdefault(op, [0, 0])
        rec[0] += 1
        rec[1] += n

    def _ppermute(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        n = self.shape[axis]
        pos, line = self.coords[axis], self.lines[axis]
        src = _as_bytes(x)
        if axis in self.slots:
            out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            slots = self.slots[axis]
            _as_bytes(out).copy_(slots.exchange(src, [(pos + step) % n])[0])
            slots.release()
            self._count(src, "ppermute")
            return out
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
        self._count(src, "ppermute")
        return buf.to(x.device).view(x.dtype).reshape(x.shape)

    def ppermute(self, x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """The neighbour rotate of ``lax.ppermute`` along ``axis``: returns
        the ``x`` of the rank ``step`` places further along the line
        (cyclic), and hands this rank's ``x`` to the rank ``step`` places
        back.  Every rank of the line must call it together, in the
        backward too (the opposite rotate)."""
        if self.shape[axis] == 1:
            return x
        return _PPermute.apply(x, self, axis, step)

    def _all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        src = _as_bytes(x)
        if axis in self.slots:
            slots = self.slots[axis]
            views = slots.exchange(src, range(self.shape[axis]))
            out = torch.cat([v.to(x.device).view(x.dtype).reshape(x.shape)
                             for v in views], dim=dim)
            slots.release()
            self._count(src, "all_gather")
            return out
        if self.host_staged:
            src = src.cpu()
        bufs = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(bufs, src, group=self.groups[axis])
        self._count(src, "all_gather")
        # joined where they arrived (the host, when staged): one copy onto
        # the device, and no second set of parts there
        parts = [b.view(x.dtype).reshape(x.shape) for b in bufs]
        return torch.cat(parts, dim=dim).to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The line's ``x`` (equal shapes) concatenated along ``dim`` in
        coordinate order.  Every rank of the line must call it together.
        Its backward is this rank's slice of the cotangent, with no
        exchange."""
        if self.shape[axis] == 1:
            return x
        return _AllGather.apply(x, self, axis, dim)

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` (equal shapes; float32 or float64, which every
        backend sums) over the lines of ``axes``, one exchange per axis of
        more than one rank, in ``AXES`` order: every rank of the plane
        those lines span gets the same bits.  Not differentiable; a new
        tensor (``x`` itself where no axis has more than one rank)."""
        axes = [a for a in AXES if a in axes and self.shape[a] > 1]
        if not axes:
            return x
        buf = x.detach().contiguous()
        if all(a in self.slots for a in axes):
            for a in axes:      # every rank adds the line's parts in order
                slots = self.slots[a]
                views = slots.exchange(_as_bytes(buf),
                                       range(self.shape[a]))
                parts = (v.to(x.device).view(x.dtype).reshape(x.shape)
                         for v in views)
                buf = next(parts).clone()
                for part in parts:
                    buf += part
                slots.release()
                self._count(buf, "all_reduce")
            return buf
        buf = buf.cpu() if self.host_staged else buf.clone()
        for a in axes:
            dist.all_reduce(buf, group=self.groups[a])
            self._count(buf, "all_reduce")
        return buf.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return mesh._ppermute(x, axis, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._ppermute(g, ctx.axis, -ctx.step), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.pos, ctx.k = dim, mesh.coords[axis], x.shape[dim]
        return mesh._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.pos * ctx.k, ctx.k), None, None, None


def _coords(rank: int, cfg: MeshConfig) -> Dict[str, int]:
    return {"dp": rank // (cfg.sp * cfg.tp), "sp": rank // cfg.tp % cfg.sp,
            "tp": rank % cfg.tp}


def _rank(c: Dict[str, int], cfg: MeshConfig) -> int:
    return (c["dp"] * cfg.sp + c["sp"]) * cfg.tp + c["tp"]


def _shm_token(n_world: int) -> Optional[str]:
    """A name the world's ranks share for their :class:`HostSlots`, where
    gloo carries a world whose ranks all run on this machine
    (``LOCAL_WORLD_SIZE``, as torchrun and ``parallel/launch.py`` set it)
    and ``SHM_DIR`` is writable; else None.  Every rank must call it."""
    if (n_world < 2 or dist.get_backend() != "gloo"
            or os.environ.get("LOCAL_WORLD_SIZE") != str(n_world)
            or not os.access(SHM_DIR, os.W_OK)):
        return None
    token = [secrets.token_hex(8) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(token, src=0)
    return token[0]


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
    token = _shm_token(n_world)
    if mine is None:
        logging.getLogger("pangu_tpu").warning(
            "build_mesh: rank %d is idle: the mesh %s takes ranks 0-%d of "
            "%d", rank, cfg, cfg.size - 1, n_world)
        return None
    backend = dist.get_backend() if dist.is_initialized() else None
    slots = {}
    for a in AXES:
        if token is not None and groups[a] is not None:
            key = tuple(lines[a])
            if key not in _SLOTS:
                _SLOTS[key] = HostSlots(groups[a], lines[a], mine[a], token)
            slots[a] = _SLOTS[key]
    return Mesh(cfg=cfg, coords=mine, lines=lines, groups=groups, device=dev,
                host_staged=dev.type == "cuda" and backend == "gloo",
                slots=slots)


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

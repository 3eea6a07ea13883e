"""Start a world of N ``torch.distributed`` ranks on this machine and run one
function on every rank: for the card's smoke script and the CPU tests, where
``torchrun`` is not at hand.

Each rank is a process of the ``spawn`` start method (which re-imports the
function's module: it must be importable without side effects; the function
and its arguments reach the ranks through a ``torch.save`` file) with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as
torchrun sets them and ``GLOO_SOCKET_IFNAME=lo``.  The ranks meet through a
``file://`` rendezvous in a temporary directory, on the backend
``mesh.backend_for`` chooses (gloo for CPU ranks or ranks that share a
card), with a finite timeout.  The parent joins with a deadline: a rank that
raises, dies or outlives it ends the whole world, and ``run`` raises.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pangu_tpu_torch import _device
from pangu_tpu_torch.parallel.mesh import backend_for


def _rank_main(rank: int, world: int, tmp: str, device: str,
               timeout_s: float) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "GLOO_SOCKET_IFNAME": "lo"})
    torch.set_num_threads(1)        # the ranks share this machine's cores
    out = os.path.join(tmp, f"rank{rank}")
    try:
        dist.init_process_group(
            backend=backend_for(device, world),
            init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        fn, args = torch.load(os.path.join(tmp, "call.pt"),
                              weights_only=False)
        result = fn(*args)
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: Callable, world: int, *args, device: str = "cuda",
        timeout_s: float = 60.0) -> List:
    """``fn(*args)`` on each of ``world`` ranks; returns their results in
    rank order (each saved with ``torch.save`` and loaded here).  Raises
    RuntimeError, after ending every rank, where one raises, dies or the
    world outlives ``timeout_s`` seconds (which also bounds each
    collective).  ``device`` ("cuda", the default, or "cpu") picks the
    backend (``mesh.backend_for``); "cuda" without a card raises before a
    rank starts."""
    if torch.device(device).type == "cuda":
        _device.resolve(device)         # raises where there is no card
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pangu_world_") as tmp:
        # the call goes through a file, not the process arguments: those
        # would move the tensors' storage into shared memory under the
        # caller, freeing memory that other views of it may still read
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, device, timeout_s),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                codes = [p.exitcode for p in procs]
                if any(codes):      # a rank failed: the others may wait on it
                    failed = f"exit codes {codes}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the world outlived its {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        codes = [p.exitcode for p in procs]
        if failed is None and any(codes):
            failed = f"exit codes {codes}"
        if failed is not None:
            errs = [open(os.path.join(tmp, f)).read()
                    for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
            raise RuntimeError(f"world of {world}: {failed}\n"
                               + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]

"""The shared-memory exchange of a gloo world on one machine
(``parallel/mesh.py::HostSlots``), in a 4-rank world on the CPU
(``parallel/launch.py``), mesh (1, 2, 2): ``Mesh.ppermute``,
``Mesh.all_gather`` and ``Mesh.all_reduce`` through the slots give the
bits that gloo alone gives, for lengths that make the slots grow; the
all-reduce is the same on every rank; and no slot file is left in
``/dev/shm``."""

import glob
import os

import pytest
import torch

import torch_world
from pangu_tpu_torch.parallel import launch
from pangu_tpu_torch.parallel import mesh as M

SIZES = (5, 3000, 1 << 20)      # the last needs 4 MiB: the slots grow


@pytest.fixture(scope="module")
def ranks():
    before = set(glob.glob(os.path.join(M.SHM_DIR, "pangu_mesh_*")))
    out = launch.run(torch_world.host_slots, 4, SIZES, device="cpu",
                     timeout_s=120)
    return out, before


def test_a_local_gloo_world_exchanges_through_shared_memory(ranks):
    out, _ = ranks
    assert [r["slots"] for r in out] == [["sp", "tp"]] * 4


@pytest.mark.parametrize("n", SIZES)
def test_shared_memory_gives_gloo_s_bits(ranks, n):
    out, _ = ranks
    for r in out:
        shm, gloo = r[("shm", n)], r[("gloo", n)]
        assert len(shm) == len(gloo) == 9
        for a, b in zip(shm, gloo):
            assert a.shape == b.shape and torch.equal(a, b)
    # the sums, rank r = 2 sp + tp: over sp the same on ranks of one tp
    # coordinate, over tp on ranks of one sp coordinate, over both on all
    for i, line in ((6, lambda r: r % 2), (7, lambda r: r // 2),
                    (8, lambda r: 0)):
        for r in range(4):
            first = min(q for q in range(4) if line(q) == line(r))
            assert torch.equal(out[r][("shm", n)][i],
                               out[first][("shm", n)][i])


def test_no_slot_file_is_left_behind(ranks):
    _, before = ranks
    assert set(glob.glob(os.path.join(M.SHM_DIR, "pangu_mesh_*"))) <= before

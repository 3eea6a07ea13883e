"""The port's command lines in a 4-rank gloo world on the CPU
(``parallel/launch.py``), at TINY, float32, with ``--device cpu --tiny
--synthetic``: ``cli.inference --token-space --horizon 48``, the 24 + 6 h
token-space hierarchy ``cli.inference --models 24=,6= --horizon 30
--token-space`` (the canonical route's shards) and ``cli.evaluate
--no-viz``, each rank on its shard of the mesh the command line sets up
itself (``auto_mesh_config`` over 4 ranks: (dp, sp, tp) =
(1, 2, 2)).  Rank 0 alone writes the 12 CSVs and the log; each value equals
the single-device run's within 1e-5 relative."""

import csv
import os

import numpy as np
import pytest

import torch_world
from pangu_tpu_torch.cli import evaluate, inference
from pangu_tpu_torch.parallel import launch

TOL = 1e-5
WINDOW = {"data.test_start": "20150106", "data.test_end": "20150109",
          "data.num_workers": "1"}
# type_net -> (command line, arguments)
RUNS = {"inference": ("inference", ["--horizon", "48", "--token-space",
                                    "--limit", "1"]),
        "hierarchy": ("inference", ["--models", "24=,6=", "--horizon", "30",
                                    "--token-space", "--limit", "1"]),
        "evaluate": ("evaluate", ["--no-viz", "--limit", "1"])}


def _args(out, name, extra):
    sets = [a for k, v in {**WINDOW, "output_path": str(out)}.items()
            for a in ("--set", f"{k}={v}")]
    return ["--device", "cpu", "--tiny", "--synthetic", "--type_net", name,
            *sets, *extra]


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {r[0]: np.array(r[1:], dtype=np.float64) for r in rows[1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one = tmp_path_factory.mktemp("one")
    world = tmp_path_factory.mktemp("world")
    for name, (module, extra) in RUNS.items():
        cli = {"inference": inference, "evaluate": evaluate}[module]
        assert cli.main(_args(one, name, extra)) == 0
    codes = launch.run(torch_world.cli_main, 4,
                       [(module, _args(world, name, extra))
                        for name, (module, extra) in RUNS.items()],
                       device="cpu", timeout_s=60)
    assert codes == [[0] * len(RUNS)] * 4
    return one, world


@pytest.mark.parametrize("name,horizon", [("inference", "48"),
                                          ("hierarchy", "30"),
                                          ("evaluate", "24")])
def test_sharded_command_line_writes_the_single_device_csvs(runs, name,
                                                            horizon):
    one, world = runs
    want_dir = one / name / horizon / "csv"
    got_dir = world / name / horizon / "csv"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    assert len(os.listdir(got_dir)) == 12
    for table in os.listdir(want_dir):
        want, got = _read(want_dir / table), _read(got_dir / table)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=0, err_msg=table)
    log = (world / name / horizon / f"{name}.log").read_text()
    assert "MeshConfig(dp=1, sp=2, tp=2)" in log
    assert sorted(os.listdir(world / name / horizon)) == sorted(
        os.listdir(one / name / horizon))

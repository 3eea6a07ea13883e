"""The port's two training command lines, ``cli.finetune --smoke`` and
``cli.lora_tune --smoke`` (feature-mode dropout, and its default
element-mode dropout, which trains on the canonical route's shards with
each rank's part of the one-device masks), in a 4-rank gloo world on
the CPU (``parallel/launch.py``) at TINY, float32, ``--device cpu --tiny
--synthetic``: the mesh the command line picks for batch 2 over 4 ranks is
(dp, sp, tp) = (2, 2, 1) (validation and test batches of 1 run with dp
collapsed).  Each rank is given its own output directory: every rank
returns 0, and only rank 0's directory exists, holding the checkpoints,
the best params, the 12 test CSVs, the log and, for LoRA, the adapter and
the merged snapshot."""

import os

import pytest

import torch_world
from pangu_tpu_torch.parallel import launch

WINDOW = {"data.test_start": "20150106", "data.test_end": "20150107",
          "data.num_workers": "1", "train.save_steps": "1"}
RUNS = [("finetune", "finetune_fully", {}),
        ("lora_tune", "lora", {"train.lora_dropout_mode": "feature",
                               "train.lora_rank": "4"}),
        ("lora_tune", "lora_element", {"train.lora_rank": "4"})]


def _args(out, name, sets):
    pairs = [a for k, v in {**WINDOW, **sets, "output_path": str(out)}.items()
             for a in ("--set", f"{k}={v}")]
    return ["--device", "cpu", "--tiny", "--synthetic", "--smoke",
            "--type_net", name, *pairs]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    codes = launch.run(torch_world.cli_main, 4,
                       [(m, _args(root / "rank{rank}", name, sets))
                        for m, name, sets in RUNS], device="cpu",
                       timeout_s=120)
    return root, codes


@pytest.mark.parametrize("name,extra", [
    ("finetune_fully", set()), ("lora", {"lora_adapter", "merged"}),
    ("lora_element", {"lora_adapter", "merged"})])
def test_training_command_line_in_a_world_writes_on_rank_0_only(world, name,
                                                                 extra):
    root, codes = world
    assert codes == [[0] * len(RUNS)] * 4
    assert sorted(os.listdir(root)) == ["rank0"]
    run = root / "rank0" / name / "24"
    assert len(os.listdir(run / "test" / "csv")) == 12
    assert set(os.listdir(run / "models")) == (
        {f"{k}.pt" for k in (1, 2, 3, 4)} | {"best.pt"} | extra)
    log = (run / f"{name}.log").read_text()
    assert "MeshConfig(dp=2, sp=2, tp=1)" in log
    assert "Epoch 2 :" in log and "done; best val loss" in log
    if name.startswith("lora"):
        mode = "element" if name == "lora_element" else "feature"
        assert f"mode={mode}" in log

"""The port's last four command lines on the CPU at TINY, float32
(``--device cpu --tiny --synthetic``):

* ``cli.finetune --smoke`` and ``cli.lora_tune --smoke`` (feature-mode
  dropout) on one device: checkpoints, the best params, the 12 test CSVs,
  the LoRA adapter, the merged snapshot and the updated-vs-frozen audit;
* a resumed fine-tuning run picks up at the (epoch, batch) its latest
  checkpoint recorded and ends on the uninterrupted run's params, bit for
  bit;
* ``cli.profile_step`` prints its statistics and, with ``--trace``, writes
  a Chrome ``trace.json``;
* ``cli.parity_check`` passes its structural checks without weights;
  with a frame and a golden ``.npz`` the test writes (the port's own
  output saved as the golden) it reports each variable and passes; a
  corrupted golden fails, and so does a CSV far from the score anchors.

The two training command lines in a world of ranks are
``tests/test_torch_train_cli_world.py``'s."""

import json
import os

import numpy as np
import pytest
import torch

import torch_world
from pangu_tpu_torch.cli import (finetune, lora_tune, parity_check,
                                 profile_step)
from pangu_tpu_torch.config import TINY
from pangu_tpu_torch.data.constants import denorm_data, synthetic_constants
from pangu_tpu_torch.models import pangu
from pangu_tpu_torch.utils.checkpoint import save_params

WINDOW = {"data.test_start": "20150106", "data.test_end": "20150107",
          "data.num_workers": "1", "train.save_steps": "1"}
LORA = {"train.lora_dropout_mode": "feature", "train.lora_rank": "4"}


def _args(out, name, sets):
    pairs = [a for k, v in {**WINDOW, **sets, "output_path": str(out)}.items()
             for a in ("--set", f"{k}={v}")]
    return ["--device", "cpu", "--tiny", "--synthetic", "--smoke",
            "--type_net", name, *pairs]


RUNS = [("finetune", "finetune_fully", {}), ("lora_tune", "lora", LORA)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one = tmp_path_factory.mktemp("one")
    assert finetune.main(_args(one, "finetune_fully", {})) == 0
    assert lora_tune.main(_args(one, "lora", LORA)) == 0
    # resume: keep the uninterrupted run's last checkpoint, drop every
    # checkpoint after the first step, and run again
    models = one / "finetune_fully" / "24" / "models"
    full = torch.load(models / "4.pt", weights_only=True)
    for k in (2, 3, 4):
        os.unlink(models / f"{k}.pt")
    assert finetune.main(_args(one, "finetune_fully", {})) == 0
    resumed = torch.load(models / "4.pt", weights_only=True)
    return {"one": one, "full": full, "resumed": resumed}


def test_fine_tuning_runs_on_one_device(runs):
    run = runs["one"] / "finetune_fully" / "24"
    assert len(os.listdir(run / "test" / "csv")) == 12
    assert {"1.pt", "4.pt", "best.pt"} <= set(os.listdir(run / "models"))
    log = (run / "finetune_fully.log").read_text()
    assert "Epoch 2 :" in log and "Begin testing" in log


def test_lora_tuning_runs_on_one_device(runs):
    run = runs["one"] / "lora" / "24"
    assert len(os.listdir(run / "test" / "csv")) == 12
    assert {"lora_adapter", "merged", "best.pt"} <= set(
        os.listdir(run / "models"))
    adapter = torch.load(run / "models" / "lora_adapter", weights_only=True)
    merged = torch.load(run / "models" / "merged", weights_only=True)
    site = adapter["stages"][0]["blocks"][0]["attn"]["qkv"]
    assert {"lora_a", "lora_b"} <= set(site)
    assert "lora_a" not in merged["stages"][0]["blocks"][0]["attn"]["qkv"]
    log = (run / "lora.log").read_text()
    assert "mode=feature" in log and "| updated" in log
    updated, frozen = (int(log.split(f"{k}=")[1].split()[0])
                       for k in ("updated", "frozen"))
    assert updated > 0 and frozen > 0


def test_a_resumed_run_picks_up_where_it_stopped(runs):
    log = (runs["one"] / "finetune_fully" / "24"
           / "finetune_fully.log").read_text()
    assert "resumed from checkpoint at step 1 (epoch 1, batch 1)" in log
    assert "resuming epoch 1 at batch 1" in log
    full, resumed = runs["full"], runs["resumed"]
    assert full["progress"] == resumed["progress"]
    flat = lambda t: [v for v in torch_world.T._leaves(t)]  # noqa: E731
    for a, b in zip(flat(full["state"]["params"]),
                    flat(resumed["state"]["params"])):
        assert torch.equal(a, b)


def test_profile_step_prints_statistics_and_a_trace(tmp_path, capsys):
    assert profile_step.main(["--device", "cpu", "--tiny", "--steps", "2",
                              "--train", "--trace", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "train step: mean" in out and "total" in out
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def _frame(tmp_path):
    c = synthetic_constants(TINY)
    rng = np.random.default_rng(0)
    upper = (c["upper_mean"] + c["upper_std"] * rng.normal(
        size=(5, TINY.levels, TINY.lat, TINY.lon))).astype(np.float32)
    surface = (c["surface_mean"] + c["surface_std"] * rng.normal(
        size=(4, TINY.lat, TINY.lon))).astype(np.float32)
    np.savez(tmp_path / "frame.npz", upper=upper, surface=surface)
    return upper, surface, c


def test_parity_check(tmp_path, capsys):
    assert parity_check.main(["--device", "cpu", "--tiny"]) == 0
    assert "PARITY: PASS" in capsys.readouterr().out
    # weights, a frame and the port's own output as the golden
    params = pangu.init_params(torch.Generator().manual_seed(5), TINY,
                               device="cpu")
    save_params(str(tmp_path / "w.pt"), params)
    upper, surface, c = _frame(tmp_path)
    consts = {k: torch.as_tensor(v) for k, v in c.items()}
    with torch.no_grad():
        ou, os_ = pangu.forward(params, torch.as_tensor(upper)[None],
                                torch.as_tensor(surface)[None], consts, TINY,
                                device="cpu")
        ou, os_ = denorm_data(ou, os_, consts)
    np.savez(tmp_path / "golden.npz", out_upper=ou[0].numpy(),
             out_surface=os_[0].numpy())
    argv = ["--device", "cpu", "--tiny", "--pretrained",
            str(tmp_path / "w.pt"), "--frame", str(tmp_path / "frame.npz")]
    assert parity_check.main(argv + ["--golden",
                                     str(tmp_path / "golden.npz")]) == 0
    out = capsys.readouterr().out
    assert "[golden] upper variable 4:" in out
    assert "[golden] surface variable 3:" in out and "PARITY: PASS" in out
    np.savez(tmp_path / "bad.npz", out_upper=1.1 * ou[0].numpy(),
             out_surface=os_[0].numpy())
    assert parity_check.main(argv + ["--golden",
                                     str(tmp_path / "bad.npz")]) == 1
    assert "FAIL: upper" in capsys.readouterr().out
    # the score anchors on an evaluation sweep's CSVs
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    for var, col, val in (("z", "500", 45.0), ("t", "850", 0.9)):
        (csv_dir / f"rmse_upper_{var}.csv").write_text(
            f",{col}\n2018010400,{val}\n2018010412,{val}\n")
    assert parity_check.main(["--device", "cpu", "--tiny", "--csv_dir",
                              str(csv_dir)]) == 1
    out = capsys.readouterr().out
    assert "z500_rmse: 45.000 vs 45.001" in out and "OK" in out
    assert "t850_rmse: 0.900 vs 0.717" in out and "FAIL" in out

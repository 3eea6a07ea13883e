"""The port's command lines, in process, with ``--device cpu --tiny
--synthetic`` and a short test window:

* ``evaluate --limit 1 --no-viz`` writes the 12 CSVs;
* ``convert_weights`` of a .pth made from JAX-layout params
  (``export_torch_state_dict`` of the JAX package), then ``evaluate
  --pretrained`` on the result: the CSV numbers match the JAX package's
  ``make_score_step`` on the same batch and weights (the JAX model at
  ``attn_impl="xla"``; RMSE 5e-4 relative, ACC 5e-4 absolute);
* ``inference --horizon 48``, full-step and ``--token-space`` (the same
  function: their CSVs agree within 1e-3 relative), and a ``--models
  24=,6=`` hierarchy over 30 h;
* refusals: a horizon that is not a multiple of 24, a mesh of 2 ranks in
  a process that is no world of 2, ``--device cuda`` without a card."""

import csv
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.data import era5 as jax_era5
from pangu_tpu.data.constants import synthetic_constants as jax_constants
from pangu_tpu.engine import evaluate as jax_evaluate
from pangu_tpu.models import convert as jax_convert
from pangu_tpu_torch.cli import convert_weights, evaluate, inference
from pangu_tpu_torch.config import TINY

TOL = 5e-4
WINDOW = {"data.test_start": "20150106", "data.test_end": "20150109",
          "data.num_workers": "2"}


def _args(tmp_path, name, *extra, window=WINDOW):
    sets = [a for k, v in {**window, "output_path": str(tmp_path)}.items()
            for a in ("--set", f"{k}={v}")]
    return ["--device", "cpu", "--tiny", "--synthetic", "--type_net", name,
            *sets, *extra]


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], {r[0]: np.array(r[1:], dtype=np.float64) for r in rows[1:]}


def test_evaluate_writes_12_csvs(tmp_path):
    assert evaluate.main(_args(tmp_path, "ev", "--limit", "1", "--no-viz")) == 0
    out = tmp_path / "ev" / "24" / "csv"
    assert len(os.listdir(out)) == 12
    header, rows = _read(out / "acc_surface.csv")
    assert header == ["", "msl", "u10", "v10", "t2m"]
    assert list(rows) == ["2015010700"]
    header, rows = _read(out / "rmse_upper_t.csv")
    assert header == ["", "1000", "925", "850", "700", "600"]
    assert (tmp_path / "ev" / "24" / "ev.log").exists()


def test_convert_then_evaluate_matches_jax(tmp_path):
    jparams, _ = TP.port_and_jax_params(TINY, seed=4)
    sd = {k: torch.from_numpy(np.copy(v)) for k, v in
          jax_convert.export_torch_state_dict(
              {k: _np(v) for k, v in jparams.items()}, JAX_TINY).items()}
    pth, out = str(tmp_path / "ref.pth"), str(tmp_path / "w.pt")
    torch.save({"model": sd}, pth)
    assert convert_weights.main(["--tiny", "--device", "cpu", "--input", pth,
                                 "--output", out]) == 0
    assert evaluate.main(_args(tmp_path, "ev2", "--limit", "1", "--no-viz",
                               "--pretrained", out)) == 0

    dcfg = JaxDataConfig(**{k.split(".")[1]: v for k, v in WINDOW.items()
                            if k != "data.num_workers"})
    batch = jax_era5.SyntheticEra5Dataset(dcfg, "test", JAX_TINY)[0].as_batch()
    jcfg = dataclasses.replace(JAX_TINY, attn_impl="xla")
    consts = {k: jnp.asarray(v) for k, v in jax_constants(jcfg).items()}
    want, _ = jax_evaluate.make_score_step(jcfg, consts)(
        jparams, *(jnp.asarray(batch[k]) for k in
                   ("upper", "surface", "target_upper", "target_surface")))
    csv_dir = tmp_path / "ev2" / "24" / "csv"
    for name in want:
        _, rows = _read(csv_dir / f"{name}.csv")
        assert list(rows) == [batch["times"][1]]
        got, w = rows[batch["times"][1]], np.asarray(want[name])[0]
        if name.startswith("rmse"):
            np.testing.assert_allclose(got, w, rtol=TOL, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=0, atol=TOL, err_msg=name)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def test_inference_full_step_and_token_space(tmp_path):
    for name, extra in (("full", ()), ("tok", ("--token-space",))):
        assert inference.main(_args(tmp_path, name, "--horizon", "48",
                                    "--limit", "2", *extra)) == 0
    for table in ("rmse_upper_z", "acc_upper_t", "rmse_surface"):
        _, full = _read(tmp_path / "full" / "48" / "csv" / f"{table}.csv")
        _, tok = _read(tmp_path / "tok" / "48" / "csv" / f"{table}.csv")
        assert list(full) == list(tok) == ["2015010800", "2015010812"]
        for key in full:
            assert np.isfinite(full[key]).all()
            np.testing.assert_allclose(tok[key], full[key], rtol=1e-3,
                                       atol=1e-3, err_msg=table)


def test_inference_hierarchy(tmp_path):
    assert inference.main(_args(tmp_path, "hier", "--horizon", "30",
                                "--models", "24=,6=", "--limit", "1")) == 0
    _, rows = _read(tmp_path / "hier" / "30" / "csv" / "rmse_surface.csv")
    assert list(rows) == ["2015010706"]           # 00 h + 30 h
    assert np.isfinite(rows["2015010706"]).all()


def test_inference_rejects_bad_horizon(tmp_path):
    with pytest.raises(SystemExit):
        inference.main(_args(tmp_path, "bad", "--horizon", "36"))


@pytest.mark.parametrize("cli", [evaluate, inference])
def test_mesh_raises(tmp_path, cli):
    """A mesh of 2 ranks in a process that is no world of 2 raises (the
    sharded command lines themselves: tests/test_torch_parallel_cli.py)."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        cli.main(_args(tmp_path, "mesh", "--set", "mesh.dp=2"))


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = _args(tmp_path, "nocard", "--limit", "1", "--no-viz")
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_weights.main(["--tiny", "--input", "x.pth", "--output", "y"])


# ---------------------------------------------------------------------------
# the ONNX Runtime baseline, through a fake onnxruntime module
# ---------------------------------------------------------------------------

class _FakeTensor:
    def __init__(self, name):
        self.name = name


class _FakeSession:
    """u' = 2u, s' = s + 1: shows how often the loop fed the state back."""

    def __init__(self, path, sess_options=None, providers=None):
        self.path, self.sess_options, self.providers = path, sess_options, providers

    def get_inputs(self):
        return [_FakeTensor("input"), _FakeTensor("input_surface")]

    def get_outputs(self):
        return [_FakeTensor("output"), _FakeTensor("output_surface")]

    def run(self, out_names, feeds):
        assert out_names == ["output", "output_surface"]
        u, s = feeds["input"], feeds["input_surface"]
        assert u.dtype == np.float32 and s.dtype == np.float32 and u.ndim == 4
        return [u * 2.0, s + 1.0]


@pytest.fixture
def fake_ort(monkeypatch):
    import sys
    import types
    mod = types.ModuleType("onnxruntime")
    mod.SessionOptions = type("SessionOptions", (), {})
    mod.InferenceSession = _FakeSession
    monkeypatch.setitem(sys.modules, "onnxruntime", mod)
    return mod


def test_onnx_baseline_gated_without_onnxruntime(monkeypatch):
    import sys
    from pangu_tpu_torch.engine import onnx_baseline as OB
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    with pytest.raises(SystemExit, match="onnxruntime"):
        OB.make_session("whatever.onnx")


def test_onnx_baseline_session_and_rollout(fake_ort):
    from pangu_tpu_torch.engine import onnx_baseline as OB
    sess = OB.make_session("model.onnx", providers=["CUDAExecutionProvider"])
    o = sess.sess_options
    assert (o.enable_cpu_mem_arena, o.enable_mem_pattern, o.enable_mem_reuse,
            o.intra_op_num_threads) == (False, False, False, 16)
    assert sess.providers == ["CUDAExecutionProvider"]
    assert OB._io_names(sess) == ("input", "input_surface", "output",
                                  "output_surface")
    u, s = OB.rollout(sess, np.ones((5, 3, 8, 16), np.float32),
                      np.zeros((4, 8, 16), np.float32), steps=3)
    np.testing.assert_array_equal(u, np.full((5, 3, 8, 16), 8.0))
    np.testing.assert_array_equal(s, np.full((4, 8, 16), 3.0))


def test_inference_onnx_baseline(tmp_path, fake_ort):
    """--onnx-baseline: the fake engine's 2 steps (u x 4, s + 2) scored into
    the same CSVs, one row per sample of a batch of 2."""
    assert inference.main(_args(tmp_path, "ort", "--horizon", "48",
                                "--limit", "1", "--onnx-baseline", "m.onnx",
                                "--set", "train.eval_batch_size=2")) == 0
    _, rows = _read(tmp_path / "ort" / "48" / "csv" / "rmse_surface.csv")
    assert list(rows) == ["2015010800", "2015010812"]
    assert all(np.isfinite(v).all() for v in rows.values())


# ---------------------------------------------------------------------------
# logging utilities
# ---------------------------------------------------------------------------

def test_logging_utilities(tmp_path):
    from pangu_tpu_torch.utils import logging as U
    log = U.setup_logger("torch_cli_test", str(tmp_path / "a" / "x.log"))
    assert U.setup_logger("torch_cli_test") is log
    log.info("hello")
    assert "hello" in (tmp_path / "a" / "x.log").read_text()
    timer = U.StepTimer(window=2)
    for _ in range(3):
        timer.start()
        timer.stop()
    assert len(timer.times) == 2 and timer.mean_ms >= 0
    with U.device_timer(torch.device("cpu")) as t:
        torch.ones(8).sum()
    assert t.seconds > 0
    with U.profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with U.profile_trace(None):
        pass
    w = U.get_writer(str(tmp_path / "tb"))
    w.add_scalar("loss", 1.0, 0)
    w.close()


def test_get_writer_stub_without_tensorboardx(tmp_path, monkeypatch):
    import sys
    from pangu_tpu_torch.utils import logging as U
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    w = U.get_writer(str(tmp_path / "tb"))
    w.add_scalars("Loss", {"train": 1.0}, 0)
    w.close()
    assert not (tmp_path / "tb").exists()

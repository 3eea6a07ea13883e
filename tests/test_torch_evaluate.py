"""The port's evaluation against the JAX package's at TINY, float32:

* ``make_score_step`` from the same weights and inputs
  at batch 2, the JAX model at ``attn_impl="xla"``: RMSE within 5e-4
  relative, ACC within 5e-4 absolute (the forward's tolerance, ``PERF.md``
  section 2);
* ``save_error_scores``: the same bytes as the JAX (pandas) writer for the
  same tables;
* ``evaluate`` over a batch of 2 and a short last 1: the same row keys
  and scores (1e-5 relative; a cheap forward on both sides, the inputs
  normalised) and the same PNG names as the JAX sweep."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as TP
from pangu_tpu.config import Config as JaxConfig
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.data.constants import norm_data as jax_norm_data
from pangu_tpu.engine import evaluate as jax_evaluate
from pangu_tpu_torch.config import TINY, Config
from pangu_tpu_torch.data.constants import norm_data, synthetic_constants
from pangu_tpu_torch.engine import evaluate

TOL = 5e-4
JAX_CFG = dataclasses.replace(JAX_TINY, attn_impl="xla")


def _fields(batch, seed, consts):
    um, us = consts["upper_mean"][None], consts["upper_std"][None]
    sm, ss = consts["surface_mean"][None], consts["surface_std"][None]
    shape_u = (batch, 5, TINY.levels, TINY.lat, TINY.lon)
    shape_s = (batch, 4, TINY.lat, TINY.lon)
    return ((um + us * TP.normal(shape_u, seed)).astype(np.float32),
            (sm + ss * TP.normal(shape_s, seed + 1)).astype(np.float32))


def test_score_step_matches_jax():
    jparams, params = TP.port_and_jax_params(TINY, seed=5)
    consts = synthetic_constants(TINY)
    u, s = _fields(2, 10, consts)
    tu, ts = _fields(2, 20, consts)
    want, (wu, ws) = jax_evaluate.make_score_step(
        JAX_CFG, {k: jnp.asarray(v) for k, v in consts.items()})(
        jparams, *(jnp.asarray(a) for a in (u, s, tu, ts)))
    step = evaluate.make_score_step(TINY, consts, device="cpu")
    got, (gu, gs) = step(params, *(torch.from_numpy(a) for a in (u, s, tu, ts)))
    assert set(got) == set(want) == set(evaluate.score_names(5))
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape == ((2, TINY.levels) if "upper" in name
                                      else (2, 4))
        if name.startswith("rmse"):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)
    assert gu.shape == wu.shape and gs.shape == ws.shape


def _tables(seed):
    r = np.random.default_rng(seed)
    names = evaluate.score_names(5)
    tables = {n: {} for n in names}
    for key in ("2018010312", "2018010400", "2018010412"):
        for n in names:
            width = 4 if n.endswith("surface") else 13
            row = (r.normal(size=width)
                   * 10.0 ** r.integers(-9, 9, size=width)).astype(np.float32)
            tables[n][key] = row
    tables["acc_surface"]["2018010400"][1] = np.nan
    tables["rmse_upper_z"]["2018010400"][3] = np.inf
    tables["rmse_upper_q"]["2018010400"][:3] = (0.1234567, 2.5e-7, 1.0)
    return tables


@pytest.mark.parametrize("seed", [0, 1])
def test_save_error_scores_bytes_match_jax(tmp_path, seed):
    tables = _tables(seed)
    cfg = JaxConfig()
    args = dict(levels=cfg.data.levels_hpa, surface_vars=cfg.data.surface_variables)
    jax_evaluate.save_error_scores(str(tmp_path / "jax"), tables, **args)
    evaluate.save_error_scores(str(tmp_path / "port"), tables, **args)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 12
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


def test_save_error_scores_empty_and_bad_row(tmp_path):
    empty = {"acc_surface": {}}
    jax_evaluate.save_error_scores(str(tmp_path / "jax"), empty, ["1"],
                                   ["msl", "u10", "v10", "t2m"])
    evaluate.save_error_scores(str(tmp_path / "port"), empty, ["1"],
                               ["msl", "u10", "v10", "t2m"])
    assert (tmp_path / "port" / "acc_surface.csv").read_bytes() == \
        (tmp_path / "jax" / "acc_surface.csv").read_bytes()
    with pytest.raises(ValueError, match="columns"):
        evaluate.save_error_scores(str(tmp_path / "bad"),
                                   {"acc_surface": {"k": np.zeros(3)}}, ["1"],
                                   ["msl", "u10", "v10", "t2m"])


def _batches(consts):
    out = []
    for i, n in enumerate((2, 1)):
        u, s = _fields(n, 30 + i, consts)
        tu, ts = _fields(n, 40 + i, consts)
        keys = [f"20180{i + 1}0{j + 1}00" for j in range(n)]
        out.append({"upper": u, "surface": s, "target_upper": tu,
                    "target_surface": ts, "times": (keys, keys)})
    return out


def test_evaluate_rows_and_pngs_match_jax(tmp_path):
    """A forward that returns the normalised input on both sides, so the
    sweep's bookkeeping (short last batch, row keys, PNG names) is what is
    compared."""
    consts = synthetic_constants(TINY)
    batches = _batches(consts)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}

    def jax_fwd(params, u, s, constants, cfg, deterministic=True):
        return jax_norm_data(u, s, constants)

    def port_fwd(params, u, s, constants, cfg, device, kernels):
        return norm_data(u.to(device), s.to(device), constants)

    want = jax_evaluate.evaluate(
        None, batches, JaxConfig(model=JAX_CFG), jc,
        res_path=str(tmp_path / "jax"), forward_fn=jax_fwd)
    got = evaluate.evaluate(
        None, batches, Config(model=TINY), consts,
        res_path=str(tmp_path / "port"), forward_fn=port_fwd, device="cpu")
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        assert len(got[name]) == 3
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       rtol=1e-5, atol=1e-6)
    pngs = sorted(os.listdir(tmp_path / "port" / "png"))
    assert pngs == sorted(os.listdir(tmp_path / "jax" / "png"))
    assert len(pngs) == 4
    assert sorted(os.listdir(tmp_path / "port" / "csv")) == \
        sorted(os.listdir(tmp_path / "jax" / "csv"))


def test_evaluate_refuses_mislabelled_rows(tmp_path):
    consts = synthetic_constants(TINY)
    batch = _batches(consts)[0]
    batch["times"] = ("2018010100", "2018010100")     # one key, two samples
    with pytest.raises(ValueError, match="timestamps"):
        evaluate.evaluate(None, [batch], Config(model=TINY), consts,
                          res_path=str(tmp_path), device="cpu",
                          visualize=False, forward_fn=None)


def test_evaluate_figures_need_matplotlib(tmp_path, monkeypatch):
    """visualize=True without matplotlib raises ImportError naming it; the
    sweep does not skip its figures silently."""
    import sys
    consts = synthetic_constants(TINY)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def port_fwd(params, u, s, constants, cfg, device, kernels):
        return norm_data(u, s, constants)

    with pytest.raises(ImportError, match="matplotlib"):
        evaluate.evaluate(None, _batches(consts)[1:], Config(model=TINY),
                          consts, res_path=str(tmp_path), device="cpu",
                          forward_fn=port_fwd)

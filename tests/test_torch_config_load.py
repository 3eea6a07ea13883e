"""The port's ``load_config`` against the JAX package's: one JSON file plus
``--set`` overrides give the same tree (``dataclasses.asdict``) apart from
the two documented defaults (``attn_impl``, ``edge_kernels``) and the JAX
package's TPU tuning fields, which the port drops with one warning;
``fast_math=True`` raises."""

import dataclasses
import json
import logging

import pytest

from pangu_tpu.config import load_config as jax_load_config
from pangu_tpu_torch.config import (TINY, TPU_TUNING_FIELDS, Config,
                                    ModelConfig, load_config)

FILE = {
    "output_path": "runs",
    "model": {"levels": 5, "lat": 49, "lon": 192, "depths": [2, 2, 2, 2],
              "heads": [2, 4, 4, 2], "dims": [16, 32, 32, 16],
              "param_dtype": "bfloat16", "gelu": "tanh", "lat_group": 1},
    "data": {"nc_path": "/data/era5", "test_start": 20180103,
             "test_freq": "24h", "levels_hpa": ["1000", "925"]},
    "train": {"lr": 1e-4, "lr_milestones": [3, 6], "batch_size": 4},
    "mesh": {"dp": 2},
}
OVERRIDES = ["data.test_end=20180110", "train.seed=7", "model.remat=false",
             "train.upper_weights=[1,2,3,4,5]", "data.horizon=48"]
DEFAULTS = ("attn_impl", "edge_kernels")


def _write(tmp_path, tree):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _trees(path, overrides):
    want = dataclasses.asdict(jax_load_config(path, overrides))
    got = dataclasses.asdict(load_config(path, overrides))
    for k in TPU_TUNING_FIELDS:
        want["model"].pop(k)
    return got, want


def test_file_and_overrides_match_jax(tmp_path):
    got, want = _trees(_write(tmp_path, FILE), OVERRIDES)
    for k in DEFAULTS:      # the port's documented defaults
        assert (got["model"][k], want["model"][k]) == (
            dataclasses.asdict(ModelConfig())[k],
            {"attn_impl": "xla", "edge_kernels": True}[k])
        got["model"].pop(k), want["model"].pop(k)
    assert got == want
    assert got["data"]["test_start"] == "20180103"       # a string stays one
    assert got["train"]["lr_milestones"] == (3, 6)       # lists -> tuples


def test_explicit_defaults_match_jax(tmp_path):
    tree = json.loads(json.dumps(FILE))
    tree["model"].update(attn_impl="pallas", edge_kernels=False)
    got, want = _trees(_write(tmp_path, tree), OVERRIDES)
    assert got == want


def test_tpu_tuning_fields_dropped_with_one_warning(tmp_path, caplog):
    tree = json.loads(json.dumps(FILE))
    tree["model"].update(lon_chunk=4, attn_unroll=True)
    with caplog.at_level(logging.WARNING, logger="pangu_tpu_torch.config"):
        cfg = load_config(_write(tmp_path, tree), ["model.lon_chunk=8"])
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1
    assert "attn_unroll" in warnings[0].getMessage()
    assert "lon_chunk" in warnings[0].getMessage()
    assert not hasattr(cfg.model, "lon_chunk")
    assert cfg.model.dims == (16, 32, 32, 16)


def test_fast_math_raises(tmp_path):
    with pytest.raises(ValueError, match="fast_math"):
        ModelConfig(fast_math=True)
    with pytest.raises(ValueError, match="fast_math"):
        load_config(None, ["model.fast_math=true"])
    assert load_config(None, ["model.fast_math=false"]).model.fast_math is False


@pytest.mark.parametrize("override", ["model.nope=1", "data.lon_chunk=3"])
def test_unknown_field_raises(override):
    with pytest.raises(KeyError):
        jax_load_config(None, [override])
    with pytest.raises(KeyError):
        load_config(None, [override])


def test_base_then_overrides():
    cfg = load_config(None, ["model.edge_kernels=true"],
                      base=Config(model=TINY))
    assert cfg.model == dataclasses.replace(TINY, edge_kernels=True)

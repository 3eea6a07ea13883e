"""The port's weight conversion against the JAX package's, bit for bit:
``name_map`` (names, order, tree paths), ``convert_torch_state_dict`` in
float32 and bf16 (against ``params_from_jax`` of the JAX conversion),
``export_torch_state_dict``, the DDP prefix, ``load_torch_checkpoint``'s
wrapper, ``read_key_csv`` and the ``onnx`` gate; and the port's
checkpoints: ``save_params`` / ``load_params`` and ``Checkpointer`` (Adam
state, rotation, best, under ``train_loop``) round trips, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from pangu_tpu.config import PANGU_24 as JAX_PANGU_24
from pangu_tpu.config import TINY as JAX_TINY
from pangu_tpu.models import convert as jax_convert
from pangu_tpu_torch.config import PANGU_24, TINY, TrainConfig
from pangu_tpu_torch.engine import train
from pangu_tpu_torch.models import convert, pangu
from pangu_tpu_torch.models.convert import params_from_jax
from pangu_tpu_torch.utils import checkpoint


def _params(seed=0, cfg=TINY):
    return pangu.init_params(torch.Generator().manual_seed(seed), cfg,
                             device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _same_tree(got, want):
    """``want``: a tree, or a dict of its leaves by path."""
    g = dict(_leaves(got))
    w = want if all(isinstance(k, tuple) for k in want) else dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert tuple(g[k].shape) == tuple(np.shape(w[k])), k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=str(k))


@pytest.mark.parametrize("cfg,jcfg", [(TINY, JAX_TINY),
                                      (PANGU_24, JAX_PANGU_24)])
def test_name_map_matches_jax(cfg, jcfg):
    assert convert.name_map(cfg) == jax_convert.name_map(jcfg)
    paths = {p for p, _ in _leaves(_params())}
    assert {e[1] for e in convert.name_map(TINY)} == paths


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_matches_jax(dtype):
    sd = convert.export_torch_state_dict(_params(1), TINY)
    got = convert.convert_torch_state_dict(
        sd, dataclasses.replace(TINY, param_dtype=dtype), device="cpu")
    want = jax_convert.convert_torch_state_dict(sd, JAX_TINY,
                                                dtype=np.dtype(dtype))
    _same_tree(got, want)
    if dtype == "float32":
        _same_tree(got, params_from_jax(want, device="cpu"))
    assert all(t.dtype == getattr(torch, dtype) and t.is_contiguous()
               for _, t in _leaves(got))


def test_export_matches_jax_and_round_trips():
    params = _params(2)
    sd = convert.export_torch_state_dict(params, TINY)
    jparams = {k: v for k, v in _numpy_tree(params).items()}
    want = jax_convert.export_torch_state_dict(jparams, JAX_TINY)
    assert list(sd) == list(want)
    for k in want:
        assert sd[k].dtype == torch.float32 and sd[k].is_contiguous()
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    _same_tree(convert.convert_torch_state_dict(sd, TINY, device="cpu"),
               params)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def test_ddp_prefix_and_missing_keys():
    params = _params(3)
    sd = convert.export_torch_state_dict(params, TINY)
    ddp = {f"module.{k}": v for k, v in sd.items()}
    _same_tree(convert.convert_torch_state_dict(ddp, TINY, device="cpu"),
               params)
    sd.pop("_input_layer.conv.weight")
    with pytest.raises(KeyError, match="missing"):
        convert.convert_torch_state_dict(sd, TINY, device="cpu")


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_checkpoint(tmp_path, wrapped):
    params = _params(4)
    sd = convert.export_torch_state_dict(params, TINY)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sd} if wrapped else sd, path)
    got = convert.load_torch_checkpoint(
        path, dataclasses.replace(TINY, param_dtype="bfloat16"), device="cpu")
    _same_tree(got, jax_convert.load_torch_checkpoint(
        path, JAX_TINY, dtype=np.dtype("bfloat16")))


def test_read_key_csv_matches_jax(tmp_path):
    p = tmp_path / "keys.csv"
    p.write_text("torch_name,onnx_name\n"
                 "_input_layer.conv.weight, onnx::Conv_1 \n"
                 ",ignored\nnot_mapped,\n"
                 "downsample.linear.weight,onnx::MatMul_7\n")
    got = convert.read_key_csv(str(p))
    assert got == jax_convert.read_key_csv(str(p))
    assert got == {"_input_layer.conv.weight": "onnx::Conv_1",
                   "downsample.linear.weight": "onnx::MatMul_7"}


def test_convert_onnx_gated():
    with pytest.raises(ImportError, match="onnx"):
        convert.convert_onnx("/nonexistent.onnx", "/nonexistent.csv", TINY,
                             device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_save_load_params_round_trip(tmp_path, dtype):
    params = _params(5)
    path = str(tmp_path / "w.pt")
    checkpoint.save_params(path, params)
    got = checkpoint.load_params(path, device="cpu", dtype=dtype)
    _same_tree(got, params if dtype is None else _map_bf16(params))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["w.pt"]


def _map_bf16(tree):
    if isinstance(tree, dict):
        return {k: _map_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_bf16(v) for v in tree]
    return tree.bfloat16()


def _train_state(seed):
    tcfg = TrainConfig(lr=1e-3)
    opt = train.make_optimizer(tcfg)
    return train.create_train_state(_params(seed), opt), opt


def _adam_step(state, opt, seed):
    gen = torch.Generator().manual_seed(seed)
    for _, t in _leaves(state.params):
        t.grad = torch.randn(t.shape, generator=gen)
    opt.apply(state.opt_state)
    return dataclasses.replace(state, step=state.step + 1)


def _adam_state(state):
    return state.opt_state["adam"].state_dict()["state"]


def test_checkpointer_round_trip_rotation_best(tmp_path):
    state, opt = _train_state(6)
    state = _adam_step(state, opt, 0)
    ck = checkpoint.Checkpointer(str(tmp_path), max_to_keep=3)
    ck.save(state, epoch=1, step=1, batch=1)
    saved = {k: v.detach().clone() for k, v in _leaves(state.params)}
    saved_adam = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in _adam_state(state).items()}
    ck.save_best(state)
    ck.save(state, epoch=9, step=1)          # the same key: kept as it was
    # a template that has moved on: restore brings back step 1 in place
    live = state.params
    state = _adam_step(_adam_step(state, opt, 1), opt, 2)
    back, key, progress = ck.restore_latest(state)
    assert (key, progress, back.step) == (1, {"epoch": 1, "batch": 1}, 1)
    assert back.params is live
    _same_tree(back.params, saved)
    for i, s in _adam_state(back).items():
        for k, v in s.items():
            torch.testing.assert_close(v, saved_adam[i][k], rtol=0, atol=0)
    assert back.opt_state["count"] == 1
    # training on from the restored state repeats the uninterrupted run
    a = _adam_step(back, opt, 7)
    ref, ref_opt = _train_state(6)
    ref = _adam_step(_adam_step(ref, ref_opt, 0), ref_opt, 7)
    _same_tree(a.params, ref.params)

    for step in range(2, 8):
        ck.save(a, epoch=1, step=step)
    assert ck.all_steps() == [5, 6, 7]
    best = ck.restore_best(_train_state(0)[0])
    _same_tree(best.params, saved)
    assert not [p for p in (tmp_path / "models").iterdir()
                if p.suffix == ".tmp"]
    ck.wait()
    ck.close()


def test_checkpointer_plain_tree_and_empty(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path))
    tree = _params(8)
    assert ck.restore_latest(tree) == (tree, None, {"epoch": 1, "batch": 0})
    ck.save(tree, epoch=3)
    back, key, _ = ck.restore_latest(_params(9))
    assert key == 3
    _same_tree(back, tree)


def test_train_loop_with_checkpointer(tmp_path):
    """``train_loop``'s checkpointer calls (``save`` per epoch and per
    ``save_steps``, ``save_best``) against this Checkpointer, and a resume
    from its latest checkpoint."""
    state, opt = _train_state(10)
    tcfg = TrainConfig(epochs=3, save_steps=2, early_stop_patience=5)
    losses = iter([3.0, 1.0, 2.0])

    def train_step(st, batch, seed):
        return _adam_step(st, opt, seed), {"loss": torch.tensor(0.5)}

    def eval_step(params, batch):
        return {"loss": torch.tensor(next(losses))}

    ck = checkpoint.Checkpointer(str(tmp_path), max_to_keep=10)
    state, history = train.train_loop(
        tcfg, state, train_step, eval_step, lambda epoch: [None] * 3,
        lambda: [None], checkpointer=ck)
    assert history["val_loss"] == [3.0, 1.0, 2.0]
    # per-step saves at steps 2, 4, 6, 8 and epoch-end saves at 3, 6, 9
    assert ck.all_steps() == [2, 3, 4, 6, 8, 9]
    template, _ = _train_state(11)
    back, key, progress = ck.restore_latest(template)
    assert (key, progress, back.step) == (9, {"epoch": 4, "batch": 0}, 9)
    best = ck.restore_best(_train_state(12)[0])
    assert best.step == 6

"""Pretrained-weight conversion into the port's parameter tree: the
counterpart of ``pangu_tpu/models/convert.py``.

  * ``convert_torch_state_dict`` / ``load_torch_checkpoint``: the reference's
    converted checkpoint (``pangu_weather_24_torch.pth``; a bare state dict or
    the train loop's ``{"model": ...}`` wrapper, a DDP ``module.`` prefix
    stripped), read with ``torch.load(weights_only=True)``;
  * ``convert_onnx``: the official ``pangu_weather_24.onnx``, through a
    torch-name -> onnx-name CSV with the reference's ``keys_all.csv`` schema
    (``read_key_csv``); needs the ``onnx`` package, imported inside;
  * ``export_torch_state_dict``: the tree back to the reference's layout
    (CPU float32 tensors), for round trips;
  * ``params_from_jax``: the JAX package's pytree (nested numpy arrays), the
    bridge every parity test feeds both packages through.

``name_map`` gives every parameter's reference name, tree path and layout
rule, in the reference's ``named_parameters`` order:
  torch Linear weight (out, in)     -> transpose -> kernel (in, out)
  torch Conv1d weight (out, in, 1)  -> squeeze + transpose -> kernel (in, out)
  ONNX MatMul weight (in, out)      -> as it is
  earth_specific_bias (1, ntype, heads, N, N) -> (ntype, heads, N, N)
  LayerNorm weight / bias           -> scale / bias
The converters return tensors on ``device`` in ``cfg.param_dtype`` (cast
after the layout rule, from float32).
"""

from __future__ import annotations

import csv
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import ModelConfig

Path = Tuple[Any, ...]


def _block_entries(i: int, j: int) -> List[Tuple[str, Path, str]]:
    t = f"layers.EarthSpecificLayer{i}.blocks.EarthSpecificBlock{j}"
    p: Path = ("stages", i, "blocks", j)
    return [
        (f"{t}.norm1.weight", p + ("norm1", "scale"), "copy"),
        (f"{t}.norm1.bias", p + ("norm1", "bias"), "copy"),
        (f"{t}.norm2.weight", p + ("norm2", "scale"), "copy"),
        (f"{t}.norm2.bias", p + ("norm2", "bias"), "copy"),
        (f"{t}.attention.linear1.weight", p + ("attn", "qkv", "kernel"),
         "linear"),
        (f"{t}.attention.linear1.bias", p + ("attn", "qkv", "bias"), "copy"),
        (f"{t}.attention.linear2.weight", p + ("attn", "proj", "kernel"),
         "linear"),
        (f"{t}.attention.linear2.bias", p + ("attn", "proj", "bias"), "copy"),
        (f"{t}.attention.earth_specific_bias",
         p + ("attn", "bias_table"), "bias_table"),
        (f"{t}.linear.linear1.weight", p + ("mlp", "fc1", "kernel"), "linear"),
        (f"{t}.linear.linear1.bias", p + ("mlp", "fc1", "bias"), "copy"),
        (f"{t}.linear.linear2.weight", p + ("mlp", "fc2", "kernel"), "linear"),
        (f"{t}.linear.linear2.bias", p + ("mlp", "fc2", "bias"), "copy"),
    ]


def name_map(cfg: ModelConfig) -> List[Tuple[str, Path, str]]:
    """(torch_name, tree_path, transform) for every parameter, in the
    reference's ``named_parameters`` order."""
    entries: List[Tuple[str, Path, str]] = [
        ("_input_layer.conv.weight",
         ("patch_embed", "upper", "kernel"), "conv1d"),
        ("_input_layer.conv.bias",
         ("patch_embed", "upper", "bias"), "copy"),
        ("_input_layer.conv_surface.weight",
         ("patch_embed", "surface", "kernel"), "conv1d"),
        ("_input_layer.conv_surface.bias",
         ("patch_embed", "surface", "bias"), "copy"),
    ]
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            entries.extend(_block_entries(i, j))
    entries += [
        ("downsample.linear.weight",
         ("downsample", "reduce", "kernel"), "linear"),
        ("downsample.norm.weight", ("downsample", "norm", "scale"), "copy"),
        ("downsample.norm.bias", ("downsample", "norm", "bias"), "copy"),
        ("upsample.linear1.weight", ("upsample", "expand", "kernel"),
         "linear"),
        ("upsample.linear2.weight", ("upsample", "mix", "kernel"), "linear"),
        ("upsample.norm.weight", ("upsample", "norm", "scale"), "copy"),
        ("upsample.norm.bias", ("upsample", "norm", "bias"), "copy"),
        ("_output_layer.conv.weight",
         ("patch_recovery", "upper", "kernel"), "conv1d"),
        ("_output_layer.conv.bias",
         ("patch_recovery", "upper", "bias"), "copy"),
        ("_output_layer.conv_surface.weight",
         ("patch_recovery", "surface", "kernel"), "conv1d"),
        ("_output_layer.conv_surface.bias",
         ("patch_recovery", "surface", "bias"), "copy"),
    ]
    return entries


# transforms: torch layout -> tree layout
_FROM_TORCH: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "copy": lambda w: w,
    "linear": lambda w: w.t(),
    "conv1d": lambda w: w[:, :, 0].t(),
    "bias_table": lambda w: w.reshape(w.shape[-4:]),
}
# transforms: onnx layout -> tree layout (MatMul weights are (in, out))
_FROM_ONNX: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    **_FROM_TORCH,
    "linear": lambda w: w,
}
# transforms: tree layout -> torch layout
_TO_TORCH: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "copy": lambda w: w,
    "linear": lambda w: w.t(),
    "conv1d": lambda w: w.t()[:, :, None],
    "bias_table": lambda w: w[None],
}


def _set_path(tree: Any, path: Path, value):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _get_path(tree: Any, path: Path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _empty_tree(cfg: ModelConfig) -> Dict:
    return {"patch_embed": {"upper": {}, "surface": {}},
            "stages": [{"blocks": [{"norm1": {}, "norm2": {},
                                    "attn": {"qkv": {}, "proj": {}},
                                    "mlp": {"fc1": {}, "fc2": {}}}
                                   for _ in range(d)]}
                       for d in cfg.depths],
            "downsample": {"norm": {}, "reduce": {}},
            "upsample": {"expand": {}, "norm": {}, "mix": {}},
            "patch_recovery": {"upper": {}, "surface": {}}}


def _leaf(w, transform, dtype, dev) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor)
                        else w).to(torch.float32)
    return transform(w).contiguous().to(dev, dtype)


def convert_torch_state_dict(state_dict: Dict[str, Any], cfg: ModelConfig, *,
                             device: _device.DeviceLike = "cuda") -> Dict:
    """Reference state dict (tensors or numpy arrays) -> the port's tree on
    ``device`` in ``cfg.param_dtype``; a leading ``module.`` (DDP) is
    stripped, a missing parameter raises ``KeyError``."""
    dev = _device.resolve(device)
    dtype = _device.dtype_of(cfg.param_dtype)
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    params = _empty_tree(cfg)
    missing = []
    for torch_name, path, tf in name_map(cfg):
        if torch_name not in sd:
            missing.append(torch_name)
            continue
        _set_path(params, path, _leaf(sd[torch_name], _FROM_TORCH[tf],
                                      dtype, dev))
    if missing:
        raise KeyError(f"{len(missing)} parameters missing from checkpoint, "
                       f"e.g. {missing[:5]}")
    return params


def load_torch_checkpoint(path: str, cfg: ModelConfig, *,
                          device: _device.DeviceLike = "cuda") -> Dict:
    """Load ``pangu_weather_24_torch.pth`` (a bare state dict or the train
    loop's ``{"model": ...}`` wrapper); tensors only
    (``weights_only=True``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return convert_torch_state_dict(obj, cfg, device=device)


def read_key_csv(csv_path: str) -> Dict[str, str]:
    """torch_name -> onnx_name lookup with the keys_all.csv schema."""
    out = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            tn = (row.get("torch_name") or "").strip()
            on = (row.get("onnx_name") or "").strip()
            if tn and on:
                out[tn] = on
    return out


def convert_onnx(onnx_path: str, csv_path: str, cfg: ModelConfig, *,
                 device: _device.DeviceLike = "cuda") -> Dict:
    """Official ONNX weights -> the port's tree (needs the onnx package)."""
    try:
        import onnx
        from onnx import numpy_helper
    except ImportError as e:
        raise ImportError(
            "the 'onnx' package is not installed in this environment; use "
            "load_torch_checkpoint on the converted .pth instead") from e
    dev = _device.resolve(device)
    dtype = _device.dtype_of(cfg.param_dtype)
    model = onnx.load(onnx_path)
    weights = {init.name: numpy_helper.to_array(init)
               for init in model.graph.initializer}
    lookup = read_key_csv(csv_path)
    params = _empty_tree(cfg)
    for torch_name, path, tf in name_map(cfg):
        onnx_name = lookup.get(torch_name)
        if onnx_name is None or onnx_name not in weights:
            raise KeyError(f"no ONNX initializer for {torch_name} "
                           f"({onnx_name})")
        _set_path(params, path, _leaf(weights[onnx_name], _FROM_ONNX[tf],
                                      dtype, dev))
    return params


def export_torch_state_dict(params: Dict, cfg: ModelConfig
                            ) -> Dict[str, torch.Tensor]:
    """The port's tree -> a reference-layout state dict of contiguous CPU
    float32 tensors (the inverse transforms)."""
    return {torch_name: _TO_TORCH[tf](
                _get_path(params, path).detach().to("cpu", torch.float32)
            ).contiguous()
            for torch_name, path, tf in name_map(cfg)}


def params_from_jax(tree, *, device: _device.DeviceLike = "cuda"):
    """The JAX parameter pytree as nested numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's tree: the same key
    paths and shapes (dense kernels stay (in, out)), tensors in the same
    dtype, LoRA leaves included, the scalar ``lora_scale`` / ``lora_drop`` /
    ``lora_drop_feat`` as 0-dim tensors."""
    dev = _device.resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)

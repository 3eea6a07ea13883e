"""Parameter bridge from the JAX package: the counterpart of
``pangu_tpu/models/convert.py`` for the port.

``params_from_jax(tree)`` takes the JAX parameter pytree as nested numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same key paths and shapes (dense kernels stay (in, out)), tensors in
the same dtype, LoRA leaves (``models/lora.py``) included, the scalar
``lora_scale`` / ``lora_drop`` / ``lora_drop_feat`` as 0-dim tensors.  Every
parity test feeds both packages through it."""

from __future__ import annotations

import numpy as np
import torch

from pangu_tpu_torch import _device


def params_from_jax(tree, *, device: _device.DeviceLike = "cuda"):
    dev = _device.resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)

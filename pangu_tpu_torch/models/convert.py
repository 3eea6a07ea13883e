"""Parameter bridge from the JAX package: the counterpart of
``pangu_tpu/models/convert.py`` for the port.

``params_from_jax(tree)`` takes the JAX parameter pytree as nested numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same key paths and shapes (dense kernels stay (in, out)), tensors in
the same dtype.  Every parity test feeds both packages through it."""

from __future__ import annotations

import numpy as np
import torch

from pangu_tpu_torch import _device


def params_from_jax(tree, *, device: _device.DeviceLike = "cuda"):
    dev = _device.resolve(device)

    def conv(node, path):
        if isinstance(node, dict):
            for k in node:
                if str(k).startswith("lora"):
                    raise NotImplementedError(
                        f"LoRA leaf {'/'.join(map(str, path + (k,)))}: LoRA "
                        "is not ported yet (ROADMAP queue A)")
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, path + (i,)) for i, v in enumerate(node)]
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree, ())

"""Plain math of the block tail.

The counterpart of ``pangu_tpu/ops/block_tail.py::tail_math`` (with
``_kernel_ln``, ``_kernel_erf``, ``_kernel_gelu``): ``x1 = s + LN1(a)``;
``out = x1 + LN2(MLP(x1))``, LayerNorm statistics in float32, erf GELU for
parity and tanh GELU for the perf config.  Every product accumulates in
float32 and is rounded to the activation dtype where the JAX kernel rounds it,
so a plain version and its CUDA kernel agree in bf16 too.  (The JAX kernel's
erf is the Abramowitz-Stegun polynomial, max error 1.5e-7; here it is exact.)
"""

from __future__ import annotations

import math

import torch

from pangu_tpu_torch.models.layers import dense, layer_norm


def gelu(x, tanh: bool):
    """GELU in float32 on x, rounded back to x.dtype (erf or tanh form)."""
    xf = x.float()
    if tanh:
        inner = math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf ** 3)
        y = 0.5 * xf * (1.0 + torch.tanh(inner))
    else:
        y = xf * 0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))
    return y.to(x.dtype)


def _scaled(branch, s):
    """A rounded LayerNorm branch times its stochastic-depth scale, the scale
    cast to the branch's dtype and the product rounded to it (the JAX tail's
    order)."""
    return branch if s is None else branch * s.to(branch.dtype)


def tail_math(a, s, p, gelu_tanh: bool, s1=None, s2=None):
    """The block tail on (..., C) tensors: ``a`` the attention branch, ``s``
    the shortcut, ``p`` the block's params (norm1, norm2, mlp), already in
    the activation dtype.  ``s1`` / ``s2``: optional per-sample
    stochastic-depth scales of the two branches (float32, broadcastable
    against ``a``); None means 1.  x1 = s + s1*LN1(a); out = x1 +
    s2*LN2(MLP(x1))."""
    dt = a.dtype
    x1 = (s.float() + _scaled(layer_norm(p["norm1"], a), s1).float()).to(dt)
    h = gelu(dense(p["mlp"]["fc1"], x1), gelu_tanh)
    y = dense(p["mlp"]["fc2"], h)
    return (x1.float() + _scaled(layer_norm(p["norm2"], y), s2).float()).to(dt)

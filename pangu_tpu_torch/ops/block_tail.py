"""The block tail: its plain math and its kernel.

The counterpart of ``pangu_tpu/ops/block_tail.py``: ``tail_math`` (with
``_kernel_ln``, ``_kernel_erf``, ``_kernel_gelu``) and ``fused_block_tail``,
which the per-block path (``models/layers.py::earth_block``) runs after the
attention of a served block: ``fused_block_tail`` launches the CUDA kernel
(``csrc/block_tail.cu``) on a CUDA tensor, with a ``launches`` count, and
runs ``fused_block_tail_plain`` on a CPU tensor (``tail_operands``: what
the kernel takes; bf16 runs on the tensor cores and takes C and the MLP
width multiples of 8).  ``x1 = s + LN1(a)``;
``out = x1 + LN2(MLP(x1))``, LayerNorm statistics in float32, erf GELU for
parity and tanh GELU for the perf config.  Every product accumulates in
float32 and is rounded to the activation dtype where the JAX kernel rounds it,
so a plain version and its CUDA kernel agree in bf16 too.  (The JAX kernel's
erf is the Abramowitz-Stegun polynomial, max error 1.5e-7; here it is exact.)
"""

from __future__ import annotations

import math

import torch

from pangu_tpu_torch import _build
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


def fused_block_tail_plain(p, a, s, gelu_tanh: bool):
    """Plain PyTorch version of :func:`fused_block_tail` (any device)."""
    from pangu_tpu_torch.ops.earth_block_wm import params_in
    q = params_in({k: p[k] for k in ("norm1", "norm2", "mlp")}, a.dtype)
    return tail_math(a, s, q, gelu_tanh)


def tail_operands(p, a, s, what: str = "fused_block_tail"):
    """What the kernel takes, checked before a launch: ``(a, s, q,
    hidden)``, a and s contiguous, q the tail's params in a's dtype.
    Raises ValueError on an unsupported input or, in bf16 (the
    tensor-core route), on a C or hidden that is not a multiple of 8; the
    bf16 a, s and dense weights are 16-byte aligned (copies where they are
    not)."""
    from pangu_tpu_torch.ops.earth_block_wm import (DTYPE_CODE, aligned16,
                                                    check_tensor_core_shape,
                                                    params_in)
    c = a.shape[-1]
    q = params_in({k: p[k] for k in ("norm1", "norm2", "mlp")}, a.dtype)
    hidden = q["mlp"]["fc1"]["kernel"].shape[-1]
    if (a.dtype not in DTYPE_CODE or s.shape != a.shape or s.dtype != a.dtype
            or s.device != a.device or "lora_a" in p["mlp"]["fc1"]
            or "lora_a" in p["mlp"]["fc2"]
            or q["mlp"]["fc1"]["kernel"].shape != (c, hidden)
            or q["mlp"]["fc2"]["kernel"].shape != (hidden, c)):
        raise ValueError(f"{what}: unsupported a {tuple(a.shape)} "
                         f"{a.dtype}, s {tuple(s.shape)} {s.dtype}, hidden "
                         f"{hidden}")
    a, s = a.contiguous(), s.contiguous()
    if a.dtype == torch.bfloat16:
        check_tensor_core_shape((c, hidden), None, what)
        a, s = aligned16(a), aligned16(s)
        for leaf in ("fc1", "fc2"):
            q["mlp"][leaf]["kernel"] = aligned16(q["mlp"][leaf]["kernel"])
    return a, s, q, hidden


def fused_block_tail(p, a, s, gelu_tanh: bool):
    """The tail of one block: ``a`` the attention branch and ``s`` the
    block's input, (B, Z, H, W, C) each (any shape ending in C; token-local),
    ``p`` the block's params (norm1, norm2, mlp; cast to a's dtype).  The
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not a.is_cuda:
        return fused_block_tail_plain(p, a, s, gelu_tanh)
    from pangu_tpu_torch.ops.earth_block_wm import DTYPE_CODE, require_device
    a2, s2, q, hidden = tail_operands(p, a, s)
    require_device(q, a.device, "fused_block_tail")
    c = a.shape[-1]
    rows = a2.numel() // c
    out = torch.empty_like(a2)
    ws = torch.empty(rows * (2 * c + hidden), dtype=a.dtype, device=a.device)
    tensors = (a2, s2, out, ws, q["norm1"]["scale"], q["norm1"]["bias"],
               q["norm2"]["scale"], q["norm2"]["bias"],
               q["mlp"]["fc1"]["kernel"], q["mlp"]["fc1"]["bias"],
               q["mlp"]["fc2"]["kernel"], q["mlp"]["fc2"]["bias"])
    with _build.launch_stream(*tensors) as stream:
        code = _build.library().pangu_block_tail(
            DTYPE_CODE[a.dtype], *(t.data_ptr() for t in tensors),
            rows, c, hidden, int(gelu_tanh), stream)
    _build.check(code, "fused_block_tail")
    fused_block_tail.launches += 1
    return out


fused_block_tail.launches = 0

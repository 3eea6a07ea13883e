"""ONNX Runtime baseline engine (optional dependency): the counterpart of
``pangu_tpu/engine/onnx_baseline.py``.

The reference's trusted oracle is the official ``pangu_weather_24.onnx``
run through ONNX Runtime (tuned session options, CPU or CUDA execution
provider, a host-side autoregressive feedback loop).  This module runs that
engine, so a user holding the official weights can put its row of the
score tables beside the port's: the same rollout, the same CSVs.

onnxruntime is imported inside :func:`make_session`, which exits with an
actionable message where it is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _require_ort():
    try:
        import onnxruntime as ort
    except ImportError:
        raise SystemExit(
            "the --onnx-baseline path runs the official .onnx through "
            "ONNX Runtime, which is not installed in this environment; "
            "install onnxruntime (CPU) or onnxruntime-gpu, then re-run. "
            "The port's own path does not need it.") from None
    return ort


def make_session(onnx_path: str,
                 providers: Optional[Sequence[str]] = None,
                 intra_op_threads: int = 16):
    """ORT session with the reference's options: memory arena, memory
    pattern and reuse off (the 1.1 GB activations thrash the arena
    allocator), 16 intra-op threads, the CPU provider unless ``providers``
    says otherwise."""
    ort = _require_ort()
    opts = ort.SessionOptions()
    opts.enable_cpu_mem_arena = False
    opts.enable_mem_pattern = False
    opts.enable_mem_reuse = False
    opts.intra_op_num_threads = intra_op_threads
    providers = list(providers or ["CPUExecutionProvider"])
    return ort.InferenceSession(onnx_path, sess_options=opts,
                                providers=providers)


def _io_names(session) -> Tuple[str, str, str, str]:
    """Input / output binding names (the official export's input /
    input_surface -> output / output_surface, found by name so re-exports
    keep working)."""
    ins = [i.name for i in session.get_inputs()]
    outs = [o.name for o in session.get_outputs()]
    in_u = next((n for n in ins if "surface" not in n), ins[0])
    in_s = next((n for n in ins if "surface" in n), ins[-1])
    out_u = next((n for n in outs if "surface" not in n), outs[0])
    out_s = next((n for n in outs if "surface" in n), outs[-1])
    return in_u, in_s, out_u, out_s


def rollout(session, upper: np.ndarray, surface: np.ndarray,
            steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's host-side autoregressive loop: each 24 h output feeds
    back as the next input.  upper (5, levels, lat, lon) / surface (4, lat,
    lon), physical units, float32, no batch axis (the official graph has
    none)."""
    in_u, in_s, out_u, out_s = _io_names(session)
    u = np.ascontiguousarray(upper, np.float32)
    s = np.ascontiguousarray(surface, np.float32)
    for _ in range(steps):
        u, s = session.run([out_u, out_s], {in_u: u, in_s: s})
    return np.asarray(u), np.asarray(s)

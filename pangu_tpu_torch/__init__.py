"""PyTorch + CUDA port of pangu-tpu for one NVIDIA H100.

A second package beside ``pangu_tpu`` (the JAX reference, which it never
imports).  Module names mirror ``pangu_tpu`` so each counterpart is easy to
find.  It serves the 24 h forecast step and its chained rollout, full-step or
token-space, and the hierarchical rollout over several models, on the
window-major trunk, and the canonical-layout forward with taps: hand-written
CUDA C++ kernels (``csrc/``: whole Earth-specific block, ungrouped, grouped
by latitude windows or with a canonical end, DownSample and UpSample in both
layouts, and the edge kernels embed, transition and recovery), each with a
plain PyTorch version that serves CPU tensors.
"""

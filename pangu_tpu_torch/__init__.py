"""PyTorch + CUDA port of pangu-tpu for one NVIDIA H100.

A second package beside ``pangu_tpu`` (the JAX reference, which it never
imports).  Module names mirror ``pangu_tpu`` so each counterpart is easy to
find.  It serves the 24 h forecast step and its chained rollout, full-step or
token-space, on the window-major trunk: hand-written CUDA C++ kernels
(``csrc/``: whole Earth-specific block, DownSample, UpSample, and the edge
kernels embed, transition and recovery), each with a plain PyTorch version
that serves CPU tensors.
"""

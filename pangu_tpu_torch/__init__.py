"""PyTorch + CUDA port of pangu-tpu for one NVIDIA H100.

A second package beside ``pangu_tpu`` (the JAX reference, which it never
imports).  Module names mirror ``pangu_tpu`` so each counterpart is easy to
find.  It serves the 24 h forecast step and its chained rollout, full-step or
token-space, and the hierarchical rollout over several models, on the
window-major trunk, and the canonical-layout forward with taps: hand-written
CUDA C++ kernels (``csrc/``: whole Earth-specific block, ungrouped, grouped
by latitude windows or with a canonical end, DownSample and UpSample in both
layouts, and the edge kernels embed, transition and recovery), each with a
plain PyTorch version that serves CPU tensors.  It trains on either trunk
(the whole-block backward, or the rolled-coordinate blocks through the grid
attention and its backward), and serves and trains LoRA adapters
(``models/lora.py``), merged into the fused trunks or unmerged on the
per-block path (``models/layers.py::earth_block``: the no-roll block, the
block tail and the windowed sdpa kernels).  It forecasts and scores through
its own command lines (``cli/``: ``convert_weights``, ``evaluate``,
``inference``) on JSON config files (``config.load_config``), the ERA5
pipeline (``data/era5.py``, ``data/fastpack.py``), reference checkpoints
(``models/convert.py``) and the lat-weighted RMSE / ACC (``metrics/``,
``engine/evaluate.py``).  It serves the forecast under a (dp, sp, tp) mesh
of ``torch.distributed`` ranks (``parallel/``: the window-major trunk per
shard, with lon and z halo exchanges and the tp z-shard transition).
"""

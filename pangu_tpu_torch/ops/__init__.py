"""The port's kernel wrappers and their launch counters.

Each wrapper launches its CUDA kernel for a CUDA tensor (and adds one to its
``launches`` count), or runs its plain PyTorch version for a CPU tensor."""

from __future__ import annotations

from typing import Dict

from pangu_tpu_torch.ops.earth_block_wm import block_wm
from pangu_tpu_torch.ops.updown_wm import down_sample_wm, up_sample_wm

KERNELS = {
    "block_wm": block_wm,
    "down_sample_wm": down_sample_wm,
    "up_sample_wm": up_sample_wm,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}

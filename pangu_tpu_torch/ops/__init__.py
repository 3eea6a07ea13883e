"""The port's kernel wrappers and their launch counters.

Each wrapper launches its CUDA kernel for a CUDA tensor (and adds one to its
``launches`` count), or runs its plain PyTorch version for a CPU tensor.
``launches()`` also reports ``transition_wm_z``, the transition's launches
on a tp z shard."""

from __future__ import annotations

from typing import Callable, Dict

from pangu_tpu_torch.ops.block_tail import fused_block_tail
from pangu_tpu_torch.ops.earth_block_bwd import block_bwd, block_bwd_canon
from pangu_tpu_torch.ops.earth_block_fused import block_v2
from pangu_tpu_torch.ops.earth_block_wm import (block_wm, block_wm_canon,
                                                block_wm_group)
from pangu_tpu_torch.ops.recovery_wm import (recovery_bwd, recovery_wm_surface,
                                             recovery_wm_upper)
from pangu_tpu_torch.ops.updown import down_sample, up_sample
from pangu_tpu_torch.ops.updown_wm import down_sample_wm, up_sample_wm
from pangu_tpu_torch.ops.window_attention import (block_noroll_fused,
                                                  grid_attention,
                                                  grid_attention_bwd, sdpa,
                                                  sdpa_bwd,
                                                  window_attention_pallas)


def kernels() -> Dict[str, Callable]:
    """Every kernel wrapper by name.  (Two are imported here, not at the
    top: ``engine.transition_wm`` imports this package, and a package-level
    name ``embed_wm`` would hide the submodule of that name.)"""
    from pangu_tpu_torch.engine.transition_wm import apply_transition_wm
    from pangu_tpu_torch.ops.embed_wm import embed_dw_upper, embed_wm
    return {"block_wm": block_wm,
            "block_wm_group": block_wm_group,
            "block_wm_canon": block_wm_canon,
            "down_sample_wm": down_sample_wm,
            "up_sample_wm": up_sample_wm,
            "embed_wm": embed_wm,
            "transition_wm": apply_transition_wm,
            "recovery_wm_upper": recovery_wm_upper,
            "recovery_wm_surface": recovery_wm_surface,
            "down_sample": down_sample,
            "up_sample": up_sample,
            "block_bwd": block_bwd,
            "block_bwd_canon": block_bwd_canon,
            "embed_dw_upper": embed_dw_upper,
            "recovery_bwd": recovery_bwd,
            "block_v2": block_v2,
            "grid_attention": grid_attention,
            "grid_attention_bwd": grid_attention_bwd,
            "sdpa": sdpa,
            "sdpa_bwd": sdpa_bwd,
            "block_noroll_fused": block_noroll_fused,
            "fused_block_tail": fused_block_tail,
            "window_attention_pallas": window_attention_pallas}


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0
    kernels()["transition_wm"].z_launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's count, and ``transition_wm_z``: the transition's
    launches on a tp z shard (row 5z; counted in ``transition_wm`` too)."""
    counts = {name: fn.launches for name, fn in kernels().items()}
    counts["transition_wm_z"] = kernels()["transition_wm"].z_launches
    return counts

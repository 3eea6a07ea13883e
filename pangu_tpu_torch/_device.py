"""Device resolution for the port's public entry points.

Entry points default to ``device="cuda"``.  Asking for the card where none
is present raises: the port never drops quietly to the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike) -> torch.device:
    """The device to run on; a bare "cuda" becomes the current card's index
    so that it compares equal to a tensor's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dtype_of(name: str) -> torch.dtype:
    """"float32" / "bfloat16" (config strings) -> torch dtype."""
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None

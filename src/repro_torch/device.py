"""Device resolution for the port's entry points.

Every entry point that creates tensors runs on the GPU unless its caller
asks for the CPU.  There is no silent fallback: with no CUDA device and
no explicit ``device="cpu"``, resolution raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given.  Raises if CUDA is asked for (or implied) and not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


"""Where the port's entry points run."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no CUDA device (no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run the plain versions")
    return device

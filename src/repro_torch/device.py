"""The device rule of the port, in one place."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: the port's entry points run on CUDA unless
    the caller names another device, and raise where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless "
                "device='cpu' is passed explicitly")
        return torch.device("cuda")
    return torch.device(device)

"""The device rule of the entry points: the card unless the caller names another."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means ``torch.device("cuda")``. A CUDA device with no card
    raises: nothing falls back to the CPU unless asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev

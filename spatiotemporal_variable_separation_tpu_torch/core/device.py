"""The port's device rule: every entry point runs on the card unless the caller
asks for the CPU, and without a card it raises instead of falling back."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device=None`` means the card (``cuda``); a CUDA device with no card
    present raises, naming ``who``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device

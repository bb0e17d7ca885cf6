"""Device resolution shared by the port's entry points.

``None`` means the CUDA card: an entry point runs on the card unless the
caller asks for the CPU, and raises when no card is visible instead of
falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    one); any other device is returned as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def describe_device(dev: torch.device) -> str:
    """``"platform: cuda, device: <card's name>"`` for a CUDA device,
    ``"platform: <type>"`` for any other."""
    if dev.type == "cuda":
        return f"platform: cuda, device: {torch.cuda.get_device_name(dev)}"
    return f"platform: {dev.type}"

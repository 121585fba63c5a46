"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never move to the CPU on their own."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for, but CUDA is not available; "
                           f"pass device='cpu' to run on the CPU")
    return dev

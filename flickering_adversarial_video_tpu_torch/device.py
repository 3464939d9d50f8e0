"""Device choice for the port's entry points: the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA.  Raises when CUDA is asked for and absent: the
    entry points never fall back to the CPU on their own; the caller passes
    device="cpu" to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev

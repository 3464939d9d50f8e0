"""Device choice for the port's entry points: the card unless told otherwise."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA: the card ``LOCAL_RANK`` under torchrun, else the
    current one.  Raises when CUDA is asked for and absent: the entry points
    never fall back to the CPU on their own; the caller passes device="cpu"
    to run there."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev

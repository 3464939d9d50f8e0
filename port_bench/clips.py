"""Seeded clips, drawn on the card.

A clip is uniform noise of +-48 levels around a colour of its own (each
channel's level uniform in [48, 208)), as uint8: clips differ from one
another as much in their colour as in their detail, so that the victim
answers each clip differently, as it answers different videos.
"""

from __future__ import annotations

import torch

LEVEL_LO, LEVEL_HI, NOISE = 48, 208, 48


def draw(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 clips [N, T, H, W, 3]."""
    n = shape[0]
    level = torch.randint(LEVEL_LO, LEVEL_HI, (n,) + (1,) * (len(shape) - 2) + (shape[-1],),
                          generator=gen, device=device, dtype=torch.int16)
    noise = torch.randint(-NOISE, NOISE, tuple(shape), generator=gen, device=device,
                          dtype=torch.int16)
    return (level + noise).clamp_(0, 255).to(torch.uint8)

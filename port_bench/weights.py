"""Seeded victim weights, drawn on the device in two calls.

Every kernel (conv weight, the head's weight) is N(0, gain / fan_in), fan_in
the product of its input dims: ``conv_gain`` for the convolutions, which a
ReLU follows (He's rule at 2), ``head_gain`` for the classifier.  Each
batch-norm (a module with running statistics) holds a mean N(0, 0.1^2), a
variance U(0.5, 1.5), a scale U(0.8, 1.2) where it has one and an offset
N(0, 0.1^2), a channel each, so that a comparison sees each of its four
terms; the head's bias is 0.  The gains are the configuration's ``init``.
One ``torch.Generator`` on the device, seeded with the run's seed, draws
every kernel, mean and offset in a single ``randn`` and every variance and
scale in a single ``rand``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

HEAD_KEYS = ("Logits.Conv3d_0c_1x1.conv_3d.weight", "fc.weight")
BN_STD = 0.1
# key suffix: (drawn by randn, low, width); a value is low + width * draw
BN_DRAWS = {"running_mean": (True, 0.0, BN_STD), "bias": (True, 0.0, BN_STD),
            "running_var": (False, 0.5, 1.0), "weight": (False, 0.8, 0.4)}


def _is_kernel(key: str, shape: Tuple[int, ...]) -> bool:
    return key.endswith("weight") and len(shape) >= 2


def _bn_kind(key: str, shapes: Dict[str, Tuple[int, ...]]):
    """The batch-norm tensor `key` is (a BN_DRAWS key), or None."""
    module, _, leaf = key.rpartition(".")
    if leaf in BN_DRAWS and f"{module}.running_mean" in shapes and len(shapes[key]) == 1:
        return leaf
    return None


def draw(shapes: Dict[str, Tuple[int, ...]], init: Dict[str, float], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """A state dict of `shapes` (float32; ``num_batches_tracked`` int64)."""
    kernels = [(k, s) for k, s in shapes.items() if _is_kernel(k, s)]
    bn = [(k, s, _bn_kind(k, shapes)) for k, s in shapes.items() if _bn_kind(k, shapes)]
    normal = [(k, s, kind) for k, s, kind in bn if BN_DRAWS[kind][0]]
    uniform = [(k, s, kind) for k, s, kind in bn if not BN_DRAWS[kind][0]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s in kernels + [(k, s) for k, s, _ in normal]),
                       generator=gen, device=device)
    unit = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    sd, at = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        gain = init["head_gain"] if key in HEAD_KEYS else init["conv_gain"]
        sd[key] = flat[at:at + n].view(shape).mul_(math.sqrt(gain / math.prod(shape[1:])))
        at += n
    for source, rows in ((flat, normal), (unit, uniform)):
        if source is unit:
            at = 0
        for key, shape, kind in rows:
            n = math.prod(shape)
            _, low, width = BN_DRAWS[kind]
            sd[key] = source[at:at + n].view(shape).mul_(width).add_(low)
            at += n
    for key, shape in shapes.items():
        if key in sd:
            continue
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            sd[key] = torch.zeros(shape, device=device)
    return sd

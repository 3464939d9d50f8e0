"""A torchvision ``video_resnet`` state dict into the port's VideoResNet.

The port's counterpart of the JAX package's ``convert/torch_video_resnet.py``.
The port's module names are torchvision's, so no name changes: the state
dict is read from a ``.pt``/``.pth`` (a ``module.`` prefix, as
``nn.DataParallel`` saves it, is stripped), its head width is read from
``fc.weight``, and every tensor is checked against the shapes of the
variant's module before it is loaded.  ``num_batches_tracked``, which the
model never reads, may be absent.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from ..models.video_resnet import state_shapes

_COUNTER = "num_batches_tracked"


def convert_video_resnet_state_dict(
    state: Union[str, Mapping[str, torch.Tensor]], variant: str,
    num_classes: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """The f32 state dict of the port's `variant` from a torchvision state
    dict or the path of one.  `num_classes` defaults to the checkpoint's head
    width; a different one raises, as does any missing, unexpected or
    misshapen tensor."""
    if isinstance(state, str):
        state = torch.load(state, map_location="cpu", weights_only=True)
    if not isinstance(state, Mapping):
        raise ValueError(f"not a state dict: a {type(state).__name__}")
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    if "fc.weight" not in state:
        raise ValueError("not a torchvision video_resnet state dict: no 'fc.weight'")
    width = int(state["fc.weight"].shape[0])
    if num_classes is not None and num_classes != width:
        raise ValueError(f"{variant}: the checkpoint's head has {width} classes, not {num_classes}")
    want = state_shapes(variant, width)
    missing = [k for k in want if k not in state and not k.endswith(_COUNTER)]
    unexpected = [k for k in state if k not in want]
    if missing or unexpected:
        raise ValueError(f"{variant}: missing {missing[:5]} ({len(missing)}), "
                         f"unexpected {unexpected[:5]} ({len(unexpected)})")
    out: Dict[str, torch.Tensor] = {}
    for k, shape in want.items():
        if k.endswith(_COUNTER):
            out[k] = torch.as_tensor(state.get(k, 0), dtype=torch.long).reshape(())
            continue
        v = torch.as_tensor(state[k])
        if tuple(v.shape) != shape:
            raise ValueError(f"{variant}: {k} has shape {tuple(v.shape)}, the model {shape}")
        out[k] = v.detach().to("cpu", torch.float32).contiguous()
    return out

"""Checkpoint conversion CLI and the port's weight files.

Convert once, load fast:
  python -m flickering_adversarial_video_tpu_torch.convert.cli i3d \\
      /ckpts/rgb_imagenet/model.ckpt --out i3d_kinetics400.pt
  python -m flickering_adversarial_video_tpu_torch.convert.cli i3d \\
      /ckpts/rgb_kinetics_600/model.ckpt --eval-type rgb600 --out i3d_kinetics600.pt
  python -m flickering_adversarial_video_tpu_torch.convert.cli r2plus1d_18 \\
      /ckpts/r2plus1d_18.pth --out r2plus1d_18.msgpack

The port's counterpart of the JAX package's ``convert/cli.py``.  The TF
checkpoint is read by the port's own bundle reader (``convert/tf_bundle.py``),
without TensorFlow, so the command is the same on the CPU and on the card.
A video ResNet's input is a torchvision state dict (``.pt``/``.pth``; its
names are the port's, ``convert/torch_video_resnet.py`` checks the shapes).
The output is ``torch.save`` of the model's state dict (``--out w.pt``), or
the JAX package's own format, the Flax variables tree in flax's msgpack
(``--out w.msgpack``; ``save_variables`` / ``load_variables``, the
counterparts of the JAX package's, through the port's own codec
``convert/flax_msgpack.py``: the card has no flax and no ``msgpack``).  A
``.pt`` or ``.msgpack`` input is taken as converted already (for
``--dump-golden`` or a change of format without converting again).
``--dump-golden`` runs the model, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping

import torch

from . import flax_i3d, flax_msgpack, flax_video_resnet

TORCH_WORLD = ("r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34")


def save_variables(variables: Dict[str, Any], path: str) -> None:
    """A Flax variables tree (numpy leaves) to a ``.msgpack``, the bytes
    ``flax.serialization.msgpack_serialize`` writes."""
    with open(path, "wb") as f:
        f.write(flax_msgpack.serialize(variables))


def load_variables(path: str) -> Dict[str, Any]:
    """``flax.serialization.msgpack_restore`` of the file at `path`."""
    with open(path, "rb") as f:
        return flax_msgpack.restore(f.read())


def save_weights(state: Mapping[str, torch.Tensor], path: str, model_name: str = "i3d") -> None:
    """A state dict of `model_name` to `path`: the Flax tree in a
    ``.msgpack``, else ``torch.save``."""
    if str(path).endswith(".msgpack"):
        if model_name in TORCH_WORLD:
            save_variables(flax_video_resnet.to_flax_variables(state, model_name), path)
        else:
            save_variables(flax_i3d.to_flax_variables(state), path)
        return
    torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()}, path)


def load_weights(path: str, eval_type: str = "rgb", model_name: str = "i3d") -> Dict[str, torch.Tensor]:
    """The state dict of `model_name` at `path`: a ``.msgpack`` of the JAX
    model's Flax variables (mapped by ``convert/flax_i3d.py`` or
    ``convert/flax_video_resnet.py``), a ``.pt``/``.pth`` (for a video ResNet
    a torchvision state dict, checked by ``convert/torch_video_resnet.py``;
    for I3D one that :func:`save_weights` wrote), or a DeepMind TF checkpoint
    prefix of I3D, converted on load (`eval_type` 'rgb600': prefix-less
    names)."""
    path = str(path)
    if path.endswith(".msgpack"):
        if model_name in TORCH_WORLD:
            return flax_video_resnet.from_flax_variables(load_variables(path), model_name)
        return flax_i3d.from_flax_variables(load_variables(path))
    if model_name in TORCH_WORLD:
        from .torch_video_resnet import convert_video_resnet_state_dict

        if not path.endswith((".pt", ".pth")):
            raise ValueError(f"{model_name} weights are a .pt/.pth or a .msgpack, not {path!r}")
        return convert_video_resnet_state_dict(path, model_name)
    if path.endswith((".pt", ".pth")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict):
            raise ValueError(f"{path} holds a {type(state).__name__}, not a state dict")
        return state
    from .tf_i3d import convert_i3d_checkpoint

    return convert_i3d_checkpoint(path, eval_type=eval_type)


def convert(model_name: str, ckpt_path: str, eval_type: str = "rgb") -> Dict[str, torch.Tensor]:
    return load_weights(ckpt_path, eval_type=eval_type, model_name=model_name)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=["i3d", *TORCH_WORLD])
    p.add_argument(
        "ckpt",
        help="TF checkpoint prefix (i3d), a torchvision state dict .pth (the video ResNets), "
        "or an already-converted .pt or .msgpack (for --dump-golden or a change of format "
        "without converting again)",
    )
    p.add_argument("--out", help="output path: .pt (torch.save) or .msgpack (Flax variables)")
    p.add_argument(
        "--eval-type",
        default="rgb",
        choices=["rgb", "rgb600"],
        help="I3D checkpoint variable-name world (rgb600 = Kinetics-600, prefix-less names)",
    )
    p.add_argument(
        "--dump-golden",
        metavar="NPZ",
        help="record canonical-clip logits for these weights into a golden .npz that "
        "convert.golden.verify_golden checks (the JAX package's format)",
    )
    p.add_argument("--device", default=None, help="--dump-golden's device: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if not args.out and not args.dump_golden:
        p.error("nothing to do: pass --out and/or --dump-golden")
    state = convert(args.model, args.ckpt, eval_type=args.eval_type)
    if args.out:
        save_weights(state, args.out, args.model)
        n = sum(v.numel() for v in state.values())
        print(f"wrote {args.out} ({n / 1e6:.1f}M values)")
    if args.dump_golden:
        from ..runners.common import infer_num_classes
        from .golden import dump_golden

        payload = dump_golden(
            args.model, state, args.dump_golden, args.out or args.ckpt,
            num_classes=infer_num_classes(state, args.model), device=args.device,
        )
        print(f"wrote golden {args.dump_golden} (top-5 classes: {payload['top5'].tolist()})")


if __name__ == "__main__":
    main()

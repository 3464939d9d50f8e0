"""Checkpoint conversion CLI and the port's weight files.

Convert once, load fast:
  python -m flickering_adversarial_video_tpu_torch.convert.cli i3d \\
      /ckpts/rgb_imagenet/model.ckpt --out i3d_kinetics400.pt
  python -m flickering_adversarial_video_tpu_torch.convert.cli i3d \\
      /ckpts/rgb_kinetics_600/model.ckpt --eval-type rgb600 --out i3d_kinetics600.pt

The port's counterpart of the JAX package's ``convert/cli.py``.  The TF
checkpoint is read by the port's own bundle reader (``convert/tf_bundle.py``),
without TensorFlow, so the command is the same on the CPU and on the card.
The output is ``torch.save`` of the InceptionI3D state dict, the port's
counterpart of the ``.msgpack``; a ``.pt`` input is taken as converted
already (for ``--dump-golden`` without converting again).  ``--dump-golden``
runs the model, on the card unless ``--device cpu``.

Not ported: reading a ``.msgpack`` (it needs flax's msgpack codec; ROADMAP.md
queue A item 12) and the torch-world models (item 10).
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping

import torch

TORCH_WORLD = ("r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34")


def save_weights(state: Mapping[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()}, path)


def load_weights(path: str, eval_type: str = "rgb") -> Dict[str, torch.Tensor]:
    """The I3D state dict at `path`: a ``.pt``/``.pth`` that
    :func:`save_weights` wrote, or a DeepMind TF checkpoint prefix,
    converted on load (`eval_type` 'rgb600': prefix-less names)."""
    path = str(path)
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: reading a .msgpack of Flax variables needs flax's msgpack codec "
            "(ROADMAP.md queue A item 12); convert the TF checkpoint to a .pt instead"
        )
    if path.endswith((".pt", ".pth")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict):
            raise ValueError(f"{path} holds a {type(state).__name__}, not a state dict")
        return state
    from .tf_i3d import convert_i3d_checkpoint

    return convert_i3d_checkpoint(path, eval_type=eval_type)


def convert(model_name: str, ckpt_path: str, eval_type: str = "rgb") -> Dict[str, torch.Tensor]:
    if model_name in TORCH_WORLD:
        raise NotImplementedError(
            f"{model_name}: the torch-world models and their conversion are ROADMAP.md queue A item 10"
        )
    return load_weights(ckpt_path, eval_type=eval_type)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", choices=["i3d", *TORCH_WORLD])
    p.add_argument(
        "ckpt",
        help="TF checkpoint prefix (i3d), or an already-converted .pt (for --dump-golden "
        "without converting again)",
    )
    p.add_argument("--out", help="output .pt path")
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
        save_weights(state, args.out)
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

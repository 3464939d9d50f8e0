"""The system under test, set up as its runners set it up.

Everything of the port that the harness touches goes through here: the
victim (``models.registry.create_model``) with the harness's seeded weights,
the ``AttackEngine`` with the spec, configuration and runtime flags of the
runner that sends a mix (``runners.universal``, ``runners.single_video``,
``runners.torch_universal``, ``runners.torch_per_video``), and the launch
counters and kernel names of ``ops``.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def victim(cfg: Dict, device, seed: int):
    """(the frozen victim on `device`, the seeded state dict it holds)."""
    from flickering_adversarial_video_tpu_torch.models.registry import create_model

    from . import weights

    model, _ = create_model(cfg["model"], num_classes=cfg["num_classes"],
                            compute_dtype=DTYPES[cfg["compute_dtype"]], device=device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = weights.draw(shapes, cfg["init"], seed, device)
    model.load_state_dict(sd)
    model.eval()
    return model, sd


def engine(cfg: Dict, attack: Dict, model, frames: int):
    """The AttackEngine of a runner: `attack` holds its settings (the
    traffic file's ``attack``)."""
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec, TorchStyleFlickerSpec
    from flickering_adversarial_video_tpu_torch.engine import AttackConfig, AttackEngine

    if cfg["world"] == "tanh":
        spec, config = FlickerSpec(frames), AttackConfig(margin=attack["margin"])
    else:
        spec = TorchStyleFlickerSpec(frames=frames, max_norm=attack["max_norm"])
        config = AttackConfig(margin=attack["margin"], norm_world="meanstd",
                              reg_weighting="torch")
    return AttackEngine(model, spec, config, track_probs=attack["track_probs"])


def flags(attack: Dict):
    from flickering_adversarial_video_tpu_torch.engine import RuntimeFlags

    return RuntimeFlags(beta0=attack["beta0"], beta1=attack["beta1"], beta2=attack["beta2"],
                        beta3=attack["beta3"], learning_rate=attack["learning_rate"],
                        max_norm=attack.get("max_norm", 1.0))


def build_kernels() -> None:
    """Build (or find built) and load the port's CUDA kernels."""
    from flickering_adversarial_video_tpu_torch.ops import kernels

    kernels.library()


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' host launch counts, by kernel tag."""
    from flickering_adversarial_video_tpu_torch import ops

    return {name.split()[0]: n for name, n in ops.launch_counts().items()}


def kernel_symbols() -> Dict[str, tuple]:
    """The port's kernel names, by the C launcher that starts them."""
    from flickering_adversarial_video_tpu_torch.ops import kernels

    return dict(kernels.KERNEL_SYMBOLS)

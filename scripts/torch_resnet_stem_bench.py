"""Time the video ResNets' stem in its two forms, and their attack step, on
the card.

    python3 scripts/torch_resnet_stem_bench.py

The stem's first conv of a video ResNet (C_in 3, a (kt,7,7) kernel, stride
(1,2,2), pads (kt//2,3,3)) has two faithful forms: the plain conv
(``models/video_resnet.stem_conv_plain``) and the JAX package's
space-to-depth form (``stem_conv_packed``: C_in 12, a (kt,4,4) stride-1
kernel, pads (2,1)), which the port's model takes on an even H and W.  For
each variant at its reference cell (r3d_18 B=16, mc3_18 B=20, r2plus1d_18
B=16, each 16x112x112; r2plus1d_34 B=16, 32x112x112; bf16, seeded
torchvision-layout weights) this script times each form's forward and its
forward with the input gradient (CUDA events), checks that the two agree,
and times the graphed attack step (``AttackEngine.train_steps``, the
mean/std world) with each form, in turns, so that the share of the step the
stem takes can be read beside it.  Needs one CUDA card; builds no kernel of
the port.
"""

from __future__ import annotations

import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec  # noqa: E402
from flickering_adversarial_video_tpu_torch.convert import video_resnet_state_dict  # noqa: E402
from flickering_adversarial_video_tpu_torch.engine import (  # noqa: E402
    AttackConfig, AttackEngine, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.models import video_resnet  # noqa: E402

CELLS = (("r3d_18", 16, 16), ("mc3_18", 20, 16), ("r2plus1d_18", 16, 16), ("r2plus1d_34", 16, 32))
SIZE = 112


def cuda_ms(fn, iters=5, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    plain_forward = video_resnet.stem_conv_plain
    for variant, b, t in CELLS:
        state = {k: torch.from_numpy(v) for k, v in video_resnet_state_dict(variant, 400, 0).items()}
        model = video_resnet.VideoResNet(variant, 400, torch.bfloat16, device=dev)
        model.load_state_dict(state)
        w = model.stem[0].weight
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, t, SIZE, SIZE, 3, generator=gen, device=dev).bfloat16()
        y = video_resnet.stem_conv_packed(x, w)
        g = torch.randn(y.shape, generator=gen, device=dev).bfloat16()
        err = (y.float() - plain_forward(x, w).float()).abs().max().item()

        def fwd(form):
            def run():
                with torch.no_grad():
                    form(x, w)
            return run

        def fwd_dgrad(form):
            def run():
                xx = x.detach().requires_grad_(True)
                form(xx, w).backward(g)
            return run

        row = {}
        for name, form in (("packed", video_resnet.stem_conv_packed), ("plain", plain_forward)):
            row[name] = (cuda_ms(fwd(form)), cuda_ms(fwd_dgrad(form)))
        print(f"[stem] {variant} x {list(x.shape)} -> {list(y.shape)}: packed forward "
              f"{row['packed'][0]:.3f} ms, with the input gradient {row['packed'][1]:.3f} ms; "
              f"plain forward {row['plain'][0]:.3f} ms, with the input gradient "
              f"{row['plain'][1]:.3f} ms; forms differ by {err:.3e} (bf16)", flush=True)

        rng = np.random.default_rng(1)
        batch = {"video": torch.from_numpy(rng.integers(0, 256, (b, t, SIZE, SIZE, 3),
                                                        dtype=np.uint8)).to(dev),
                 "labels": torch.from_numpy(rng.integers(0, 400, (b,))).to(dev)}
        flags = RuntimeFlags(max_norm=0.1)
        steps = {}
        for name in ("packed", "plain", "packed", "plain"):
            # the model's stem forward, or the plain form in its place
            patch = (mock.patch.object(video_resnet.StemConv, "forward",
                                       lambda self, xx: plain_forward(xx, self.weight))
                     if name == "plain" else mock.patch.dict(os.environ))
            with patch:
                engine = AttackEngine(model, TorchStyleFlickerSpec(t, max_norm=0.1),
                                      AttackConfig(norm_world="meanstd", reg_weighting="torch"),
                                      track_probs=False)
                state = engine.init_state()
                steps.setdefault(name, []).append(
                    cuda_ms(lambda: engine.train_steps(state, batch, flags, 1), iters=5, warmup=1))
            del engine, state
            torch.cuda.empty_cache()
        best = {k: min(v) for k, v in steps.items()}
        print(f"[step] {variant} B={b} T={t} {SIZE}x{SIZE} bf16, graphed: packed stem "
              f"{steps['packed']} ms, plain stem {steps['plain']} ms; the plain stem's forward "
              f"and input gradient {row['plain'][1] / best['plain']:.1%} of its step, the packed "
              f"{row['packed'][1] / best['packed']:.1%} of its", flush=True)
        del model, x, y, g, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

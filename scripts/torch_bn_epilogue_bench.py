"""Time the video ResNets' batch-norm epilogue kernel B12 alone on one NVIDIA GPU.

    python3 scripts/torch_bn_epilogue_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and prints B12's ptxas lines.  At layer1's [16,16,56,56,144] (the
r2plus1d_18 step of a B=16, 16x112x112 batch: the (1,3,3) conv's 144
channels) it holds B12's forward and backward bit-equal to their plain
versions in bf16 and f32 for each epilogue (batch-norm + ReLU, batch-norm
alone, batch-norm + residual + ReLU) and prints each one's time by CUDA
events beside its bound (bytes: each input read once, each output written
once, at 3.35 TB/s), the plain version's time and the autograd chain the
kernel replaced (the plain forward, then its backward by autograd).  Then it
profiles eager r2plus1d_18 train steps at B=16, 16x112x112, bf16, and prints
B12's device time and launches a step, beside the step's other kernels.  No
single PyTorch call computes the same function.  Ends with the card's name
and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES = 3.35e12
LAYER1 = (16, 16, 56, 56, 144)
# (name, residual added, ReLU)
EPILOGUES = (("bn+relu", False, True), ("bn", False, False), ("bn+residual+relu", True, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.ops import bn_epilogue as be
    from flickering_adversarial_video_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    lib = kernels.build()
    kernels.library()
    lines = (lib.parent / "nvcc.log").read_text(errors="replace").splitlines()
    for i, line in enumerate(lines[:-1]):
        if "Compiling entry function" in line and "bn_epilogue" in line:
            said = "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                             if "Used" in x or "spill" in x)
            print(f"[ptxas] {line.split(chr(39))[1]}: {said}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def cuda_ms(fn, iters):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    c = LAYER1[-1]
    mean = torch.randn(c, device=dev, generator=gen) * 0.1
    var = torch.rand(c, device=dev, generator=gen) + 0.5
    weight = torch.rand(c, device=dev, generator=gen) + 0.5
    bias = torch.randn(c, device=dev, generator=gen) * 0.1
    mul = torch.rsqrt(var + 1e-5) * weight
    for dtype in (torch.bfloat16, torch.float32):
        x, res, g = (torch.randn(LAYER1, device=dev, generator=gen).to(dtype) for _ in range(3))
        isz = x.element_size()
        for name, residual, relu in EPILOGUES:
            r = res if residual else None
            y = be.bn_epilogue_fwd(x, mean, mul, bias, r, relu)
            ok = torch.equal(bits(y), bits(be.bn_epilogue_fwd_plain(x, mean, mul, bias, r, relu)))
            saved = y if relu else None
            dx, dres = be.bn_epilogue_bwd(g, mul, saved, residual)
            wdx, wdres = be.bn_epilogue_bwd_plain(g, mul, saved, residual)
            ok = ok and torch.equal(bits(dx), bits(wdx)) and (
                not residual or torch.equal(bits(dres), bits(wdres)))
            n = x.numel()
            fwd_bound = (2 + residual) * n * isz / PEAK_BYTES * 1e3
            bwd_bound = (2 + relu + (residual and relu)) * n * isz / PEAK_BYTES * 1e3
            fwd_ms = cuda_ms(lambda: be.bn_epilogue_fwd(x, mean, mul, bias, r, relu), args.iters)
            bwd_ms = cuda_ms(lambda: be.bn_epilogue_bwd(g, mul, saved, residual), args.iters)
            pf = cuda_ms(lambda: be.bn_epilogue_fwd_plain(x, mean, mul, bias, r, relu), 3)
            pb = cuda_ms(lambda: be.bn_epilogue_bwd_plain(g, mul, saved, residual), 3)

            def chain():
                xa = x.detach().requires_grad_(True)
                ra = res.detach().requires_grad_(True) if residual else None
                be.bn_epilogue_fwd_plain(xa, mean, mul, bias, ra, relu).backward(g)

            chain_ms = cuda_ms(chain, 3)
            print(f"[time] B12 {name} {str(dtype)[6:]} {list(LAYER1)}: "
                  f"{'bit-equal' if ok else 'NOT bit-equal'}; forward {fwd_ms:.3f} ms (bound "
                  f"{fwd_bound:.3f}, {fwd_bound / fwd_ms:.1%}), plain {pf:.3f}; backward "
                  f"{bwd_ms:.3f} ms (bound {bwd_bound:.3f}, {bwd_bound / bwd_ms:.1%}), plain "
                  f"{pb:.3f}; both {fwd_ms + bwd_ms:.3f} against the autograd chain "
                  f"{chain_ms:.3f} ms", flush=True)
            if not ok:
                sys.exit(1)
        del x, res, g

    # ---- an eager r2plus1d_18 train step at B=16, 16x112x112 -----------------
    from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
    from flickering_adversarial_video_tpu_torch.convert import video_resnet_state_dict
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.models.video_resnet import VideoResNet

    model = VideoResNet("r2plus1d_18", 400, torch.bfloat16, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           video_resnet_state_dict("r2plus1d_18", 400, 0).items()})
    engine = AttackEngine(model, TorchStyleFlickerSpec(16),
                          AttackConfig(norm_world="meanstd", reg_weighting="torch"))
    video = torch.randint(0, 256, (16, 16, 112, 112, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    args_ = engine.prepare_batch({"video": video, "labels": torch.zeros(16, dtype=torch.long,
                                                                        device=dev)})
    state = engine.init_state()
    for _ in range(2):
        engine._train_step(state, *args_, RuntimeFlags())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            engine._train_step(state, *args_, RuntimeFlags())
        torch.cuda.synchronize()
    sums = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if t and e.key not in {"ProfilerStep*"}:
            key = ("B12f" if "bn_epilogue_fwd_kernel" in e.key else
                   "B12b" if "bn_epilogue_bwd_kernel" in e.key else None)
            if key:
                n0, t0 = sums.get(key, (0, 0.0))
                sums[key] = (n0 + e.count, t0 + t / 1e3)
    for key, (n, ms) in sorted(sums.items()):
        print(f"[profile] eager r2plus1d_18 step, B=16 16x112x112 bf16: {key} "
              f"{ms / args.steps:.3f} ms/step in {n / args.steps:.0f} launches/step")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"[card] {smi.stdout.strip()}")


if __name__ == "__main__":
    main()

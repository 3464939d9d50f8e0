"""Time the port's temporal combine kernel B2 alone on one NVIDIA GPU.

    python3 scripts/torch_stem_combine_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and, at every distinct combine shape of a B=8, T=64, 224x224 I3D train step
(Conv3d_2c and the two 3x3x3 convs of each Mixed block: 19 launches), the
stem's own 4-tap dgrad (which ``USE_PALLAS_FUSED`` adds) and the shapes of
the single-video clip (B=1, T=90), holds B2 against its plain PyTorch
version in bf16 and f32 (tolerance 0) and prints its time by CUDA events
and its device time under torch.profiler (the events time the host's
dispatch, not the kernel, where a launch takes a few microseconds) beside
its bound (bytes: ``part`` read once, dx written once, at the card's memory
rate) and the plain version's time.  Sums the 19 launches of a B=8 step.
No single PyTorch call computes the same function.  Ends with the card's
name and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES = 3.35e12
# (name, [B,T,H,W] of the conv's input, Cin, taps): the KT = 3 convs of a
# B=8, T=64, 224x224 step, one launch each (t_plo 1), and the packed stem
STEP_SHAPES = [("Conv3d_2c", (8, 32, 56, 56), 64, 3)] + [
    (f"Mixed_{block} Branch_{branch}", dims, cin, 3)
    for block, dims, cins in (("3b", (8, 32, 28, 28), (96, 16)), ("3c", (8, 32, 28, 28), (128, 32)),
                              ("4b", (8, 16, 14, 14), (96, 16)), ("4c", (8, 16, 14, 14), (112, 24)),
                              ("4d", (8, 16, 14, 14), (128, 24)), ("4e", (8, 16, 14, 14), (144, 32)),
                              ("4f", (8, 16, 14, 14), (160, 32)), ("5b", (8, 8, 7, 7), (160, 32)),
                              ("5c", (8, 8, 7, 7), (192, 48)))
    for branch, cin in zip((1, 2), cins)]
STEM = ("stem dgrad", (8, 32, 112, 112), 24, 4)
SV_SHAPES = [("single-video Conv3d_2c", (1, 45, 56, 56), 64, 3),
             ("single-video Mixed_3c Branch_1", (1, 45, 28, 28), 128, 3),
             ("single-video Mixed_4c Branch_1", (1, 23, 14, 14), 112, 3),
             ("single-video Mixed_5b Branch_1", (1, 12, 7, 7), 160, 3),
             ("single-video stem dgrad", (1, 45, 112, 112), 24, 4)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.ops import kernels, stem_combine

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    lib = kernels.build()
    kernels.library()
    lines = (lib.parent / "nvcc.log").read_text(errors="replace").splitlines()
    for i, line in enumerate(lines[:-1]):
        if "Compiling entry function" in line and "temporal_combine" in line:
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

    def device_ms(fn, iters):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if "temporal_combine_kernel" in e.key)
        return us / 1e3 / iters if us else float("nan")

    step = [0.0, 0.0, 0.0]  # events, device, bound
    for name, dims, cin, taps in STEP_SHAPES + [STEM] + SV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            part = torch.randn(*dims, taps * cin, generator=gen, device=dev).to(dtype)
            got = stem_combine.temporal_combine(part, cin, 1)
            torch.cuda.synchronize()
            ok = torch.equal(got, stem_combine.temporal_combine_plain(part, cin, 1))
            print(f"[check] B2 {name} {list(part.shape)} {str(dtype)[6:]:8s} "
                  f"{'bit-equal' if ok else 'DIFFERS'} (tolerance 0)", flush=True)
            if not ok:
                sys.exit(f"B2 differs from its plain version at {name} {dtype}")
        def fn():
            return stem_combine.temporal_combine(part, cin, 1)

        ms, dev_ms = cuda_ms(fn, args.iters), device_ms(fn, args.iters)
        plain = cuda_ms(lambda: stem_combine.temporal_combine_plain(part, cin, 1), 3)
        bound = part.numel() * (taps + 1) // taps * 2 / PEAK_BYTES * 1e3
        if (name, dims, cin, taps) in STEP_SHAPES:
            for i, v in enumerate((ms, dev_ms, bound)):
                step[i] += v
        print(f"[time] B2 {name} {list(part.shape)} Cin {cin} bf16: {ms:.4f} ms by CUDA events, "
              f"{dev_ms:.4f} ms device time under torch.profiler (bound {bound:.4f} ms, bytes; "
              f"{bound / dev_ms:.1%} of it), plain {plain:.4f} ms", flush=True)
    print(f"[time] B2 a B=8 step (the {len(STEP_SHAPES)} launches): {step[0]:.4f} ms by CUDA "
          f"events, {step[1]:.4f} ms device time (bound {step[2]:.4f} ms; "
          f"{step[2] / step[1]:.1%} of it)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

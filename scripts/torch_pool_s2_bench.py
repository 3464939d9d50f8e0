"""Time the port's strided (1,3,3)/(1,2,2) pool backward B6 alone on one
NVIDIA GPU, and the two pool routes of MaxPool3d_2a and 3a.

    python3 scripts/torch_pool_s2_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and holds B6 against its plain PyTorch version (tolerance 0, bf16 and f32, on
random, integer-tie and NaN/-inf grids) at the three strided pools of a B=8,
T=64, 224x224 I3D train step (MaxPool3d_2a, 3a and the spatial half of 4a),
the three of the single-video clip (B=1, T=90) and three edge geometries.  It
prints B6's time by CUDA events at the step and single-video shapes beside
its bound (bytes: x and dy read, dx written, at the card's memory rate), the
three step shapes summed (one B=8 step) and under torch.profiler, and ATen's
``max_pool3d_with_indices_backward`` at 2a (channels_last_3d, fed dy, x
padded by one -inf row and column and the int64 indices of ``F.max_pool3d``
on it: a yardstick that needs those indices, writes a padded dx and routes a
NaN window by another rule).  Then, at 2a and 3a, the kernel time of the two
routes: B5 forward + B6 backward, and the index pair B9 forward + backward.
Ends with the card's name and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES = 3.35e12
# the input of each strided pool at B=8, T=64, 224x224 and of the single-video clip
STEP_SHAPES = {"MaxPool3d_2a": (8, 32, 112, 112, 64), "MaxPool3d_3a": (8, 32, 56, 56, 192),
               "MaxPool3d_4a spatial": (8, 32, 28, 28, 480)}
SV_SHAPES = ((1, 45, 112, 112, 64), (1, 45, 56, 56, 192), (1, 45, 28, 28, 480))
# one window (pads in both axes); 3 window rows of 5; the scalar channel tail
EDGE_SHAPES = ((1, 3, 2, 2, 8), (2, 3, 6, 10, 40), (2, 1, 4, 6, 13))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.ops import kernels, pool_strided as ps

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    lib = kernels.build()
    kernels.library()
    lines = (lib.parent / "nvcc.log").read_text(errors="replace").splitlines()
    for i, line in enumerate(lines[:-1]):
        if "Compiling entry function" in line and "pool_s2_bwd" in line:
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

    def device_ms(fns, symbol, iters):
        """Device time a round of `fns` under torch.profiler, of kernels named `symbol`."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if symbol in e.key)
        return us / 1e3 / iters if us else float("nan")

    def inputs(shape, dtype, grid):
        b, t, h, w, c = shape
        pooled = (b, t, h // 2, w // 2, c)
        if grid == "random":
            x = torch.randn(shape, generator=gen, device=dev)
            dy = torch.randn(pooled, generator=gen, device=dev)
        else:
            x = torch.randint(0, 3, shape, generator=gen, device=dev).float()
            dy = torch.randint(-8 if grid == "ties" else 1, 9, pooled, generator=gen, device=dev).float()
        if grid == "NaN/-inf":
            spots = torch.randint(0, x.numel(), (max(1, x.numel() // 1000),), generator=gen, device=dev)
            x.view(-1)[spots] = float("nan")
            x[:, :, h // 2:, w // 2:] = float("-inf")
        return x.to(dtype), dy.to(dtype)

    def check(shape, dtype, grid):
        x, dy = inputs(shape, dtype, grid)
        got = ps.pool133_s2_bwd(x, dy)
        torch.cuda.synchronize()
        want = ps.pool133_s2_bwd_plain(x, dy)
        err = (got.float() - want.float()).abs().max().item()
        print(f"[check] B6 {list(shape)} {str(dtype)[6:]:8s} {grid:8s} max_abs_err {err:.3e} "
              f"(tolerance 0)", flush=True)
        if not torch.equal(got, want):
            sys.exit(f"B6 differs from its plain version at {shape} {dtype} ({grid})")
        del got, want
        return x, dy

    for shape in EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for grid in ("random", "ties", "NaN/-inf"):
                check(shape, dtype, grid)

    step_ms, step_bound, step_fns = 0.0, 0.0, []
    named = list(STEP_SHAPES.items()) + [(f"single-video T'={s[1]}", s) for s in SV_SHAPES]
    for name, shape in named:
        for dtype in (torch.float32, torch.bfloat16):
            for grid in ("ties", "NaN/-inf", "random"):
                x, dy = check(shape, dtype, grid)
            ms = cuda_ms(lambda: ps.pool133_s2_bwd(x, dy), args.iters)
            isz = x.element_size()
            bound = (x.numel() * 2 + dy.numel()) * isz / PEAK_BYTES * 1e3
            if name in STEP_SHAPES and dtype == torch.bfloat16:
                step_ms, step_bound = step_ms + ms, step_bound + bound
                step_fns.append(lambda x=x, dy=dy: ps.pool133_s2_bwd(x, dy))
            else:
                del x, dy
            print(f"[time] B6 {name} {list(shape)} {str(dtype)[6:]}: {ms:.4f} ms (bound "
                  f"{bound:.4f} ms, bytes; {bound / ms:.1%} of it)", flush=True)
    dev_step = device_ms(step_fns, "pool_s2_bwd_kernel", args.iters)
    print(f"[time] B6 a B=8 step (2a, 3a, 4a spatial, one launch each) bf16: {step_ms:.4f} ms "
          f"by CUDA events, {dev_step:.4f} ms device time under torch.profiler (bound "
          f"{step_bound:.4f} ms; {step_bound / step_ms:.1%} of it)", flush=True)
    del step_fns

    for name in ("MaxPool3d_2a", "MaxPool3d_3a"):
        shape = STEP_SHAPES[name]
        x, dy = inputs(shape, torch.bfloat16, "random")
        ms5 = cuda_ms(lambda: ps.pool133_s2_fwd(x), args.iters)
        ms6 = cuda_ms(lambda: ps.pool133_s2_bwd(x, dy), args.iters)
        idx = ps.pool133_s2_pair_fwd(x)[1]
        ms9f = cuda_ms(lambda: ps.pool133_s2_pair_fwd(x), args.iters)
        ms9b = cuda_ms(lambda: ps.pool133_s2_pair_bwd(idx, dy), args.iters)
        faster = "B5 + B6" if ms5 + ms6 < ms9f + ms9b else "the pair B9"
        print(f"[route] {name} {list(shape)} bf16: B5 {ms5:.4f} + B6 {ms6:.4f} = "
              f"{ms5 + ms6:.4f} ms; B9 forward {ms9f:.4f} + backward {ms9b:.4f} = "
              f"{ms9f + ms9b:.4f} ms; faster by kernel time: {faster}", flush=True)
        if name == "MaxPool3d_2a":
            # ATen's indexed backward on x padded by one -inf row and column
            # (the (0,1) pads), channels_last_3d
            xp = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1, 0, 1), value=float("-inf")).contiguous(
                memory_format=torch.channels_last_3d)
            idx6 = F.max_pool3d(xp, (1, 3, 3), (1, 2, 2), return_indices=True)[1]
            dyc = dy.permute(0, 4, 1, 2, 3)
            lib6 = cuda_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                dyc, xp, [1, 3, 3], [1, 2, 2], [0, 0, 0], [1, 1, 1], False, idx6), args.iters)
            print(f"[time] B6 {list(shape)} bf16: {ms6:.4f} ms; ATen "
                  f"max_pool3d_with_indices_backward (channels_last_3d, x padded by one -inf "
                  f"row and column, fed F.max_pool3d's int64 indices, writes the padded dx; "
                  f"another NaN rule) {lib6:.4f} ms", flush=True)
            del xp, idx6, dyc
        del x, dy, idx
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

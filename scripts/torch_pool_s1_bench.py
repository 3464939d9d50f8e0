"""Time the port's stride-1 3x3x3 pool kernels B3 (forward) and B4
(backward) alone on one NVIDIA GPU.

    python3 scripts/torch_pool_s1_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and, at the nine branch-pool shapes of a B=8, T=64, 224x224 I3D train step
(Mixed_3b .. Mixed_5c) and the three of the single-video clip (B=1, T=90),
holds B3 and B4 against their plain PyTorch versions in bf16 and f32
(tolerance 0; B3 also on an integer-tie grid and on a grid with NaNs and a
-inf block, NaN positions equal) and prints each kernel's time by CUDA
events and its device time under torch.profiler (the events time the
host's dispatch, not the kernel, where a launch takes a few microseconds)
beside its bound (bytes at the card's memory rate: B3 reads x and
writes y, B4 reads x and dy and writes dx) and, for B3, ``F.max_pool3d`` on
the same values in channels_last_3d.  Sums the nine shapes of each (one B=8
step).  Then at [8,32,28,28,192] bf16: each kernel's device time under
torch.profiler and the ATen backward ``max_pool3d_with_indices_backward``
fed the forward's int64 indices (a different function: it needs those
indices, and its NaN rule differs).  Ends with the card's name and power
limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES = 3.35e12
# the branch_3 pool's input of each Mixed block at B=8, T=64, 224x224
STEP_SHAPES = {
    "Mixed_3b": (8, 32, 28, 28, 192), "Mixed_3c": (8, 32, 28, 28, 256),
    "Mixed_4b": (8, 16, 14, 14, 480), "Mixed_4c": (8, 16, 14, 14, 512),
    "Mixed_4d": (8, 16, 14, 14, 512), "Mixed_4e": (8, 16, 14, 14, 512),
    "Mixed_4f": (8, 16, 14, 14, 528), "Mixed_5b": (8, 8, 7, 7, 832),
    "Mixed_5c": (8, 8, 7, 7, 832),
}
SV_SHAPES = ((1, 45, 28, 28, 192), (1, 23, 14, 14, 480), (1, 12, 7, 7, 832))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.ops import kernels, pool_s1

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    lib = kernels.build()
    kernels.library()
    lines = (lib.parent / "nvcc.log").read_text(errors="replace").splitlines()
    for i, line in enumerate(lines[:-1]):
        if "Compiling entry function" in line and "pool_s1_" in line:
            said = "; ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                             if "Used" in x or "spill" in x)
            kernel = line.split("'")[1]
            print(f"[ptxas] {kernel}: {said}")
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

    def device_ms(fn, symbol, iters):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if symbol in e.key)
        return us / 1e3 / iters if us else float("nan")

    def grid(shape, kind):
        if kind == "random":
            return torch.randn(shape, generator=gen, device=dev)
        x = torch.randint(0, 3, shape, generator=gen, device=dev).float()
        if kind == "NaN/-inf":
            spots = torch.randint(0, x.numel(), (max(1, x.numel() // 1000),), generator=gen, device=dev)
            x.view(-1)[spots] = float("nan")
            x[:, :, shape[2] // 2:, shape[3] // 2:] = float("-inf")
        return x

    def same(got, want):  # bit-equal, NaN where NaN
        nan = want.isnan()
        return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                             want.masked_fill(nan, 0))

    def check(shape, dtype):
        for kind in ("random", "integer ties", "NaN/-inf"):
            x = grid(shape, kind).to(dtype)
            ok = same(pool_s1.pool333_fwd(x), pool_s1.pool333_fwd_plain(x))
            print(f"[check] B3 {list(shape)} {str(dtype)[6:]:8s} {kind}: "
                  f"{'bit-equal' if ok else 'DIFFERS'} (tolerance 0)", flush=True)
            if not ok:
                sys.exit(f"B3 differs from its plain version at {shape} {dtype} ({kind})")
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got = pool_s1.pool333_bwd(x, dy)
        torch.cuda.synchronize()
        err = (got.float() - pool_s1.pool333_bwd_plain(x, dy).float()).abs().max().item()
        print(f"[check] B4 {list(shape)} {str(dtype)[6:]:8s} max_abs_err {err:.3e} (tolerance 0)",
              flush=True)
        if err != 0:
            sys.exit(f"B4 differs from its plain version at {shape} {dtype}")
        return x, dy

    step = {"B3": [0.0, 0.0, 0.0], "B4": [0.0, 0.0, 0.0]}  # events, device, bound
    for name, shape in list(STEP_SHAPES.items()) + [(f"single-video T'={s[1]}", s) for s in SV_SHAPES]:
        check(shape, torch.float32)
        x, dy = check(shape, torch.bfloat16)
        xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory: channels_last_3d
        lib3 = cuda_ms(lambda: F.max_pool3d(xc, 3, 1, 1), args.iters)
        for kernel, fn, n_bytes, symbol in (
            ("B3", lambda: pool_s1.pool333_fwd(x), 2, "pool_s1_fwd_kernel"),
            ("B4", lambda: pool_s1.pool333_bwd(x, dy), 3, "pool_s1_bwd_kernel"),
        ):
            ms, dev_ms = cuda_ms(fn, args.iters), device_ms(fn, symbol, args.iters)
            bound = n_bytes * x.numel() * 2 / PEAK_BYTES * 1e3
            if name in STEP_SHAPES:
                for i, v in enumerate((ms, dev_ms, bound)):
                    step[kernel][i] += v
            lib = f", F.max_pool3d (channels_last_3d) {lib3:.4f} ms" if kernel == "B3" else ""
            print(f"[time] {kernel} {name} {list(shape)} bf16: {ms:.4f} ms by CUDA events, "
                  f"{dev_ms:.4f} ms device time under torch.profiler (bound {bound:.4f} ms, "
                  f"bytes; {bound / dev_ms:.1%} of it){lib}", flush=True)
    for kernel, (ms, dev_ms, bound) in step.items():
        print(f"[time] {kernel} a B=8 step (the nine shapes): {ms:.4f} ms by CUDA events, "
              f"{dev_ms:.4f} ms device time (bound {bound:.4f} ms; {bound / dev_ms:.1%} of it)",
              flush=True)

    shape = STEP_SHAPES["Mixed_3b"]
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ms4 = cuda_ms(lambda: pool_s1.pool333_bwd(x, dy), args.iters)
    ms3 = cuda_ms(lambda: pool_s1.pool333_fwd(x), args.iters)
    dev4 = device_ms(lambda: pool_s1.pool333_bwd(x, dy), "pool_s1_bwd_kernel", args.iters)
    dev3 = device_ms(lambda: pool_s1.pool333_fwd(x), "pool_s1_fwd_kernel", args.iters)
    # the library yardsticks in channels_last_3d on the same values
    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory: channels_last_3d
    ycl, idx = F.max_pool3d(xc, 3, 1, 1, return_indices=True)
    dyc = dy.permute(0, 4, 1, 2, 3)
    lib3 = cuda_ms(lambda: F.max_pool3d(xc, 3, 1, 1), args.iters)
    lib4 = cuda_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
        dyc, xc, [3, 3, 3], [1, 1, 1], [1, 1, 1], [1, 1, 1], False, idx), args.iters)
    b3_bound = 2 * x.numel() * 2 / PEAK_BYTES * 1e3
    b4_bound = 3 * x.numel() * 2 / PEAK_BYTES * 1e3
    print(f"[time] B4 {list(shape)} bf16: {ms4:.4f} ms by CUDA events, {dev4:.4f} ms device time "
          f"under torch.profiler (bound {b4_bound:.4f} ms); ATen "
          f"max_pool3d_with_indices_backward (channels_last_3d, fed F.max_pool3d's int64 "
          f"indices; another NaN rule) {lib4:.4f} ms", flush=True)
    print(f"[time] B3 {list(shape)} bf16: {ms3:.4f} ms by CUDA events, {dev3:.4f} ms device time "
          f"(bound {b3_bound:.4f} ms); F.max_pool3d (channels_last_3d) {lib3:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

"""Check and time the port's strided (1,3,3)/(1,2,2) pool kernels on one
NVIDIA GPU: the forward B5, the backward B6, the index pair B9 (forward and
backward), and the two pool routes of MaxPool3d_2a and 3a.

    python3 scripts/torch_pool_s2_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and prints the ptxas register and spill lines of B5, B6 and B9 forward and
backward.  Holds each against its plain PyTorch version (tolerance 0, bf16 and f32, on
random, integer-tie and NaN/-inf grids; NaN where NaN) at the three strided
pools of a B=8, T=64, 224x224 I3D train step (MaxPool3d_2a, 3a and the
spatial half of 4a), the three of the single-video clip (B=1, T=90) and six
edge geometries: B5's y, B9 forward's y (equal to B5's) and index, its
null-index path (values only), B6's dx, and B9 backward's dx (equal to the
plain version's on the same index, and to B6's where x holds no NaN).
Prints each kernel's time by CUDA events at the step and single-video shapes
(B9 backward also at the edge shapes) beside its bound (bytes at the card's
memory rate: B5 x read and y written, B9 forward also one index byte an
output, B6 x and dy read and dx written, B9 backward the index and dy read and
dx written), the step's three launches
summed by CUDA events and under torch.profiler (device time; B5's also at
the single-video three, whose launches of 20-40 us CUDA events over a loop
time by the host's dispatch), and as
yardsticks ``F.max_pool3d`` on x padded by one -inf row and column
(channels_last_3d) beside B5 at the step shapes, and ATen's
``max_pool3d_with_indices_backward`` beside B6 at 2a (fed dy, the padded x
and the int64 indices of ``F.max_pool3d`` on it: it needs those indices,
writes a padded dx and routes a NaN window by another rule).  Then, at 2a and
3a, the kernel time of the two routes: B5 forward + B6 backward, and the
index pair B9 forward + backward.  Ends with the card's name and power
limit.  Exits non-zero without CUDA.
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
# one window (pads in both axes); 3 window rows of 5; the scalar channel tail;
# W' = 1; H' = 17 in runs of 5; C = 40 over 112 window columns, in 2 (bf16)
# or 3 (f32) groups of channel vectors
EDGE_SHAPES = ((1, 3, 2, 2, 8), (2, 3, 6, 10, 40), (2, 1, 4, 6, 13), (2, 3, 10, 2, 8),
               (1, 1, 34, 8, 8), (1, 3, 8, 224, 40))
KERNELS = ("pool_s2_fwd", "pool_s2_bwd", "pool_pair_fwd", "pool_pair_bwd")


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
        if "Compiling entry function" in line and any(k in line for k in KERNELS):
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

    def same(got, want):
        """Bit-equal, NaN where NaN."""
        nan = want.isnan()
        return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                             want.masked_fill(nan, 0))

    def check(shape, dtype, grid):
        x, dy = inputs(shape, dtype, grid)
        y5 = ps.pool133_s2_fwd(x)
        y9, idx = ps.pool133_s2_pair_fwd(x)
        canary = torch.full((y9.numel(),), 171, dtype=torch.uint8, device=dev)
        y0, none = ps.pool133_s2_pair_fwd(x, want_idx=False)
        dx = ps.pool133_s2_bwd(x, dy)
        dx9 = ps.pool133_s2_pair_bwd(idx, dy)
        torch.cuda.synchronize()
        want_y, want_idx = ps.pool133_s2_pair_fwd_plain(x)
        ok = {"B5": same(y5, ps.pool133_s2_fwd_plain(x)),
              "B9 forward": (same(y9, want_y) and torch.equal(idx, want_idx) and same(y9, y5)
                             and none is None and same(y0, y9)
                             and bool((canary == 171).all())),
              "B6": torch.equal(dx, ps.pool133_s2_bwd_plain(x, dy)),
              # B6 and B9 route a window holding a NaN by different rules
              "B9 backward": (same(dx9, ps.pool133_s2_pair_bwd_plain(want_idx, dy))
                              and (grid == "NaN/-inf" or torch.equal(dx9, dx)))}
        keep = want_y.isfinite()
        err5 = (y5.float() - want_y.float())[keep].abs().max().item() if keep.any() else 0.0
        print(f"[check] {list(shape)} {str(dtype)[6:]:8s} {grid:8s}: B5 y "
              f"{'bit-equal' if ok['B5'] else 'DIFFERS'} (finite max_abs_err {err5:.3e}); B9 "
              f"forward y, index, y against B5, null index {'equal' if ok['B9 forward'] else 'DIFFER'}"
              f" (indices used {sorted(idx.unique().tolist())}); B6 dx "
              f"{'bit-equal' if ok['B6'] else 'DIFFERS'}; B9 backward dx "
              f"{'bit-equal' if ok['B9 backward'] else 'DIFFERS'} (tolerance 0)", flush=True)
        for name, good in ok.items():
            if not good:
                sys.exit(f"{name} differs from its plain version at {shape} {dtype} ({grid})")
        del y5, y9, idx, canary, y0, dx, dx9, want_y, want_idx
        return x, dy

    for shape in EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for grid in ("random", "ties", "NaN/-inf"):
                x, dy = check(shape, dtype, grid)
        # B9 backward at the edge shapes (bf16): launches of a few us, so
        # CUDA events here time the launch more than the kernel
        idx = ps.pool133_s2_pair_fwd(x)[1]
        ms = cuda_ms(lambda: ps.pool133_s2_pair_bwd(idx, dy), args.iters)
        bound = (dy.numel() * (1 + 4) * x.element_size() + dy.numel()) / PEAK_BYTES * 1e3
        print(f"[time] B9 backward edge {list(shape)} bfloat16: {ms:.4f} ms (bound {bound:.6f} ms, "
              f"bytes)", flush=True)
        del x, dy, idx

    # events ms, bound ms, launches: a B=8 step's three, and B5's three at B=1, T=90
    step = {k: [0.0, 0.0, []] for k in ("B5", "B6", "B5 single-video")}
    named = list(STEP_SHAPES.items()) + [(f"single-video T'={s[1]}", s) for s in SV_SHAPES]
    for name, shape in named:
        for dtype in (torch.float32, torch.bfloat16):
            for grid in ("ties", "NaN/-inf", "random"):
                x, dy = check(shape, dtype, grid)
            isz, n_y = x.element_size(), dy.numel()
            runs = {
                "B5": (lambda x=x: ps.pool133_s2_fwd(x), (x.numel() + n_y) * isz),
                "B9 forward": (lambda x=x: ps.pool133_s2_pair_fwd(x),
                               (x.numel() + n_y) * isz + n_y),
                "B6": (lambda x=x, dy=dy: ps.pool133_s2_bwd(x, dy), (x.numel() * 2 + n_y) * isz),
                "B9 backward": (lambda i=ps.pool133_s2_pair_fwd(x)[1], dy=dy:
                                ps.pool133_s2_pair_bwd(i, dy), (x.numel() + n_y) * isz + n_y),
            }
            for kname, (fn, nbytes) in runs.items():
                ms = cuda_ms(fn, args.iters)
                bound = nbytes / PEAK_BYTES * 1e3
                print(f"[time] {kname} {name} {list(shape)} {str(dtype)[6:]}: {ms:.4f} ms (bound "
                      f"{bound:.4f} ms, bytes; {bound / ms:.1%} of it)", flush=True)
                key = kname if name in STEP_SHAPES else f"{kname} single-video"
                if dtype == torch.bfloat16 and key in step:
                    step[key][0] += ms
                    step[key][1] += bound
                    step[key][2].append(fn)
            if name in STEP_SHAPES and dtype == torch.bfloat16:
                # F.max_pool3d on x padded by one -inf row and column, channels_last_3d
                xp = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1, 0, 1), value=float("-inf")).contiguous(
                    memory_format=torch.channels_last_3d)
                lib5 = cuda_ms(lambda: F.max_pool3d(xp, (1, 3, 3), (1, 2, 2)), args.iters)
                print(f"[time] B5 {name} {list(shape)} bf16: F.max_pool3d (channels_last_3d, x "
                      f"padded by one -inf row and column) {lib5:.4f} ms", flush=True)
                del xp
            del x, dy, runs
    for key, symbol in (("B5", "pool_s2_fwd_kernel"), ("B6", "pool_s2_bwd_kernel"),
                        ("B5 single-video", "pool_s2_fwd_kernel")):
        ms, bound, fns = step[key]
        dev_step = device_ms(fns, symbol, args.iters)
        which = "a B=1, T=90 step" if "single" in key else "a B=8 step"
        print(f"[time] {key.split()[0]} {which} (2a, 3a, 4a spatial, one launch each) bf16: "
              f"{ms:.4f} ms by CUDA events, {dev_step:.4f} ms device time under torch.profiler "
              f"(bound {bound:.4f} ms; {bound / dev_step:.1%} of it)", flush=True)
    del step

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

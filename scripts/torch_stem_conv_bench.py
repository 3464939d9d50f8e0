"""Time the port's stem kernel B1 alone on one NVIDIA GPU.

    python3 scripts/torch_stem_conv_bench.py [--iters N]

Builds the port's CUDA kernels (``flickering_adversarial_video_tpu_torch/csrc``)
and, at the two shapes the main paths give B1 -- x [8,32,112,112,24] (the
universal and class-gen step) and [1,45,112,112,24] (the single-video clip)
-- holds the bf16 kernel against its plain PyTorch version (max relative
error, tolerance 1e-2) and prints its time by CUDA events beside its bound
(operations at the card's bf16 peak, or bytes at its memory rate), the plain
version's time, ``F.conv3d`` on the same padded input (the conv alone, no BN
or relu) and the kernel's own device time under torch.profiler.  Ends with
the card's name and power limit.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
SHAPES = ((8, 32, 112, 112, 24), (1, 45, 112, 112, 24))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.ops import kernels, stem_conv

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

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

    def in_range(n, lo, taps):
        return sum(sum(1 for m in range(taps) if 0 <= i + m - lo < n) for i in range(n))

    for shape in SHAPES:
        b, t, h, w, _ = shape
        x = (torch.randint(0, 256, shape, generator=gen).float() / 128 - 1).to(dev, torch.bfloat16)
        pk = (torch.randn(4, 4, 4, 24, 64, generator=gen) * 0.05).to(dev, torch.bfloat16)
        bn = (torch.randn(64, generator=gen).to(dev), (torch.randn(64, generator=gen).abs() + 0.5).to(dev),
              torch.randn(64, generator=gen).to(dev))
        got = stem_conv.stem_conv_bn_relu(x, pk, *bn)
        want = stem_conv.stem_conv_bn_relu_plain(x, pk, *bn)
        rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        del got, want
        macs = 24 * 64 * b * in_range(t, 1, 4) * in_range(h, 1, 4) * in_range(w, 1, 4)
        nbytes = x.numel() * 2 + pk.numel() * 2 + x.numel() // 24 * 64 * 2 + 3 * 64 * 4
        t_ops, t_bytes = 2 * macs / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms = cuda_ms(lambda: stem_conv.stem_conv_bn_relu(x, pk, *bn), args.iters)
        plain_ms = cuda_ms(lambda: stem_conv.stem_conv_bn_relu_plain(x, pk, *bn), 3)
        xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 2) * 3)
        w1 = stem_conv.pk_to_oidhw(pk).contiguous(memory_format=torch.channels_last_3d)
        lib_ms = cuda_ms(lambda: F.conv3d(xp, w1), args.iters)
        del xp
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                stem_conv.stem_conv_bn_relu(x, pk, *bn)
            torch.cuda.synchronize()
        dev_us = [getattr(e, "self_device_time_total", 0) / e.count for e in prof.key_averages()
                  if "stem_conv_bf16_kernel" in e.key]
        bound = max(t_ops, t_bytes)
        print(f"[B1] x {list(shape)} bf16: {ms:.3f} ms by CUDA events "
              f"({'%.3f ms' % (dev_us[0] / 1e3) if dev_us else 'not measured'} by the profiler); "
              f"bound {bound:.3f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
              f"{2 * macs / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB; {bound / ms:.1%} of it); "
              f"F.conv3d {lib_ms:.3f} ms; plain {plain_ms:.3f} ms; max_rel_err {rel:.2e} "
              f"(tolerance 1e-2)", flush=True)
        if not rel <= 1e-2:
            sys.exit(f"B1 disagrees with its plain version at {shape}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)


if __name__ == "__main__":
    main()

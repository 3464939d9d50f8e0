"""Kernel B8's backward alone on one CUDA card, under each clip rule.

    python3 scripts/torch_fused_apply_bench.py TAG

Times ``ops.fused_apply.fused_apply_bwd`` (the shared delta) at the fused
step's [8,64,224,224,3] and the fused slot step's [4,90,224,224,3] with
CUDA events over 10 and 100 launches, the host's enqueue time a call and
torch.profiler's device time by kernel, beside the forward, with the card's
name and power limit; each line is tagged TAG.  The package is imported from
the current directory, so a copy of another commit unpacked into a directory
that .gitignore lists (``archive/<name>``) and run from there is timed in
the same call (its kernels build into its own ``build/``); a package whose
backward takes no ``strict`` is timed once, with its own rule.
"""
import inspect
import os
import subprocess
import sys
import time

import torch


def events(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def host(fn, iters=50):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def device(fn, iters=20):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / 1e3 / iters) for e in prof.key_averages()
            if "fused_apply" in e.key]


def main() -> None:
    tag = sys.argv[1]
    sys.path.insert(0, os.getcwd())
    from flickering_adversarial_video_tpu_torch.ops import fused_apply, kernels

    kernels.build()
    dev = torch.device("cuda")
    has_rule = "strict" in inspect.signature(fused_apply.fused_apply_bwd).parameters
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    for shape in ((8, 64, 224, 224, 3), (4, 90, 224, 224, 3)):
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
        d = ((torch.rand(shape[1], 1, 1, 3, generator=gen) - 0.5) * 0.8).to(dev)
        g = torch.randn(shape, generator=gen).to(dev)
        f = torch.ones((), device=dev)
        for rule in ((True, False) if has_rule else (None,)):
            kw = {} if rule is None else {"strict": rule}

            def fn():
                return fused_apply.fused_apply_bwd(u8, d, f, g, **kw)

            fwd_ms = events(lambda: fused_apply.fused_apply_fwd(u8, d, f), 10)
            print(f"[b8b {tag}] {list(shape)} rule {rule}: events over 10 {events(fn, 10):.4f} "
                  f"ms, over 100 {events(fn, 100):.4f} ms; host enqueue a call {host(fn):.4f} "
                  f"ms; device (profiler) {device(fn)}; forward (events over 10) {fwd_ms:.4f} "
                  f"ms; {smi}", flush=True)
        del u8, d, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

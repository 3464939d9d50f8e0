"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- the universal flickering attack step on
full-width I3D (400 classes, every Mixed block), B=8 uint8 clips of
64x224x224, bf16, random weights from a numpy seed -- through
``AttackEngine.train_steps`` and ``eval_step``, after building the port's
CUDA kernels from ``flickering_adversarial_video_tpu_torch/csrc``.  Phases,
each of which fails the run:

1. build the kernels (nvcc, sm_90a), timed as set-up;
2. hold each kernel (B1..B6) against its plain PyTorch version at the main
   path's shapes, in bf16 and in f32 (B3 and B4 also at Mixed_5c's branch
   pool, where the tiles are partial; B4 and B6 also on integer tie grids,
   where they must be exact), with the stated tolerances;
3. the full-width slice: launch counts of every kernel over the main path
   (reset just before, read just after) must equal the per-step counts
   (train step: B1 1, B2 19, B3 9, B4 9, B5 3, B6 3; eval step: B1 2, B3 18,
   B5 6),
   losses finite, delta moved;
4. the same engine at a small geometry in f32 against the plain versions on
   the CPU: loss and delta trajectory to tolerance;
5. timings with CUDA events (kernels, their plain versions, one library call
   where one computes the same function, the bound at the shapes), the step
   time, peak memory, the card's name and power limit;
6. where the step's device time goes, by torch.profiler over 2 train steps:
   the device's busy share, the time of the port's kernels, of cuDNN/cuBLAS
   and of everything else, the slowest kernels, and the forward's share.

Prints the kernel table as one JSON line, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))

B, T, SIZE, CLASSES, SEED, STEPS = 8, 64, 224, 400, 0, 3
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PROFILE_STEPS = 2
# kernel names of cuDNN / cuBLAS / CUTLASS convolutions and matrix products
CONV_MARKS = ("conv", "cudnn", "xmma", "gemm", "sm90", "cutlass", "dgrad", "wgrad", "implicit")
TRAIN_COUNTS = {"B1": 1, "B2": 19, "B3": 9, "B4": 9, "B5": 3, "B6": 3}
EVAL_COUNTS = {"B1": 2, "B2": 0, "B3": 18, "B4": 0, "B5": 6, "B6": 0}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters=10, warmup=2):
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
    sys.path.insert(0, HERE)
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from flickering_adversarial_video_tpu_torch import ops
        from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
        from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
        from flickering_adversarial_video_tpu_torch.engine import AttackEngine, RuntimeFlags
        from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
        from flickering_adversarial_video_tpu_torch.ops import kernels, pool_s1, pool_strided
        from flickering_adversarial_video_tpu_torch.ops import stem_combine, stem_conv
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if any(m == "jax" or m.startswith(("jax.", "flickering_adversarial_video_tpu."))
           for m in sys.modules):
        fail("jax or the JAX package was imported")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = lib_path.parent / "nvcc.log"
    if log.exists():
        for line in log.read_text(errors="replace").splitlines():
            if "Used" in line or "spill" in line and "0 bytes spill" not in line:
                print(f"[ptxas] {line.strip()}")

    # ---- 2. kernels against their plain versions at the path's shapes -------
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def compare(got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1e-30)
        return err, err / scale

    def make_runs(x1, pk, bn, part, xp, dy, x5, dy5):
        """(kernel, plain version) of each of B1..B6 on these inputs."""
        return {
            "B1": (lambda: stem_conv.stem_conv_bn_relu(x1, pk, *bn),
                   lambda: stem_conv.stem_conv_bn_relu_plain(x1, pk, *bn)),
            "B2": (lambda: stem_combine.temporal_combine(part, 64, 1),
                   lambda: stem_combine.temporal_combine_plain(part, 64, 1)),
            "B3": (lambda: pool_s1.pool333_fwd(xp), lambda: pool_s1.pool333_fwd_plain(xp)),
            "B4": (lambda: pool_s1.pool333_bwd(xp, dy), lambda: pool_s1.pool333_bwd_plain(xp, dy)),
            "B5": (lambda: pool_strided.pool133_s2_fwd(x5),
                   lambda: pool_strided.pool133_s2_fwd_plain(x5)),
            "B6": (lambda: pool_strided.pool133_s2_bwd(x5, dy5),
                   lambda: pool_strided.pool133_s2_bwd_plain(x5, dy5)),
        }

    th, tw = SIZE // 2, SIZE // 2
    shapes = {
        "B1": (B, T // 2, th, tw, 24),
        "B2": (B, T // 2, th // 2, tw // 2, 3 * 64),     # Conv3d_2c backward
        "B3": (B, T // 2, th // 4, tw // 4, 192),        # Mixed_3b branch pool
        "B5": (B, T // 2, th, tw, 64),                   # MaxPool3d_2a
    }
    shapes["B4"] = shapes["B3"]
    shapes["B6"] = shapes["B5"]
    shape5c = (B, T // 8, th // 16, tw // 16, 832)  # Mixed_5c branch pool
    pooled5 = (B, T // 2, th // 2, tw // 2, 64)
    # relative tolerances, max |err| / max |plain|: bf16 rounds differently
    # when the f32 sums' order differs (B1 64-tap contraction, B4 <=27 adds)
    tol = {("B1", torch.bfloat16): 1e-2, ("B1", torch.float32): 1e-5,
           ("B4", torch.bfloat16): 1e-2, ("B4", torch.float32): 1e-6,
           ("B6", torch.bfloat16): 1e-2, ("B6", torch.float32): 1e-6}
    checks = {}
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x1 = (torch.randint(0, 256, shapes["B1"], generator=gen).float() / 128 - 1).to(dev, dtype)
        pk = randn(4, 4, 4, 24, 64, dtype=dtype) * 0.05
        bn = (randn(64), randn(64).abs() + 0.5, randn(64))
        part = randn(*shapes["B2"], dtype=dtype)
        xp = randn(*shapes["B3"], dtype=dtype)
        dy = randn(*shapes["B3"], dtype=dtype)
        x5 = randn(*shapes["B5"], dtype=dtype)
        dy5 = randn(*pooled5, dtype=dtype)
        runs = make_runs(x1, pk, bn, part, xp, dy, x5, dy5)
        xc, dyc = randn(*shape5c, dtype=dtype), randn(*shape5c, dtype=dtype)
        runs_5c = {
            "B3 Mixed_5c": (lambda: pool_s1.pool333_fwd(xc), lambda: pool_s1.pool333_fwd_plain(xc)),
            "B4 Mixed_5c": (lambda: pool_s1.pool333_bwd(xc, dyc),
                            lambda: pool_s1.pool333_bwd_plain(xc, dyc)),
        }
        for name, (kern, plain) in {**runs, **runs_5c}.items():
            got = kern()
            torch.cuda.synchronize()
            err, rel = compare(got, plain())
            limit = tol.get((name.split()[0], dtype), 0.0)
            checks[(name, dtype)] = (err, rel)
            print(f"[check] {name:11s} {str(dtype)[6:]:8s} max_abs_err {err:.3e} "
                  f"max_rel_err {rel:.3e} (max_rel_err tolerance {limit:g})", flush=True)
            if not rel <= limit:
                fail(f"{name} {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            inputs = dict(x1=x1, pk=pk, bn=bn, xp=xp, x5=x5, runs=runs)
    for name, xshape, yshape, kern, plain in (
        ("B4", shapes["B4"], shapes["B4"], pool_s1.pool333_bwd, pool_s1.pool333_bwd_plain),
        ("B4 Mixed_5c", shape5c, shape5c, pool_s1.pool333_bwd, pool_s1.pool333_bwd_plain),
        ("B6", shapes["B6"], pooled5, pool_strided.pool133_s2_bwd,
         pool_strided.pool133_s2_bwd_plain),
    ):
        ties = torch.randint(0, 3, xshape, generator=gen).to(dev, torch.float32)
        dyi = torch.randint(-8, 9, yshape, generator=gen).to(dev, torch.float32)
        err, _ = compare(kern(ties, dyi), plain(ties, dyi))
        print(f"[check] {name} integer tie grid f32 max_abs_err {err:.3e} (tolerance 0)",
              flush=True)
        if err != 0:
            fail(f"{name} is not exact on the integer tie grid")
        del ties, dyi

    # ---- 3. the full-width slice through the engine -------------------------
    model = InceptionI3D(CLASSES, torch.bfloat16, device=dev)
    model.load_state_dict(init_i3d_state(SEED, CLASSES))
    engine = AttackEngine(model, FlickerSpec(frames=T), track_probs=False)
    rng = np.random.default_rng(SEED)
    batch = {
        "video": torch.from_numpy(rng.integers(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)).to(dev),
        "labels": torch.from_numpy(rng.integers(0, CLASSES, (B,))).to(dev),
    }
    flags = RuntimeFlags()
    engine.train_steps(engine.init_state(), batch, flags, 1)  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = engine.train_steps(engine.init_state(), batch, flags, STEPS)
    state, metrics = engine.train_step(state, batch, flags)
    ev = engine.eval_step(state.delta, batch, flags)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {name.split()[0]: n for name, n in ops.launch_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_train = STEPS + 1
    want = {k: n_train * TRAIN_COUNTS[k] + EVAL_COUNTS[k] for k in TRAIN_COUNTS}
    print(f"[slice] {n_train} train steps + 1 eval step in {main_s:.2f} s; launches {counts} "
          f"(expected {want}); peak memory {peak_gb:.2f} GB", flush=True)
    if counts != want:
        fail("kernel launch counts of the main path differ from the per-step counts")
    loss = {k: float(metrics[k]) for k in ("total_loss", "adv_loss", "reg_loss")}
    print(f"[slice] step-{STEPS + 1} terms {loss}; delta range "
          f"[{state.delta.min().item():.3e}, {state.delta.max().item():.3e}]; "
          f"eval miss {int(ev['miss'])} valid {int(ev['valid'])}", flush=True)
    if not all(math.isfinite(v) for v in loss.values()):
        fail("non-finite loss")
    if not state.delta.abs().max().item() > 0:
        fail("delta did not move")
    if not (ev["adv_probs"].shape == (B, CLASSES) and torch.isfinite(ev["adv_probs"]).all()):
        fail("eval probabilities malformed")

    # ---- 4. small geometry, f32: kernels vs the plain versions on the CPU ----
    small = {"video": rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8),
             "labels": rng.integers(0, CLASSES, (2,))}
    sd = init_i3d_state(SEED + 1, CLASSES)
    res = {}
    for where in ("cuda", "cpu"):
        m = InceptionI3D(CLASSES, torch.float32, device=where)
        m.load_state_dict(sd)
        e = AttackEngine(m, FlickerSpec(frames=8))
        s = e.init_state()
        losses = []
        for _ in range(STEPS):
            s, mt = e.train_step(s, small, flags)
            losses.append(float(mt["total_loss"]))
        res[where] = (losses, s.delta.cpu())
    lrel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(res["cuda"][0], res["cpu"][0]))
    dmax = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
    print(f"[reference] small f32 slice, card vs CPU plain: loss rel err {lrel:.2e} "
          f"(tolerance 1e-4), delta abs err {dmax:.2e} (tolerance 1e-6)", flush=True)
    if not (lrel <= 1e-4 and dmax <= 1e-6):
        fail("the card disagrees with the CPU reference on the small slice")

    # ---- 5. timings ------------------------------------------------------------
    step_ms = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1), iters=5, warmup=1)
    print(f"[time] train step {step_ms:.2f} ms ({1000 / step_ms:.3f} steps/s) at "
          f"B={B} T={T} {SIZE}x{SIZE} bf16", flush=True)

    x1, pk, bn, xp, x5 = (inputs[k] for k in ("x1", "pk", "bn", "xp", "x5"))
    isz = 2

    def n_in_range(n, lo, taps):
        return sum(sum(1 for m in range(taps) if 0 <= i + m - lo < n) for i in range(n))

    macs = 24 * 64 * n_in_range(T // 2, 1, 4) * n_in_range(th, 1, 4) * n_in_range(tw, 1, 4) * B
    nb = {k: math.prod(v) for k, v in shapes.items()}
    work = {  # (bytes moved, operations, peak rate of those operations)
        "B1": (nb["B1"] * isz + pk.numel() * isz + nb["B1"] // 24 * 64 * isz + 3 * 64 * 4,
               2 * macs, PEAK_BF16_FLOPS),
        "B2": (nb["B2"] * isz + nb["B2"] // 3 * isz, nb["B2"] // 3 * 2, PEAK_F32_FLOPS),
        "B3": (2 * nb["B3"] * isz, 26 * nb["B3"], PEAK_F32_FLOPS),
        "B4": (3 * nb["B4"] * isz, 27 * nb["B4"], PEAK_F32_FLOPS),
        "B5": (nb["B5"] * isz + nb["B5"] // 4 * isz, 8 * nb["B5"] // 4, PEAK_F32_FLOPS),
        "B6": (2 * nb["B6"] * isz + nb["B6"] // 4 * isz, 8 * nb["B6"] // 4, PEAK_F32_FLOPS),
    }
    x1p = F.pad(x1.permute(0, 4, 1, 2, 3), (1, 2) * 3)
    w1 = stem_conv.pk_to_oidhw(pk).contiguous(memory_format=torch.channels_last_3d)
    xpp = F.pad(xp.permute(0, 4, 1, 2, 3), (1, 1) * 3, value=float("-inf"))
    x5p = F.pad(x5.permute(0, 4, 1, 2, 3), (0, 1, 0, 1), value=float("-inf"))
    library = {
        "B1": lambda: F.conv3d(x1p, w1),
        "B3": lambda: F.max_pool3d(xpp, 3, 1),
        "B5": lambda: F.max_pool3d(x5p, (1, 3, 3), (1, 2, 2)),
    }
    replaces = {
        "B1": "flickering_adversarial_video_tpu/ops/stem_conv_pallas.py:152",
        "B2": "flickering_adversarial_video_tpu/ops/stem_combine_pallas.py:74",
        "B3": "flickering_adversarial_video_tpu/ops/pool_s1_view_pallas.py:331",
        "B4": "flickering_adversarial_video_tpu/ops/pool_s1_view_pallas.py:370",
        "B5": "flickering_adversarial_video_tpu/ops/stem_tmajor.py:718",
        "B6": "flickering_adversarial_video_tpu/ops/pool_s2_view_pallas.py:246",
    }
    source = {
        "B1": "flickering_adversarial_video_tpu_torch/csrc/stem_conv.cu",
        "B2": "flickering_adversarial_video_tpu_torch/csrc/stem_combine.cu",
        "B3": "flickering_adversarial_video_tpu_torch/csrc/pool_s1.cu",
        "B4": "flickering_adversarial_video_tpu_torch/csrc/pool_s1.cu",
        "B5": "flickering_adversarial_video_tpu_torch/csrc/pool_strided.cu",
        "B6": "flickering_adversarial_video_tpu_torch/csrc/pool_strided.cu",
    }
    wrappers = dict(ops.kernel_wrappers())
    table = []
    for (full_name, _), name in zip(wrappers.items(), ("B1", "B2", "B3", "B4", "B5", "B6")):
        kern, plain = inputs["runs"][name]
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        lib_ms = cuda_ms(torch, library[name]) if name in library else None
        nbytes, nops, peak = work[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        table.append({
            "name": full_name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": checks[(name, torch.bfloat16)][0],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"[time] {full_name}: {ms:.3f} ms (bound {bound_ms:.3f} ms, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}; {bound_ms / ms:.1%} of it), "
              f"plain {plain_ms:.3f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}", flush=True)

    # ---- 6. where the step's device time goes ---------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    symbols = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1),
                          iters=PROFILE_STEPS, warmup=0)
    rows = []  # (ms per step, launches per step, kernel name)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            rows.append((us / 1e3 / PROFILE_STEPS, e.count / PROFILE_STEPS, e.key))
    busy = sum(r[0] for r in rows)
    if busy > 0:
        groups = defaultdict(float)
        for ms, _, name in rows:
            if any(sym in name for sym in symbols):
                groups["the port's kernels B1-B6"] += ms
            elif any(mark in name.lower() for mark in CONV_MARKS):
                groups["convolution / matmul (cuDNN, cuBLAS)"] += ms
            else:
                groups["other (elementwise, reductions, copies)"] += ms
        print(f"[profile] {PROFILE_STEPS} train steps: wall {wall_ms:.2f} ms/step; kernels "
              f"{busy:.2f} ms/step; device busy {busy / wall_ms:.1%}, idle {1 - busy / wall_ms:.1%}")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[profile]   {g:42s} {ms:9.2f} ms/step  {ms / busy:6.1%}")
        for ms, n, name in sorted(rows, reverse=True)[:12]:
            print(f"[profile]   slowest: {ms:8.3f} ms/step {n:5.1f} launches/step  {name[:90]}")
    else:
        print("[profile] torch.profiler saw no device time: breakdown not measured")
    packed, _ = engine.prepare_batch(batch)
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: engine._logits(state.delta, packed, flags),
                         iters=5, warmup=1)
    print(f"[profile] forward alone (no grad) {fwd_ms:.2f} ms; backward + Adam + metrics "
          f"{step_ms - fwd_ms:.2f} ms of the {step_ms:.2f} ms step", flush=True)

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths -- the universal flickering attack on full-width
I3D (400 classes, every Mixed block), B=8 uint8 clips of 64x224x224, bf16,
random weights from a numpy seed -- after building the port's CUDA kernels
from ``flickering_adversarial_video_tpu_torch/csrc``: the attack step through
``AttackEngine.train_steps`` and ``eval_step``, and the universal runner
(``runners.universal.run``: tfrecord shards -> loop -> eval -> checkpoints)
in its two configurations.  Phases, each of which fails the run:

1. build the kernels (nvcc, sm_90a), timed as set-up;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes, with the stated tolerances: B1..B6 in bf16 and f32 (B2 also at the
   stem's own 4-tap dgrad [8,32,112,112,96], which USE_PALLAS_FUSED adds; B3
   and B4 also at Mixed_5c's branch pool, where the tiles are partial; B4 and
   B6 also on integer tie grids, where they must be exact); B7 in bf16 and
   f32 with an engineered boundary hit, bit-equal; B8 forward bit-equal; B8
   backward to f32 sum order, exactly 0 where everything clips, bit-equal to
   itself on a second run, and all of B8 also at [1,90,224,224,3], a geometry
   the TPU kernel refused;
3. the attack step: launch counts of every kernel (reset just before, read
   just after) must equal the per-step counts (train step: B1 1, B2 19, B3 9,
   B4 9, B5 3, B6 3, B7 1; eval step: B1 2, B3 18, B5 6, B7 2), losses finite,
   delta moved;
4. the same engine at a small geometry in f32, in both configurations,
   against the plain versions on the CPU: loss and delta trajectory to
   tolerance;
5. timings with CUDA events (kernels, their plain versions, one library call
   where one computes the same function, the bound at the shapes), the step
   time of both configurations, peak memory, the card's name and power limit;
6. where the step's device time goes, by torch.profiler over 2 train steps;
7. the runner, default configuration (host-packed input; B7 then B1): 2
   shards x 8 records written with the port's own TFRecordWriter, labelled
   with the seeded model's clean prediction; ``configs/run_config.yml``
   loaded unchanged, only paths, BATCH_SIZE, NUM_OF_*_TF_RECORDS and
   MAX_NUM_STEP overridden; 12 steps, then a resume to 16; exact launch
   counts, finite losses, res.pkl and checkpoints on disk, steps/s by the
   loop's own timer; then the 12 steps again under torch.profiler for the
   device's busy share, over the whole run and over the steps alone (by the
   loop's spans, its evals taken out);
8. the runner with USE_PALLAS_FUSED: True (unpacked uint8; B8 forward and
   backward, the stem with an input gradient), 4 steps on the same shards;
   its first loss against the default configuration's, and the two paths'
   first d(delta) side by side.

Prints the kernel table as one JSON line, then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))

B, T, SIZE, CLASSES, SEED, STEPS = 8, 64, 224, 400, 0, 1
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PROFILE_STEPS = 2
# kernel names of cuDNN / cuBLAS / CUTLASS convolutions and matrix products
CONV_MARKS = ("conv", "cudnn", "xmma", "gemm", "sm90", "cutlass", "dgrad", "wgrad", "implicit")
NAMES = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8f", "B8b")
# launches per step; the default configuration (packed input head) ...
TRAIN_COUNTS = dict(zip(NAMES, (1, 19, 9, 9, 3, 3, 1, 0, 0)))
EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 6, 0, 2, 0, 0)))
# ... and USE_PALLAS_FUSED: B8 instead of B7, one more B2 (the stem's input
# gradient); its evals take the generic path (no B7, no B8)
FUSED_TRAIN_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 3, 3, 0, 1, 1)))
FUSED_EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 6, 0, 0, 0, 0)))
RUNNER_STEPS, RESUME_STEPS, FUSED_STEPS = 12, 16, 4
SHARDS, PER_SHARD = 2, 8


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


def kernel_rows(prof, per: int = 1, spans=()):
    """(ms, launches, name) of every device kernel in a profile, per `per`.
    `spans` names the record_function spans of the traced code: the profiler
    mirrors them onto the device's timeline, and they are no kernels."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.key not in spans:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            rows.append((us / 1e3 / per, e.count / per, e.key))
    return rows


def loop_share(prof, eval_span: str, spans):
    """(kernel ms, wall ms, kernels with no launch record) of a traced runner's
    loop outside its evals: from the end of the initial eval to the start of
    the final one, less the evals between.  A kernel belongs to the steps when
    its launch call lies in that time (a step's kernels may still run while
    the host has gone on, so the launch decides and not the execution); copies
    are left out.  None when the trace holds no evals or no launch records."""
    from torch.autograd import DeviceType

    events = prof.events()
    evals = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == eval_span and e.device_type == DeviceType.CPU)
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith(("cudaLaunch", "cuLaunch"))}
    if len(evals) < 2 or not launched:
        return None
    lo, hi, inner = evals[0][1], evals[-1][0], evals[1:-1]
    wall_us = (hi - lo) - sum(end - start for start, end in inner)
    kernel_us, unmatched = 0.0, 0
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name in spans
                or e.name.startswith(("Memcpy", "Memset"))):
            continue
        at = launched.get(e.id)
        if at is None:
            unmatched += 1
        elif lo <= at < hi and not any(start <= at < end for start, end in inner):
            kernel_us += e.time_range.elapsed_us()
    return kernel_us / 1e3, wall_us / 1e3, unmatched


def read_counts(ops) -> dict:
    return {name.split()[0]: n for name, n in ops.launch_counts().items()}


def main() -> None:
    sys.path.insert(0, HERE)
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from flickering_adversarial_video_tpu_torch import ops
        from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
        from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
        from flickering_adversarial_video_tpu_torch.data import (
            TFRecordWriter, make_uint8_example, pack_video_np)
        from flickering_adversarial_video_tpu_torch.engine import (
            AttackConfig, AttackEngine, RuntimeFlags)
        from flickering_adversarial_video_tpu_torch.engine import loops
        from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
        from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
        from flickering_adversarial_video_tpu_torch.ops import fused_apply, kernels, packed_apply
        from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided
        from flickering_adversarial_video_tpu_torch.ops import stem_combine, stem_conv
        from flickering_adversarial_video_tpu_torch.runners import common, universal
        from flickering_adversarial_video_tpu_torch.utils.config import load_config
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
        # the stem's own dgrad (USE_PALLAS_FUSED): the one 4-tap, 24-channel use
        part4 = randn(B, T // 2, th, tw, 4 * 24, dtype=dtype)
        runs_5c = {
            "B2 stem dgrad": (lambda p=part4: stem_combine.temporal_combine(p, 24, 1),
                              lambda p=part4: stem_combine.temporal_combine_plain(p, 24, 1)),
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
            print(f"[check] {name:13s} {str(dtype)[6:]:8s} max_abs_err {err:.3e} "
                  f"max_rel_err {rel:.3e} (max_rel_err tolerance {limit:g})", flush=True)
            if not rel <= limit:
                fail(f"{name} {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            inputs = dict(x1=x1, pk=pk, bn=bn, xp=xp, x5=x5, runs=runs,
                          b2_stem=runs_5c["B2 stem dgrad"])
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

    # B7: the emitter at the input head's shape; adv and mask bit-equal, with
    # an engineered boundary hit (u8 0 under dl 0 is exactly lo: mask 1)
    u8p = torch.randint(0, 256, shapes["B1"], generator=gen, dtype=torch.uint8)
    u8p[0, 0, 0, 0, 0] = 0
    u8p = u8p.to(dev)
    dl = ((torch.rand(T // 2, 24, generator=gen) - 0.5) * 0.6).to(dev)
    dl[:, 0] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        adv, mask2 = packed_apply.emit_adv_mask(u8p, dl, -1.0, 1.0, dtype)
        torch.cuda.synchronize()
        want_adv, want_mask = packed_apply.emit_adv_mask_plain(u8p, dl, -1.0, 1.0, dtype)
        err, _ = compare(adv, want_adv)
        merr = (mask2.int() - want_mask.int()).abs().max().item()
        ties = int((mask2 == 1).sum())
        checks[("B7", dtype)] = (max(err, float(merr)), 0.0)
        print(f"[check] B7          {str(dtype)[6:]:8s} adv max_abs_err {err:.3e} mask max_abs_err "
              f"{merr} (tolerance 0); {ties} elements on a bound (mask 1)", flush=True)
        if err != 0 or merr != 0 or ties == 0:
            fail(f"B7 {dtype} is not bit-equal to its plain version (or no boundary hit)")
        nomask_adv, nomask = packed_apply.emit_adv_mask(u8p, dl, -1.0, 1.0, dtype, want_mask=False)
        if nomask is not None or not torch.equal(nomask_adv, adv):
            fail("B7 without a mask differs")
        del adv, mask2, want_adv, want_mask, nomask_adv
    inputs["runs"]["B7"] = (
        lambda: packed_apply.emit_adv_mask(u8p, dl, -1.0, 1.0, torch.bfloat16),
        lambda: packed_apply.emit_adv_mask_plain(u8p, dl, -1.0, 1.0, torch.bfloat16))

    # B8: forward bit-equal; backward to f32 sum order (each of the 192
    # components sums 401,408 products in another order than torch.sum:
    # 1e-5 of the largest component), 0 where all clips, and deterministic
    flag1 = torch.ones((), device=dev)
    for shape8 in ((B, T, SIZE, SIZE, 3), (1, 90, SIZE, SIZE, 3)):
        u8v = torch.randint(0, 256, shape8, generator=gen, dtype=torch.uint8).to(dev)
        dlt = ((torch.rand(shape8[1], 1, 1, 3, generator=gen) - 0.5) * 0.8).to(dev)
        gup = torch.randn(shape8, generator=gen).to(dev)
        got = fused_apply.fused_apply_fwd(u8v, dlt, flag1)
        torch.cuda.synchronize()
        ferr, _ = compare(got, fused_apply.fused_apply_fwd_plain(u8v, dlt, flag1))
        del got
        dd = fused_apply.fused_apply_bwd(u8v, dlt, flag1, gup)
        dd2 = fused_apply.fused_apply_bwd(u8v, dlt, flag1, gup)
        torch.cuda.synchronize()
        berr, brel = compare(dd, fused_apply.fused_apply_bwd_plain(u8v, dlt, flag1, gup))
        sat = fused_apply.fused_apply_bwd(u8v, torch.full_like(dlt, 5.0), flag1, gup)
        print(f"[check] B8 {list(shape8)} forward max_abs_err {ferr:.3e} (tolerance 0); backward "
              f"max_abs_err {berr:.3e} max_rel_err {brel:.3e} (max_rel_err tolerance 1e-5); "
              f"all-clipped max {sat.abs().max().item():.1e} (tolerance 0); second run "
              f"{'bit-equal' if torch.equal(dd, dd2) else 'DIFFERS'}", flush=True)
        if ferr != 0 or not brel <= 1e-5 or sat.abs().max().item() != 0 or not torch.equal(dd, dd2):
            fail(f"B8 disagrees with its plain version at {shape8}")
        if shape8[0] == B:
            checks[("B8f", torch.bfloat16)] = (ferr, 0.0)
            checks[("B8b", torch.bfloat16)] = (berr, brel)
            inputs["runs"]["B8f"] = (
                lambda u=u8v, d=dlt: fused_apply.fused_apply_fwd(u, d, flag1),
                lambda u=u8v, d=dlt: fused_apply.fused_apply_fwd_plain(u, d, flag1))
            inputs["runs"]["B8b"] = (
                lambda u=u8v, d=dlt, g=gup: fused_apply.fused_apply_bwd(u, d, flag1, g),
                lambda u=u8v, d=dlt, g=gup: fused_apply.fused_apply_bwd_plain(u, d, flag1, g))
        del u8v, dlt, gup, dd, dd2, sat

    # ---- 3. the full-width attack step through the engine -----------------------
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
    counts = read_counts(ops)
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
    for fused in (False, True):
        res = {}
        for where in ("cuda", "cpu"):
            m = InceptionI3D(CLASSES, torch.float32, device=where)
            m.load_state_dict(sd)
            e = AttackEngine(m, FlickerSpec(frames=8), AttackConfig(use_pallas_fused=fused))
            s = e.init_state()
            losses = []
            for _ in range(3):
                s, mt = e.train_step(s, small, flags)
                losses.append(float(mt["total_loss"]))
            res[where] = (losses, s.delta.cpu())
        lrel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(res["cuda"][0], res["cpu"][0]))
        dmax = (res["cuda"][1] - res["cpu"][1]).abs().max().item()
        # B8's backward sums each d(delta) component in another order than
        # torch.sum on the CPU, and Adam's g / (|g| + 1e-8) amplifies that on
        # the components of these tiny gradients (~1e-6) that lie near eps:
        # 1% of one 1e-3 step there, against 0.1% on the default path
        dtol = 1e-5 if fused else 1e-6
        print(f"[reference] small f32 slice{' (USE_PALLAS_FUSED)' if fused else ''}, card vs CPU "
              f"plain: loss rel err {lrel:.2e} (tolerance 1e-4), delta abs err {dmax:.2e} "
              f"(tolerance {dtol:g})", flush=True)
        if not (lrel <= 1e-4 and dmax <= dtol):
            fail("the card disagrees with the CPU reference on the small slice")

    # ---- 5. timings ------------------------------------------------------------
    step_ms = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1), iters=5, warmup=1)
    print(f"[time] train step {step_ms:.2f} ms ({1000 / step_ms:.3f} steps/s) at "
          f"B={B} T={T} {SIZE}x{SIZE} bf16", flush=True)
    fused_engine = AttackEngine(model, FlickerSpec(frames=T), AttackConfig(use_pallas_fused=True),
                                track_probs=False)
    torch.cuda.reset_peak_memory_stats()
    fused_ms = cuda_ms(torch, lambda: fused_engine.train_steps(state, batch, flags, 1),
                       iters=5, warmup=1)
    print(f"[time] train step (USE_PALLAS_FUSED) {fused_ms:.2f} ms ({1000 / fused_ms:.3f} steps/s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    x1, pk, bn, xp, x5 = (inputs[k] for k in ("x1", "pk", "bn", "xp", "x5"))
    isz = 2

    def n_in_range(n, lo, taps):
        return sum(sum(1 for m in range(taps) if 0 <= i + m - lo < n) for i in range(n))

    macs = 24 * 64 * n_in_range(T // 2, 1, 4) * n_in_range(th, 1, 4) * n_in_range(tw, 1, 4) * B
    nb = {k: math.prod(v) for k, v in shapes.items()}
    n8 = B * T * SIZE * SIZE * 3
    work = {  # (bytes moved, operations, peak rate of those operations)
        "B1": (nb["B1"] * isz + pk.numel() * isz + nb["B1"] // 24 * 64 * isz + 3 * 64 * 4,
               2 * macs, PEAK_BF16_FLOPS),
        "B2": (nb["B2"] * isz + nb["B2"] // 3 * isz, nb["B2"] // 3 * 2, PEAK_F32_FLOPS),
        "B3": (2 * nb["B3"] * isz, 26 * nb["B3"], PEAK_F32_FLOPS),
        "B4": (3 * nb["B4"] * isz, 27 * nb["B4"], PEAK_F32_FLOPS),
        "B5": (nb["B5"] * isz + nb["B5"] // 4 * isz, 8 * nb["B5"] // 4, PEAK_F32_FLOPS),
        "B6": (2 * nb["B6"] * isz + nb["B6"] // 4 * isz, 8 * nb["B6"] // 4, PEAK_F32_FLOPS),
        # B7: u8 read, bf16 adv and u8 mask written; ~10 f32 operations an element
        "B7": (nb["B1"] * (1 + isz + 1) + dl.numel() * 4, 10 * nb["B1"], PEAK_F32_FLOPS),
        # B8: u8 read and f32 written / u8 and f32 g read; ~5 operations an element
        "B8f": (n8 * (1 + 4) + T * 3 * 4, 5 * n8, PEAK_F32_FLOPS),
        "B8b": (n8 * (1 + 4) + 2 * T * 3 * 4, 5 * n8, PEAK_F32_FLOPS),
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
        "B7": "flickering_adversarial_video_tpu/ops/stem_tmajor.py:363",
        "B8f": "flickering_adversarial_video_tpu/ops/fused_apply.py:132",
        "B8b": "flickering_adversarial_video_tpu/ops/fused_apply.py:172",
    }
    source = {
        "B1": "flickering_adversarial_video_tpu_torch/csrc/stem_conv.cu",
        "B2": "flickering_adversarial_video_tpu_torch/csrc/stem_combine.cu",
        "B3": "flickering_adversarial_video_tpu_torch/csrc/pool_s1.cu",
        "B4": "flickering_adversarial_video_tpu_torch/csrc/pool_s1.cu",
        "B5": "flickering_adversarial_video_tpu_torch/csrc/pool_strided.cu",
        "B6": "flickering_adversarial_video_tpu_torch/csrc/pool_strided.cu",
        "B7": "flickering_adversarial_video_tpu_torch/csrc/emit.cu",
        "B8f": "flickering_adversarial_video_tpu_torch/csrc/fused_apply.cu",
        "B8b": "flickering_adversarial_video_tpu_torch/csrc/fused_apply.cu",
    }
    table = []
    for full_name, _ in ops.kernel_wrappers():
        name = full_name.split()[0]
        kern, plain = inputs["runs"][name]
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        lib_ms = cuda_ms(torch, library[name]) if name in library else None
        nbytes, nops, peak = work[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        table.append({
            "name": full_name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": None,  # set after the runner phases
            "max_abs_err": checks[(name, torch.bfloat16)][0],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"[time] {full_name}: {ms:.3f} ms (bound {bound_ms:.3f} ms, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}; {bound_ms / ms:.1%} of it), "
              f"plain {plain_ms:.3f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}", flush=True)

    kern, plain = inputs["b2_stem"]
    n4 = B * (T // 2) * th * tw * 24
    print(f"[time] B2 at the stem's dgrad [{B},{T // 2},{th},{tw},96] (USE_PALLAS_FUSED): "
          f"{cuda_ms(torch, kern):.3f} ms (bound {5 * n4 * isz / PEAK_BYTES * 1e3:.3f} ms, bytes), "
          f"plain {cuda_ms(torch, plain, iters=3, warmup=1):.3f} ms", flush=True)

    # ---- 6. where the step's device time goes ---------------------------------
    from torch.profiler import ProfilerActivity, profile

    symbols = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1),
                          iters=PROFILE_STEPS, warmup=0)
    rows = kernel_rows(prof, PROFILE_STEPS)
    busy = sum(r[0] for r in rows)
    if busy > 0:
        groups = defaultdict(float)
        for ms, _, name in rows:
            if any(sym in name for sym in symbols):
                groups["the port's kernels B1-B8"] += ms
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
    packed, is_packed, _ = engine.prepare_batch(batch)
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: engine._logits(state.delta, packed, is_packed, flags),
                         iters=5, warmup=1)
    print(f"[profile] forward alone (no grad) {fwd_ms:.2f} ms; backward + Adam + metrics "
          f"{step_ms - fwd_ms:.2f} ms of the {step_ms:.2f} ms step", flush=True)


    # ---- 7. the universal runner, default configuration ---------------------------
    del inputs, engine, fused_engine, packed
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="fav_smoke_") as tmp:
        shard_dir = os.path.join(tmp, "shards")
        os.makedirs(shard_dir)
        cfg = load_config(os.path.join(HERE, "configs", "run_config.yml"))
        ac = cfg.UNIVERSAL_ATTACK
        ac.TF_RECORDS_TRAIN_PATH = [shard_dir]
        ac.TF_RECORDS_VAL_PATH = [shard_dir]
        ac.NUM_OF_TRAIN_TF_RECORDS = SHARDS
        ac.NUM_OF_VAL_TF_RECORDS = SHARDS
        ac.BATCH_SIZE = B
        ac.MAX_NUM_STEP = RUNNER_STEPS
        if ac.USE_PALLAS_FUSED or not ac.FLICKERING_ATTACK or ac.COMPUTE_DTYPE != "bfloat16":
            fail("configs/run_config.yml is not the default configuration this phase expects")

        # shards: every clip labelled with the clean prediction of the seeded
        # model build_victim makes, through eval_step on the batches of 8 the
        # runner's eval will see, so that all 16 count as valid
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            labeller, _ = common.build_engine(ac, cfg.MODEL, frames=T, track_probs=False)
        rng = np.random.default_rng(SEED)
        first_batch = None
        for s_i in range(SHARDS):
            clips = rng.integers(0, 256, (PER_SHARD, T, SIZE, SIZE, 3), dtype=np.uint8)
            ev = labeller.eval_step(
                labeller.init_state().delta,
                {"video_packed": pack_video_np(clips), "labels": np.zeros(PER_SHARD, np.int64)})
            labels = ev["clean_probs"].argmax(dim=-1).tolist()
            with TFRecordWriter(os.path.join(shard_dir, f"shard{s_i}.tfrecords")) as w:
                for clip, label in zip(clips, labels):
                    w.write(make_uint8_example(clip, label))
            if first_batch is None:
                first_batch = {"video": clips, "labels": np.asarray(labels)}
        print(f"[runner] wrote {SHARDS} shards x {PER_SHARD} records of [{T},{SIZE},{SIZE},3] uint8 "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        def run_runner(tag, out_dir, max_steps, train_counts, eval_counts, profiled=False):
            """universal.run with the counts reset just before and read just
            after; checks steps, finite losses, the final eval's count, the
            files on disk and the exact launch counts."""
            ac.PKL_RESULT_PATH = os.path.join(tmp, out_dir)
            said = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                stack.enter_context(contextlib.redirect_stdout(said))
                prof = (stack.enter_context(profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) if profiled else None)
                out = universal.run(cfg, frames=T, max_steps=max_steps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0  # before the profiler reads its trace
            got = read_counts(ops)
            said = said.getvalue()
            hist = out["history"]
            start = hist["fool_rate_steps"][0]
            n_eval = len(hist["fool_rate_steps"]) * SHARDS  # val batches per eval
            want = {k: (max_steps - start) * train_counts[k] + n_eval * eval_counts[k]
                    for k in NAMES}
            print(f"[runner] {tag}: steps {start}->{out['steps']} in {wall:.2f} s; evals at "
                  f"{hist['fool_rate_steps']}; final eval {out['final_eval']}; launches {got} "
                  f"(expected {want})", flush=True)
            print(f"[time] runner {tag}: {out['steps_per_sec']:.3f} steps/s by the loop's timer "
                  f"({1000 / max(out['steps_per_sec'], 1e-9):.1f} ms/step; the chained step "
                  f"alone takes {step_ms if train_counts is TRAIN_COUNTS else fused_ms:.1f} ms)",
                  flush=True)
            if out["steps"] != max_steps or out["state"].step != max_steps:
                fail(f"runner {tag}: ended at step {out['steps']}, not {max_steps}")
            if got != want:
                fail(f"runner {tag}: kernel launch counts differ from the per-step counts")
            logged = [v for k in ("total_loss", "adv_loss", "reg_loss") for v in hist[k]]
            if (start == 0 and not logged) or not all(math.isfinite(v) for v in logged):
                fail(f"runner {tag}: a logged loss is missing or not finite")
            if not math.isfinite(out["final_eval"]["miss_rate"]):
                fail(f"runner {tag}: fooling rate not finite")
            model_dir = universal.model_dir_name(ac)
            ckpts = AttackCheckpointer(os.path.join(model_dir, "ckpt")).steps()
            n_files = len(os.listdir(os.path.join(model_dir, "ckpt")))
            if (not os.path.exists(os.path.join(model_dir, "res.pkl")) or max_steps not in ckpts
                    or n_files > 5):
                fail(f"runner {tag}: res.pkl or the checkpoint of step {max_steps} is missing, "
                     f"or more than 5 checkpoint files ({ckpts})")
            return out, said, wall, got, prof

        out, said, _, counts, _ = run_runner(
            "default", "default", RUNNER_STEPS, TRAIN_COUNTS, EVAL_COUNTS)
        if "Begin new training" not in said or "host-prepacked" not in said:
            fail("runner default: not a fresh start on the host-prepacked pipeline")
        if out["final_eval"]["total_valid_videos"] != SHARDS * PER_SHARD:
            fail(f"runner default: {out['final_eval']['total_valid_videos']} valid videos, "
                 f"expected {SHARDS * PER_SHARD}")
        default_loss = out["history"]["total_loss"][0]
        delta12 = out["state"].delta.clone()

        out, said, _, _, _ = run_runner("resumed", "default", RESUME_STEPS, TRAIN_COUNTS,
                                        EVAL_COUNTS)
        if f"Continue training from step {RUNNER_STEPS}" not in said:
            fail("runner resumed: the resume line is missing")
        if out["history"]["fool_rate_steps"][0] != RUNNER_STEPS:
            fail("runner resumed: did not start at the checkpoint's step")
        if torch.equal(out["state"].delta, delta12):
            fail("runner resumed: delta did not move after the resume")

        # the same 12 steps once more under torch.profiler, which slows the
        # host: the steps/s above are the untraced run's, the shares this one's
        out, _, wall, _, prof = run_runner(
            "default, traced", "traced", RUNNER_STEPS, TRAIN_COUNTS, EVAL_COUNTS, profiled=True)
        spans = (loops.STEP_SPAN, loops.EVAL_SPAN)
        busy_ms = sum(r[0] for r in kernel_rows(prof, spans=spans))
        share = loop_share(prof, loops.EVAL_SPAN, spans)
        if busy_ms > 0 and share is not None:
            print(f"[profile] runner default, whole run (initial eval, {RUNNER_STEPS} steps, "
                  f"{len(out['history']['fool_rate_steps']) - 1} more evals, host pipeline): "
                  f"kernels and copies {busy_ms / 1e3:.2f} s of {wall:.2f} s wall; device busy "
                  f"{busy_ms / 1e3 / wall:.1%}, idle {1 - busy_ms / 1e3 / wall:.1%}")
            k_ms, w_ms, unmatched = share
            print(f"[profile] runner default, the {RUNNER_STEPS} steps alone (traced in the "
                  f"loop, its evals taken out): kernels {k_ms / RUNNER_STEPS:.2f} ms a step in "
                  f"{w_ms / RUNNER_STEPS:.1f} ms a step of wall; device busy {k_ms / w_ms:.1%}, "
                  f"idle {1 - k_ms / w_ms:.1%} ({unmatched} kernels without a launch record "
                  f"left out)", flush=True)
        else:
            print("[profile] torch.profiler gave no device time, eval spans or launch records: "
                  "runner busy share not measured")

        # ---- 8. the runner with USE_PALLAS_FUSED: True -------------------------------
        ac.USE_PALLAS_FUSED = True
        ac.MAX_NUM_STEP = FUSED_STEPS
        out, said, _, fused_counts, _ = run_runner(
            "USE_PALLAS_FUSED", "fused", FUSED_STEPS, FUSED_TRAIN_COUNTS, FUSED_EVAL_COUNTS)
        if "host-prepacked" in said:
            fail("runner USE_PALLAS_FUSED: the pipeline prepacked its input")
        fused_loss = out["history"]["total_loss"][0]
        # both forwards give the same bf16 adversarial clip; what differs is
        # the stem's route to it (one f32->bf16 cast either way) and cuDNN's
        # algorithm choices: 1e-3 relative on a bf16 forward
        lrel = abs(fused_loss - default_loss) / max(abs(default_loss), 1e-30)
        print(f"[runner] first-step total_loss: default {default_loss:.6f}, USE_PALLAS_FUSED "
              f"{fused_loss:.6f} (rel diff {lrel:.2e}, tolerance 1e-3)", flush=True)
        if not lrel <= 1e-3:
            fail("the two configurations' first losses disagree")
        # first-step d(delta) of both paths on the first batch: Adam's first
        # moment after one step from zero is 0.1 * gradient
        grads = {}
        for fused in (False, True):
            ac.USE_PALLAS_FUSED = fused
            with contextlib.redirect_stdout(io.StringIO()):
                eng, _ = common.build_engine(ac, cfg.MODEL, frames=T, track_probs=False)
            st, _ = eng.train_step(eng.init_state(), first_batch, flags)
            grads[fused] = (st.mu * 10).flatten().double()
            del eng, st
        gdiff = (grads[True] - grads[False]).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(grads[True], grads[False], dim=0).item()
        print(f"[runner] first-step d(delta), USE_PALLAS_FUSED vs default: max abs "
              f"{grads[False].abs().max().item():.3e}, max abs difference {gdiff:.3e}, cosine "
              f"{cos:.6f} (required >= 0.99); they differ by the tie rule at u8 0 (0 against "
              f"0.5) and by the bf16 rounding of the combined d(adv)", flush=True)
        if not cos >= 0.99:
            fail("the two configurations' first gradients point apart")
    for row in table:
        name = row["name"].split()[0]
        row["launches"] = (fused_counts if name.startswith("B8") else counts)[name]

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

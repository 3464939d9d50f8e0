"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on full-width I3D (400 classes, every Mixed
block, bf16, random weights from a numpy seed), the torch world's video
ResNets (phase 16), the vectorized per-video sweep (phase 17) and data
parallelism over ranks (phase 18), after
building the port's CUDA
kernels from ``flickering_adversarial_video_tpu_torch/csrc``: the universal
flickering attack on B=8 uint8 clips of 64x224x224 (the attack step through
``AttackEngine.train_steps`` and ``eval_step``; the universal runner,
``runners.universal.run``: tfrecord shards -> loop -> eval -> checkpoints, in
its two configurations; the class-gen runner), and the single-video attack on
float32 clips of 90x224x224 (``runners.single_video.run``: npy -> loop ->
pkl), with and without the index-pair pools (kernel B9).  Phases, each of
which fails the run:

1. build the kernels (nvcc, sm_90a), timed as set-up;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes, with the stated tolerances: B1..B6 in bf16 and f32 (B2 also at the
   stem's own 4-tap dgrad [8,32,112,112,96], which USE_PALLAS_FUSED adds; B3
   and B4 also at Mixed_5c's branch pool, where the tiles are partial; B4,
   bit-equal, also at Mixed_3c's, 4b's and 4f's and at two odd geometries
   (partial tiles in every dimension; C = 40 and C = 13); B4 and B6 also on
   integer tie grids, where they must be exact; B5, B9 forward and B6,
   bit-equal, also at the step's other strided pools (MaxPool3d_3a, the
   spatial half of 4a), the single-video clip's three and six edge
   geometries (one window with the pads in both axes, 3 window rows, the
   scalar channel tail, W' = 1, H' = 17 in runs of window rows, C = 40 in
   groups of channel vectors), on random, integer-tie and NaN/-inf grids
   (B9 forward's y equal to B5's, its index equal, its null-index path
   writing y alone; B9 backward equal to its plain version on that index
   and, where no window holds a NaN, to B6); B3, bit-equal, at the step's nine branch
   pools, the single-video clip's three and four edge geometries (H, W of 1
   and across its 14-cell tile, T = 1 and 2, C = 13) on the same three
   grids; B2, bit-equal, at every distinct combine shape of the step); B7 in
   bf16 and f32 with an engineered
   boundary hit, bit-equal; B8 forward bit-equal; B8
   backward to f32 sum order, exactly 0 where everything clips, bit-equal to
   itself on a second run, and all of B8 also at [1,90,224,224,3], a geometry
   the TPU kernel refused; B9 forward (values bit-equal to the plain version
   and to B5's, index equal everywhere, a null index pointer writes nothing)
   and backward (bit-equal to the plain version and to B6 on the same
   (x, dy)) at MaxPool3d_2a's and 3a's shapes and at the single-video clip's
   [1,45,112,112,64]; B1..B6 also at the single-video shapes, where B*T' is
   odd (T' = 45, 23, 12), B2 with both of its uses there (3 taps, and the
   stem's 4 taps of 24 channels); B1 also at the edges of its tiling (W' =
   112, 56, 100, 128; an odd H'; T' = 1); and B1, B3..B6 on a grid holding a
   NaN and a -inf block, where NaN positions and the other values (and the
   routed gradients) must equal the plain versions;
3. the attack step, a CUDA graph replayed a step (the eval step eager),
   from a new engine, its first call's warm-up and capture included, under
   torch.profiler: launch counts of every kernel (reset just before, read
   just after), as the wrappers count them (a capture's once, added a
   replay) and as the device ran them (by kernel name in the trace: the
   warm-up's steps and the replays), must equal the per-step counts (train
   step: B1 1, B2 19, B3 9, B4 9, B5 3, B6 3, B7 1; eval step: B1 2, B3 18,
   B5 6, B7 2), losses finite, delta moved; then the same step with
   MaxPool3d_2a on the index pair (B5 2, B6 2, B9 forward 1, B9 backward 1;
   eval: B5 4, B9 forward 2 with no index), first loss and first d(delta)
   beside the default engine's; then 3 graphed steps against 3 eager steps
   from init_state, bit for bit (delta, mu, nu, every metric), and the
   graphed run's launch counts, at B=8 default, with the pair, with
   USE_PALLAS_FUSED, at B=1, T=90 on a float32 clip (B2 20, no B7), at an
   odd geometry (B=8 uint8 clips of 63x220x220: the unpacked cuDNN stem, no
   B1; B2 19, B5 2, B6 2: the generic pool at 3a's 55x55), with the L1,2
   sparse attack (a full delta [64,224,224,3], the generic path: B1 1, B2
   20, no B7) and with both cyclic rolls at B=1, T=90 (seeded; the float
   clip's counts); and for the cyclic engine, train_steps(3) against 3
   train_step calls, bit for bit, and another seed giving another delta;
4. the same engine at a small geometry in f32, in both configurations,
   against the plain versions on the CPU: loss and delta trajectory to
   tolerance;
5. timings with CUDA events (kernels, their plain versions, one library call
   where one computes the same function, the bound at the shapes; B1 also at
   the single-video clip's shape beside F.conv3d; B3 and B4 at all nine
   branch-pool shapes, B2 at its 19 launches and B5 and B6 at the three
   strided pools, each summed as one B=8 step beside its bound), the step
   time eager and graphed (in turns; and 10 replays a call) at B=8 and at
   B=1, T=90 on a float32 clip, graphed with USE_PALLAS_FUSED and with the
   pair at 2a and at 2a+3a, eager and graphed at the odd geometry, with the
   sparse attack and with the cyclic rolls, the eager peak memory and each
   graph's pool and capture time, B1 at the wide clip's [1,45,144,144,24]
   (2 column segments) and B5 and B6 at the new geometries' strided pools,
   the card's name and power limit;
6. where the step's device time goes, by torch.profiler over 2 train steps,
   graphed and eager, at B=8 and at B=1, T=90: by group, each of the port's
   kernels a step with its share (B1's among them), the slowest kernels, and
   the kernel time a step of the two beside each other;
7. the runner, default configuration (host-packed input; B7 then B1): 2
   shards x 8 records written with the port's own TFRecordWriter, labelled
   with the seeded model's clean prediction; first the input pipeline alone:
   every batch of the shards from the native reader (the runners' default)
   against the Python reader (``use_native=False``), packed and unpacked,
   bit for bit on the host and as the engine receives them on the card
   (pinned batch buffers, non-blocking copies queued behind a busy stream,
   10 batches), and each reader's host MB/s of parsed batches;
   ``configs/run_config.yml`` loaded unchanged, only paths, BATCH_SIZE,
   NUM_OF_*_TF_RECORDS and MAX_NUM_STEP overridden; 12 steps, then a resume
   to 16; exact launch counts, finite losses, res.pkl and checkpoints on
   disk, steps/s by the loop's own timer, with and without the first step
   (which captures the step graph); the 12 steps with the train step eager
   (the control); then the 12 steps under torch.profiler for the device's
   launch counts and busy share, over the whole run and over the steps
   alone (by the loop's spans, its evals taken out); then, in turns on this
   machine, the Python reader as a control (untraced for steps/s, then
   traced for the busy share; its first loss and evals equal the native
   run's), the native reader without pinned batch buffers (steps/s) and the
   native reader again (steps/s, busy share);
8. the runner with USE_PALLAS_FUSED: True (unpacked uint8; B8 forward and
   backward, the stem with an input gradient), 4 steps on the same shards;
   its first loss against the default configuration's, and the two paths'
   first d(delta) side by side;
9. the single-video runner at full width: three float32 npy clips
   [1,90,224,224,3] in [-1,1], two named with the seeded model's clean
   prediction and one with a wrong class (skipped), the two kept clips in a
   directory each (a pkl is named by class, thickness and roughness, which
   agree on random weights); ``configs/run_config.yml`` loaded unchanged,
   only NPY_PATH, PKL_RESULT_PATH and MAX_NUM_STEP overridden; run over both
   directories twice, default and with FLICKER_POOL_PALLAS_2A=2; two pkls
   on disk each time, each with every key of the result schema, finite losses, a moved delta,
   histories of total_steps + 1 entries; exact launch counts per step and per
   clean forward (float path: B1 1, B2 20, B3 9, B4 9, B5 3, B6 3, or B5 2,
   B6 2, B9 1 + 1 with the pair; no B7, no B8); the two configurations' first
   losses agree; steps/s by the loop's timer beside phase 5's graphed step;
10. the class-gen runner on phase 7's shards (read natively): one epoch (2
   batches), then a resume into a second; epoch-end checkpoints, res.pkl
   keys, launch counts as the default universal configuration's; one
   ``InferenceModel`` call, clean and adversarial, against ``engine.forward``;
11. the real-victim path at full width: ``init_i3d_state(1)`` (not seed 0,
   so that a silent random init shows) turned into the DeepMind
   checkpoint's names (``convert.i3d_var_map``), converted back bit-equal
   (``convert.convert_i3d_var_map``) and saved as a ``.pt`` by
   ``convert.cli``, which also dumps and verifies a golden file of it; the
   universal runner for 4 steps with ``CKPT_PATH`` at that file: its
   model's weights and clean logits bit-equal to a model given the state
   directly, no random-init warning, exact launch counts; then
   ``configs/run_config_rgb600.yml`` through the single-video runner, its
   only section, overriding only CKPT_PATH, NPY_PATH, PKL_RESULT_PATH and
   MAX_NUM_STEP: 1, on one float32 clip [1,90,224,224,3] named with its
   clean prediction among the 600 classes, from a 600-way checkpoint with
   bare names made the same way: a pkl on disk, finite losses, exact
   launch counts.  The card has no TensorFlow, so the TF bundle reader
   itself is held on the CPU only (tests/test_torch_port_convert.py);
12. the universal runner with FLICKERING_ATTACK: False (the L1,2 sparse
   attack) on phase 7's shards, 4 steps: exact counts (B1 1, B2 20, B3 9, B4
   9, B5 3, B6 3 a step, no B7, no B8), results under SUP_ATTACK, a full
   delta in the state and res.pkl, no host prepack;
13. phase 11's seed-1 state written as a ``.msgpack`` of Flax variables by
   the port's own codec (``convert.cli.save_variables``), read back
   bit-equal, and the universal runner on it for 4 steps: the weights, the
   history and the final delta of phase 11's ``.pt`` run, bit for bit;
14. the single-video runner with CYCLIC_ATTACK and
   CYCLIC_PERTURBATION_ATTACK on one clip: exact counts, a pkl;
15. a float32 clip [1,90,288,288,3] (W' = 144 at the stem, B1 in 2 column
   segments): up to Mixed_5c with an input gradient, exact counts, the stem
   against B1's plain version; then through the single-video runner, which
   refuses the Logits' unsqueezable 3x3 map after B1 ran (the JAX package's
   model raises there too);
16. the torch world (no kernel of the port on its path: every wrapper's
   count stays 0): each video ResNet at the reference's cell (r3d_18 B=16,
   mc3_18 B=20, r2plus1d_18 B=16, each 16x112x112 uint8; r2plus1d_34 B=16,
   32x112x112), bf16, seeded torchvision-layout weights written to a .pth and
   loaded through ``build_victim``: 3 graphed ``train_step`` calls (max_norm
   escalated x1.3 before the third: no new graph) and a graphed
   ``train_eval_step`` against the eager steps, bit for bit; graphed and
   eager ms a step, the graphs' pools and the eager peak; for r2plus1d_18,
   under torch.profiler, kernel ms a step by group, the busy share, the
   stem's forward and input-gradient ms, the convolutions by shape, and no
   kernel of ``ops.kernels.KERNEL_SYMBOLS`` in the trace; then
   ``runners.torch_universal`` on r2plus1d_18 (2 epochs of 4 train and 2
   valid batches, a resume to epoch 3, the .npy schema), with
   ``VideoDataset._decode`` replaced by seeded uint8 frames (the card has no
   cv2); ``runners.torch_per_video`` on 3 such clips (one mislabelled and
   skipped, a rerun skipped by the ledger for each fooled clip, n_iter 10 so
   that the escalation runs to its end); and the YAML universal runner with
   ``MODEL_NAME: r2plus1d_18`` on native-read shards of 16x112x112 clips it
   writes (no host prepack);
17. the vectorized per-video sweep (``engine/vector_sweep.py``): B7 with a
   dl a clip ("B7c") bit-equal to its plain version at [4,45,112,112,24] in
   bf16 and f32 with bound hits at -1 and +1, without a mask, and equal to
   the shared form where every clip has one dl, timed beside its bound; the
   slot step on 4 uint8 I3D clips [1,90,224,224,3] (the packed head with
   B7c; the escalate family at n_iter 3: 16 steps and 4 escalations a clip)
   as one graphed chunk from a new sweep engine, its counts reset just before
   and read just after (B1 1, B2 19, B3 9, B4 9, B5 3, B6 3, B7 1 with a dl a
   clip a slot step, as the wrappers count them and as the device ran them,
   the capture's warm-up included), bit-equal to the same chunk run eagerly
   (state and every output), and each slot against ``sweep.fit_single_video``
   of its clip and seed (the sequential graphed step at B=1): equal step
   counts, verdicts and escalations, delta within 1% of its movement and
   losses within 3e-5; then (17f) B8 with a delta a clip ("B8c") at the
   slot step's shape [4,90,224,224,3] with deltas [4,90,1,1,3] (a black
   pixel exactly on -1): forward bit-equal and d(delta) within 1e-5 of its
   largest component against its plain version, each clip's forward and
   d(delta) bit-equal to the shared-delta B8 launched on that clip alone,
   timed beside its bound, the plain version and B8 at the same shape with
   the card's name and power limit; and the slot step with USE_PALLAS_FUSED
   on the same uint8 clips (B8c forward and backward, B1 1, B2 20, B3 9, B4
   9, B5 3, B6 3, no B7 a slot step), checked as the packed one: counts,
   graphed against eager, each slot against the sequential fused step;
   clip-steps/s at 1, 2, 4 and 8 slots against the
   sequential B=1 step, with each graph's pool; the single-video runner with
   SLOTS: 4 against SLOTS: 1 on three float32 clips [1,90,224,224,3] and a
   misnamed one, each clip starting from a drawn delta (pkl names by the
   reference's convention, schema, steps, verdicts, the final delta within
   1% of its movement, losses within 3e-5, exact counts: one chunk of 64
   slot steps and 4 clean forwards); and ``runners.torch_per_video`` with
   slots=4 on phase 16's sweep (its counts, files and schema, a rerun skipped
   by the ledger, no kernel of the port);
18. data parallel over ranks (``parallel/mesh.py``): (a) world 1 over NCCL
   in this process (a ``file://`` store): the universal runner on phase 7's
   shards for its 12 steps through the group, the train step's all-reduce
   captured in its graph (a device all-reduce called inside a capture),
   history and final delta bit-equal to phase 7's run, launch counts as
   phase 3's per-step counts; the graphed B=8 step timed with and without
   the world-1 all-reduce (in turns, bit-equal deltas); the universal CLI
   once under ``python -m torch.distributed.run --standalone
   --nproc-per-node 1`` (torchrun's environment: "rank 0 of 1 (nccl)", 2
   steps, res.pkl); (b) two spawned ranks on the one card over gloo with
   eager steps (NCCL refuses two ranks on one card): I3D at B=8 uint8 clips
   of 64x224x224, 4 a rank, 3 steps from a drawn delta with USE_LOGITS and
   beta0 setting the adversarial and regularizer gradients' mean sizes
   equal, against one process's eager steps on the same global batch, in
   bf16 and in f32: delta bit-equal across the ranks, the mean |delta
   difference| over the mean movement and the losses within DP_LIMITS, B1-B7
   launched on every rank (``scripts/torch_parallel_fault.py`` shows planted
   reduction faults failing these limits); with two or more cards the same
   over NCCL with graphed steps, else a line saying why not; (c)
   ``torch_per_video --slots 4 --mesh`` over two spawned ranks (gloo, 2
   slots a rank) on phase 16's videos: counts, files, steps, escalations and
   verdicts those of phase 17e's run in one process.  Spawned ranks run
   under their own time limit (DP_JOIN_S) and are killed past it;
19. the float schema: 2 seeded f32 clips [16,224,224,3] written as
   float-schema records (``make_float_example``), read back through
   ``tfrecord_batches(schema="float")`` into pinned buffers, equal to the
   arrays, and one graphed universal-engine step on that batch bit-equal to
   the same step on the arrays (launches a float clip's).  Decoding mp4 and
   the live dashboard need cv2 and matplotlib, which the card's machine
   lacks: they are held on the CPU only (tests/test_torch_port_data_prep.py,
   tests/test_torch_port_live_labels.py);
20. the last modules: (a) the TV-L1 flow (``data/optical_flow.py``) on the
   card at the reference's geometry: a seeded textured gray clip of 64
   frames at 256x340 (the reference's resize of a 4:3 frame to a min side of
   256), each frame moved by a known whole-pixel shift, its 63 pairs as one
   batch at the defaults (5 scales, 5 warps, 30 iterations): every pair's
   interior median within 0.5 px of its shift, a second run bit-equal,
   ``frames_to_flow`` to [1,63,224,224,2] equal to the postprocessed flow,
   and 2 pairs of 64x80 against the port's CPU flow (FLOW_CARD_ATOL_PX);
   seconds a clip, ms a pair, peak memory and kernels launched; (b)
   ``utils.profiling.trace_steps`` around 3 replays of the graphed B=8 step
   (the trace names B1's and B4's kernels), ``ops.accounting.recording()``
   around one eager B=8 step (calls by tag equal to the wrappers' launches,
   a train step's, and to the same step's on a CPU copy at 2x8x32x32), and
   each kernel's accounted bytes and FLOPs at its timed shape giving PERF.md
   section 6's bound within 1% (TABLE_BOUNDS); (c)
   ``data.grain_pipeline.GrainEpochLoader`` with 2 spawned workers over 2
   epochs of phase 7's shards: each epoch the native reader's pass as a
   multiset, in exact batches of 8, its host MB/s, and one graphed step on
   its first batch.  ``tfrecord.make_tf_dataset``, ``viz.stats_plots``,
   ``viz.aggregate``, ``convert.fake_assets.write_i3d_saver_checkpoint``
   and the mp4 flow branch need TensorFlow, matplotlib or cv2, which the
   card's machine lacks: CPU-only host tools, held on the CPU
   (tests/test_torch_port_loaders.py, tests/test_torch_port_tools.py,
   tests/test_torch_port_flow.py).

Before phase 1 it prints ``utils.system.system_info()`` and
``device_kind()`` and fails unless ``num_devices()`` equals
``torch.cuda.device_count()``.

Prints the kernel table as one JSON line (a kernel's launches: those that ran
on the device in phase 3's traced run of its path; B7c's, B7's kernel at the
slot step's shape, and B8c's in phase 17's), then as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, without CUDA or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import zlib
from collections import defaultdict
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))

B, T, SIZE, CLASSES, SEED, STEPS = 8, 64, 224, 400, 0, 1
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PROFILE_STEPS = 2
# kernel names of cuDNN / cuBLAS / CUTLASS convolutions and matrix products
CONV_MARKS = ("conv", "cudnn", "xmma", "gemm", "sm90", "cutlass", "dgrad", "wgrad", "implicit")
NAMES = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8f", "B8b", "B9f", "B9b", "B8cf", "B8cb")
# the C launcher each wrapper calls (ops/kernels.py KERNEL_SYMBOLS names the
# kernels each starts)
LAUNCHERS = dict(zip(NAMES, (
    "fav_stem_conv_bn_relu", "fav_temporal_combine", "fav_pool_s1_fwd", "fav_pool_s1_bwd",
    "fav_pool_s2_fwd", "fav_pool_s2_bwd", "fav_emit_adv_mask", "fav_fused_apply_fwd",
    "fav_fused_apply_bwd", "fav_pool_pair_fwd", "fav_pool_pair_bwd", "fav_fused_apply_clips_fwd",
    "fav_fused_apply_clips_bwd")))
# launches per step; the default configuration (packed input head) ...
TRAIN_COUNTS = dict(zip(NAMES, (1, 19, 9, 9, 3, 3, 1, 0, 0, 0, 0, 0, 0)))
EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 6, 0, 2, 0, 0, 0, 0, 0, 0)))
# ... and USE_PALLAS_FUSED: B8 instead of B7, one more B2 (the stem's input
# gradient); its evals take the generic path (no B7, no B8)
FUSED_TRAIN_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 3, 3, 0, 1, 1, 0, 0, 0, 0)))
FUSED_EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 6, 0, 0, 0, 0, 0, 0, 0, 0)))
# ... the default configuration with MaxPool3d_2a on the index pair: one B5
# and one B6 become B9 forward and backward (an eval's forwards keep no index)
PAIR_TRAIN_COUNTS = dict(zip(NAMES, (1, 19, 9, 9, 2, 2, 1, 0, 0, 1, 1, 0, 0)))
PAIR_EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 4, 0, 2, 0, 0, 2, 0, 0, 0)))
# ... and the single-video attack's float32 clip (generic path: the victim's
# own forward with an input gradient, so B2 once more for the stem; no B7, no
# B8), per step and per clean forward, default and with the pair at 2a
SV_STEP_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 3, 3, 0, 0, 0, 0, 0, 0, 0)))
SV_CLEAN_COUNTS = dict(zip(NAMES, (1, 0, 9, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0)))
SV_PAIR_STEP_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 2, 2, 0, 0, 0, 1, 1, 0, 0)))
SV_PAIR_CLEAN_COUNTS = dict(zip(NAMES, (1, 0, 9, 0, 2, 0, 0, 0, 0, 1, 0, 0, 0)))
# ... the L1,2 sparse attack on uint8 clips: the generic path (a full delta
# takes no packed head), so the stem's input gradient adds a B2; no B7, no B8
# (a train step, and an eval step's two forwards)
SPARSE_TRAIN_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 3, 3, 0, 0, 0, 0, 0, 0, 0)))
SPARSE_EVAL_COUNTS = dict(zip(NAMES, (2, 0, 18, 0, 6, 0, 0, 0, 0, 0, 0, 0, 0)))
# ... an odd geometry, uint8 clips of ODD_FRAMES x ODD_SIZE^2: the unpacked
# cuDNN stem (no B1, and no B2 in its backward), B5/B6 at MaxPool3d_2a
# (110x110) and 4a (28x28), the generic pool at 3a (55x55)
ODD_FRAMES, ODD_SIZE = 63, 220
ODD_TRAIN_COUNTS = dict(zip(NAMES, (0, 19, 9, 9, 2, 2, 0, 0, 0, 0, 0, 0, 0)))
# ... a clip wider than 256 (WIDE_SIZE: W' = 144, B1 in 2 column segments) up
# to Mixed_5c with an input gradient, and its clean forward to the Logits
WIDE_SIZE, WIDE_FORWARD_COUNTS = 288, dict(zip(NAMES, (2, 20, 9, 9, 3, 3, 0, 0, 0, 0, 0, 0, 0)))
WIDE_CLEAN_COUNTS = dict(zip(NAMES, (2, 0, 9, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0)))
CYCLIC_SEED = 7
# the input of each Mixed block's branch_3 pool in a train step: B3's and
# B4's nine launches (4c, 4d and 4e share a shape, as 5b and 5c do)
POOL_STEP = {"Mixed_3b": (B, T // 2, 28, 28, 192), "Mixed_3c": (B, T // 2, 28, 28, 256),
             "Mixed_4b": (B, T // 4, 14, 14, 480), "Mixed_4c": (B, T // 4, 14, 14, 512),
             "Mixed_4d": (B, T // 4, 14, 14, 512), "Mixed_4e": (B, T // 4, 14, 14, 512),
             "Mixed_4f": (B, T // 4, 14, 14, 528), "Mixed_5b": (B, T // 8, 7, 7, 832),
             "Mixed_5c": (B, T // 8, 7, 7, 832)}
# B2's 19 launches a train step: the input gradient of Conv3d_2c and of the
# two 3x3x3 convs of each Mixed block, as (name, [B,T,H,W], Cin); 3 taps,
# t_plo 1 (Mixed_4c/4d's Branch_2 and 4e/4f's share a shape)
COMBINE_STEP = [("Conv3d_2c", (B, T // 2, 56, 56), 64)] + [
    (f"Mixed_{block} Branch_{branch}", dims, cin)
    for block, dims, cins in (("3b", (B, T // 2, 28, 28), (96, 16)),
                              ("3c", (B, T // 2, 28, 28), (128, 32)),
                              ("4b", (B, T // 4, 14, 14), (96, 16)),
                              ("4c", (B, T // 4, 14, 14), (112, 24)),
                              ("4d", (B, T // 4, 14, 14), (128, 24)),
                              ("4e", (B, T // 4, 14, 14), (144, 32)),
                              ("4f", (B, T // 4, 14, 14), (160, 32)),
                              ("5b", (B, T // 8, 7, 7), (160, 32)),
                              ("5c", (B, T // 8, 7, 7), (192, 48)))
    for branch, cin in zip((1, 2), cins)]
RUNNER_STEPS, RESUME_STEPS, FUSED_STEPS = 12, 16, 4
SHARDS, PER_SHARD = 2, 8
PIPE_REPEAT = 5  # passes over the shards in phase 7's pinned-pipeline check
VICTIM_STEPS = 4  # the universal runner on a checkpoint file (phase 11)
SV_FRAMES, SV_MAX_NUM_STEP = 90, 1   # hard cap 40 * MAX_NUM_STEP steps a clip
SV_RESULT_KEYS = {
    "correct_cls", "correct_cls_id", "correct_cls_prob", "softmax_init", "rgb_sample",
    "total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l", "diff_norm_reg_loss_l",
    "perturbation", "adv_video", "softmax", "total_steps", "beta_0", "beta_1", "beta_2", "beta_3",
    "fatness", "smoothness", "is_adversarial", "final_delta", "steps_per_sec",
}
CLASS_GEN_KEYS = {
    "total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l", "diff_norm_reg_loss_l",
    "perturbation", "total_steps", "beta_1", "beta_2", "fatness", "smoothness", "fool_rate",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_name_and_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


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
    are left out.  A graph replay's kernels belong to its cudaGraphLaunch.
    None when the trace holds no evals or no launch records."""
    from torch.autograd import DeviceType

    events = prof.events()
    evals = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == eval_span and e.device_type == DeviceType.CPU)
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith(
                    ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch"))}
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


def graph_stats(engine) -> str:
    """The engine's step graphs: clip shape, pool GB, warm-up and capture s."""
    return "; ".join(f"graph of clip {list(key[0])}: pool {st['pool_bytes'] / 1e9:.3f} GB, "
                     f"warm-up and capture {st['capture_s']:.2f} s"
                     for key, st in engine.graph_stats().items())


def read_counts(ops) -> dict:
    """The wrappers' launch counts by kernel, B1..B9 and B8c (B7's launches
    with a delta a clip, which B7's count includes and which it also counts
    apart, are read where the slot step runs)."""
    return {name.split()[0]: n for name, n in ops.launch_counts().items()
            if name.split()[0] in NAMES}


def device_launches(prof, kernels) -> dict:
    """Each wrapper's kernel launches that ran on the device in a
    torch.profiler trace, by kernel name: a graph replay's kernels are events
    like an eager launch's.  A launch of B8's backward (B8c's) starts two
    kernels and is counted by its final one."""
    rows = kernel_rows(prof)
    out = {}
    for name, launcher in LAUNCHERS.items():
        marks = kernels.KERNEL_SYMBOLS[launcher]
        if name in ("B8b", "B8cb"):
            marks = marks[-1:]
        out[name] = int(sum(n for _, n, key in rows if any(m in key for m in marks)))
    return out


def scaled(counts: dict, k: int, plus: dict = None) -> dict:
    """k * counts (+ plus), by kernel."""
    return {name: k * counts[name] + (plus[name] if plus else 0) for name in NAMES}


# phase 16, the torch world: each video ResNet at its reference cell
# (variant, B, T; 112x112 uint8 clips), bf16, seeded torchvision-layout weights
RESNET_CELLS = (("r3d_18", 16, 16), ("mc3_18", 20, 16), ("r2plus1d_18", 16, 16),
                ("r2plus1d_34", 16, 32))
RESNET_SIZE, RESNET_SEED = 112, 1
# the escalating bound of the graphed-vs-eager steps: the third step's is
# 1.3 times the first two's (lr 1e-3: delta reaches it by the third step)
RESNET_MAX_NORMS = (0.0015, 0.0015, 0.00195)
TW_TRAIN, TW_VALID, TW_EPOCHS = 4, 2, 2  # batches of the epoch fit, epochs before the resume
TW_FRAMES = (20, 128, 171)               # the stub decoder's frames a video
TW_SWEEP_ITERS, TW_SWEEP_GAP = 10, 0.02
TW_YAML_STEPS, TW_YAML_SHARDS, TW_YAML_PER_SHARD = 4, 2, 8
EPOCH_KEYS = {f"{p}/{k}" for p in ("train", "valid") for k in (
    "time", "loss", "fooling_ratio", "pert_thickness", "pert_roughness", "inf_norm",
    "perturbation", "steps_per_sec")}
SWEEP_KEYS = {"loss/total", "loss/adv_loss", "loss/reg_loss", "perturbation/thickness",
              "perturbation/roughness", "perturbation/inf_norm", "perturbation",
              "prob_clean_input", "label", "is_adversarial", "final_max_norm", "escalations",
              "steps_per_sec"}


def torch_world_phase(tmp: str, dev) -> dict:
    """Phase 16: the torch world (the video ResNets, the mean/std attack,
    the epoch fit, the per-video sweep and the YAML runner) at full width.
    No kernel of the port lies on this path: each wrapper's count must stay 0
    and no kernel of ``ops.kernels.KERNEL_SYMBOLS`` may run in a traced step.
    Returns the per-video sweep's set-up and results (phase 17 runs it again
    with slots)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
    from flickering_adversarial_video_tpu_torch.convert import write_torchvision_pth
    from flickering_adversarial_video_tpu_torch.data import (
        TFRecordWriter, VideoDataset, VideoRecord, make_uint8_example)
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.engine.epoch_fit import find_resume
    from flickering_adversarial_video_tpu_torch.engine.sweep import result_path_for
    from flickering_adversarial_video_tpu_torch.models.video_resnet import stem_conv_packed
    from flickering_adversarial_video_tpu_torch.ops import kernels
    from flickering_adversarial_video_tpu_torch.runners import (
        common, torch_per_video, torch_universal, universal)
    from flickering_adversarial_video_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    symbols = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]
    meanstd = AttackConfig(norm_world="meanstd", reg_weighting="torch")
    zero = {name: 0 for name in NAMES}

    def bit_equal(a, b):
        if not torch.is_tensor(a):
            return a == b
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    def outcome(state, metrics):
        return [state.delta.clone(), state.mu.clone(), state.nu.clone(), state.step] + [
            m[k].clone() if torch.is_tensor(m[k]) else m[k] for m in metrics for k in sorted(m)]

    def no_port_kernels(prof) -> bool:
        return not any(any(sym in r[2] for sym in symbols) for r in kernel_rows(prof))

    def victim(variant, t, pth):
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            model = common.build_victim(variant, pth, torch.bfloat16, t, RESNET_SIZE, device=dev)
        if "[warn]" in said.getvalue():
            fail(f"{variant}: build_victim did not load {pth}")
        return model

    # ---- 16a. each variant at its reference cell -------------------------------------
    for variant, b, t in RESNET_CELLS:
        t0 = time.perf_counter()
        pth = write_torchvision_pth(os.path.join(tmp, f"{variant}.pth"), variant, 400, RESNET_SEED)
        model = victim(variant, t, pth)
        rng = np.random.default_rng(RESNET_SEED)
        video = torch.from_numpy(rng.integers(0, 256, (b, t, RESNET_SIZE, RESNET_SIZE, 3),
                                              dtype=np.uint8)).to(dev)
        probe = AttackEngine(model, TorchStyleFlickerSpec(t), meanstd, track_probs=True)
        labels = probe.forward(None, {"video": video, "labels": torch.zeros(b, dtype=torch.long,
                                                                            device=dev)},
                               adversarial=False).argmax(-1)
        batch = {"video": video, "labels": labels}
        flags = [RuntimeFlags(max_norm=m) for m in RESNET_MAX_NORMS]
        spec = TorchStyleFlickerSpec(t, max_norm=RESNET_MAX_NORMS[0])

        def run(graphed, kind):
            e = AttackEngine(model, spec, meanstd, track_probs=True)
            s, ms = e.init_state(), []
            for f in (flags if kind == "train" else flags[:1]):
                if graphed:
                    s, m = (e.train_step if kind == "train" else e.train_eval_step)(s, batch, f)
                else:
                    step = e._train_step if kind == "train" else e._train_eval_step
                    s, m = step(s, *e.prepare_batch(batch), f)
                ms.append(m)
            torch.cuda.synchronize()
            return outcome(s, ms), e

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        results = {}
        for kind in ("train", "train_eval"):
            eager, _ = run(False, kind)
            graphed, e = run(True, kind)
            n_graphs = len(e.graph_stats())
            results[kind] = (len(graphed) == len(eager) and all(map(bit_equal, graphed, eager)),
                             n_graphs, eager, graphed)
            del e
        counts = read_counts(ops)
        tr, te = results["train"], results["train_eval"]
        print(f"[torch world] {variant} B={b} T={t} {RESNET_SIZE}x{RESNET_SIZE} bf16 from "
              f"{os.path.basename(pth)} through build_victim: 3 graphed train steps (max_norm "
              f"{RESNET_MAX_NORMS}) against 3 eager: {'bit-equal' if tr[0] else 'DIFFER'} "
              f"({len(tr[2]) - 4} metrics, {tr[1]} graph); train_eval_step graphed against eager: "
              f"{'bit-equal' if te[0] else 'DIFFER'} ({te[1]} graph); the port's kernels "
              f"launched {counts} ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not (tr[0] and te[0]):
            fail(f"{variant}: a graphed step differs from its eager step")
        if tr[1] != 1:
            fail(f"{variant}: the max_norm change captured another graph ({tr[1]} graphs)")
        if counts != zero:
            fail(f"{variant}: a kernel of the port was launched on the torch-world path")
        del results, tr, te

        engine = AttackEngine(model, spec, meanstd, track_probs=True)
        state = engine.init_state()
        state, _ = engine.train_step(state, batch, flags[0])
        torch.cuda.reset_peak_memory_stats()
        eager_ms = [cuda_ms(torch, lambda: engine._train_step(
            state, *engine.prepare_batch(batch), flags[0]), iters=3, warmup=1)]
        eager_peak = torch.cuda.max_memory_allocated() / 1e9
        graph_ms = [cuda_ms(torch, lambda: engine.train_steps(state, batch, flags[0], 1),
                            iters=5, warmup=1)]
        eager_ms.append(cuda_ms(torch, lambda: engine._train_step(
            state, *engine.prepare_batch(batch), flags[0]), iters=3, warmup=1))
        graph_ms.append(cuda_ms(torch, lambda: engine.train_steps(state, batch, flags[0], 1),
                                iters=5, warmup=1))
        te_ms = cuda_ms(torch, lambda: engine.train_eval_step(state, batch, flags[0]), iters=5,
                        warmup=1)
        print(f"[time] torch world {variant} B={b} T={t}: train step eager {eager_ms[0]:.2f}, "
              f"{eager_ms[1]:.2f} ms; graphed {graph_ms[0]:.2f}, {graph_ms[1]:.2f} ms "
              f"({1000 / min(graph_ms):.3f} steps/s); train_eval_step graphed {te_ms:.2f} ms; "
              f"eager peak memory {eager_peak:.2f} GB; {graph_stats(engine)}", flush=True)

        if variant == "r2plus1d_18":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags[0], 1),
                               iters=PROFILE_STEPS, warmup=0)
            rows = kernel_rows(prof, PROFILE_STEPS)
            busy = sum(r[0] for r in rows)
            conv = sum(r[0] for r in rows if any(m in r[2].lower() for m in CONV_MARKS))
            clean = no_port_kernels(prof)
            x = engine._normalize(video).to(torch.bfloat16)
            w = model.stem[0].weight
            g = torch.randn(stem_conv_packed(x, w).shape, device=dev).bfloat16()

            def stem_fwd():
                with torch.no_grad():
                    stem_conv_packed(x, w)

            def stem_fwd_dgrad():
                xx = x.detach().requires_grad_(True)
                stem_conv_packed(xx, w).backward(g)

            fwd_ms, both_ms = cuda_ms(torch, stem_fwd), cuda_ms(torch, stem_fwd_dgrad)
            if busy > 0:
                print(f"[profile] torch world {variant} B={b} T={t}, graphed, {PROFILE_STEPS} "
                      f"train steps: wall {wall:.2f} ms/step; kernels {busy:.2f} ms/step in "
                      f"{sum(r[1] for r in rows):.0f} launches/step, device busy "
                      f"{busy / wall:.1%}; convolution / matmul (cuDNN, cuBLAS) {conv:.2f} ms "
                      f"({conv / busy:.1%}), other {busy - conv:.2f} ms ({1 - conv / busy:.1%})",
                      flush=True)
                for ms, n, name in sorted(rows, reverse=True)[:8]:
                    print(f"[profile]   slowest: {ms:8.3f} ms/step {n:5.1f} launches/step  "
                          f"{name[:90]}")
            else:
                print("[profile] torch world: torch.profiler saw no device time: breakdown not "
                      "measured", flush=True)
            print(f"[profile] torch world {variant}: the stem's first conv (space-to-depth "
                  f"packed, {list(x.shape)} -> {list(g.shape)}) forward {fwd_ms:.3f} ms, input "
                  f"gradient {both_ms - fwd_ms:.3f} ms ({both_ms / min(graph_ms):.1%} of the "
                  f"graphed step); no kernel of the port ran in the traced steps: {clean}",
                  flush=True)
            if not clean:
                fail("a kernel of the port ran in a video-ResNet step")
            # the convolutions of one eager step by op and input shape
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                engine._train_step(state, *engine.prepare_batch(batch), flags[0])
                torch.cuda.synchronize()
            convs = [e for e in prof.key_averages(group_by_input_shape=True)
                     if e.key in ("aten::cudnn_convolution", "aten::convolution_backward")]
            for e in sorted(convs, key=lambda e: -getattr(e, "device_time_total", 0))[:10]:
                print(f"[profile]   conv op {e.key} x{e.count}: "
                      f"{getattr(e, 'device_time_total', 0) / 1e3:.3f} ms, input shapes "
                      f"{str(e.input_shapes)[:150]}", flush=True)
            del x, g, prof
        del engine, state, probe, model, batch, video
        torch.cuda.empty_cache()

    # ---- 16b. the epoch fit: runners.torch_universal on r2plus1d_18 -------------------
    # the card has no cv2: VideoDataset._decode is replaced by a seeded uint8
    # frame source of TW_FRAMES (what the decoder gives for a 128-pixel-high
    # video), which the real temporal sampling, resize (a no-op at 128) and
    # crop to 112 consume; each video labelled with the victim's clean
    # prediction of its center crop (the valid phase's clip)
    decoded = stub_decode

    def clean_labels(model, paths):
        """The victim's clean predictions of the center-crop clips of `paths`."""
        ds = VideoDataset([VideoRecord(p, 0) for p in paths], sample_length=t,
                          input_size=RESNET_SIZE, random_offset=False, random_crop=False,
                          random_flip=False)
        probe = AttackEngine(model, TorchStyleFlickerSpec(t), meanstd)
        out = []
        for batch in ds.batches(b, drop_remainder=False, shuffle=False):
            out += probe.forward(None, {"video": torch.from_numpy(batch["video"]).to(dev),
                                        "labels": torch.from_numpy(batch["labels"]).to(dev)},
                                 adversarial=False).argmax(-1).tolist()
        return out

    variant, b, t = "r2plus1d_18", 16, 16
    pth = os.path.join(tmp, f"{variant}.pth")
    paths = [f"v{i:03d}.mp4" for i in range((TW_TRAIN + TW_VALID) * b)]
    fit_dir = os.path.join(tmp, "torch_universal")
    t0 = time.perf_counter()
    with mock.patch.object(VideoDataset, "_decode", lambda self, path: decoded(path)):
        records = [VideoRecord(p, c) for p, c in zip(paths, clean_labels(victim(variant, t, pth),
                                                                          paths))]
        train, valid = records[:TW_TRAIN * b], records[TW_TRAIN * b:]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            first = torch_universal.run(variant, train_records=train, valid_records=valid,
                                        ckpt_path=pth, epochs=TW_EPOCHS, model_dir=fit_dir,
                                        sample_length=t, input_size=RESNET_SIZE, device=dev)
            delta0, at = find_resume(fit_dir, variant)
            resumed = torch_universal.run(variant, train_records=train, valid_records=valid,
                                          ckpt_path=pth, epochs=TW_EPOCHS + 1, model_dir=fit_dir,
                                          sample_length=t, input_size=RESNET_SIZE, device=dev)
        torch.cuda.synchronize()
        counts = read_counts(ops)
    files = sorted(f for f in os.listdir(fit_dir) if f.endswith(".npy"))
    saved = np.load(os.path.join(fit_dir, files[-1]), allow_pickle=True).tolist()
    schema = all(set(r) == EPOCH_KEYS for r in first + resumed + saved)
    ok = (schema and len(first) == TW_EPOCHS and len(resumed) == 1 and at == TW_EPOCHS
          and files == [f"{variant}_{e:03d}.npy" for e in range(1, TW_EPOCHS + 2)]
          and f"resuming from epoch {TW_EPOCHS}" in said.getvalue()
          and all(math.isfinite(r["train/loss"]) for r in first + resumed)
          and np.abs(first[-1]["valid/perturbation"]).max() > 0
          and delta0.shape == (t, 1, 1, 3) and "[warn]" not in said.getvalue())
    rates = [round(r[f"{p}/steps_per_sec"], 3) for r in first + resumed for p in ("train", "valid")]
    print(f"[torch world] runners.torch_universal on {variant} (decoder stubbed: seeded uint8 "
          f"frames {list(TW_FRAMES)}, no cv2 on the card): {TW_EPOCHS} epochs of {TW_TRAIN} train "
          f"and {TW_VALID} valid batches of {b}, then a resume to epoch {TW_EPOCHS + 1}: files "
          f"{files}, schema {'as the JAX package' if schema else 'WRONG'}; train/valid fooling "
          f"{[(r['train/fooling_ratio'], r['valid/fooling_ratio']) for r in first + resumed]}, "
          f"losses {[round(r['train/loss'], 5) for r in first + resumed]}, steps/s by phase "
          f"{rates}; the port's kernels launched {counts} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not ok or counts != zero:
        fail("torch_universal: epochs, resume, schema or launch counts")

    # ---- 16c. the per-video sweep: runners.torch_per_video ----------------------------
    # three stub videos: the first two attacked, the third labelled with a
    # class other than its clean prediction (skipped); then a rerun over the
    # ledger, which skips every fooled video.  Seeded weights answer a clip
    # of noise with nearly the same logits whatever the clip (a top-1/top-2
    # gap near 1.1), which tens of flicker steps do not close; so the
    # sweep's victim is the seeded one with its fc bias moved to leave the
    # first clip's top two logits TW_SWEEP_GAP apart
    sweep_dir = os.path.join(tmp, "torch_per_video")
    t0 = time.perf_counter()
    with mock.patch.object(VideoDataset, "_decode", lambda self, path: decoded(path)):
        cands = [VideoRecord(f"sweep{i}.mp4", 0) for i in range(3)]
        ds = VideoDataset(cands, sample_length=t, input_size=RESNET_SIZE, random_offset=False,
                          random_crop=False, random_flip=False)

        def clean_logp(model):
            probe = AttackEngine(model, TorchStyleFlickerSpec(t), meanstd)
            return np.log(np.concatenate([probe.forward(
                None, {"video": torch.from_numpy(batch["video"]).to(dev),
                       "labels": torch.from_numpy(batch["labels"]).to(dev)},
                adversarial=False).cpu().numpy() for batch in ds.batches(1, shuffle=False)]))

        z = clean_logp(victim(variant, t, pth))[0]
        top1, top2 = np.argsort(-z, kind="stable")[:2]
        sd = torch.load(pth, weights_only=True)
        sd["fc.bias"][top1] -= float(z[top1] - z[top2]) - TW_SWEEP_GAP
        sweep_pth = os.path.join(tmp, f"{variant}_sweep.pth")
        torch.save(sd, sweep_pth)
        logp = clean_logp(victim(variant, t, sweep_pth))
        ranked = np.sort(logp, axis=-1)
        gaps = [round(float(ranked[i, -1] - ranked[i, -2]), 5) for i in range(2)]
        sweep = [VideoRecord(r.path, int(lp.argmax())) for r, lp in zip(cands, logp)]
        sweep[2] = VideoRecord(sweep[2].path, (sweep[2].label + 1) % 400)
        labels = [f"class {i}" for i in range(400)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            out1 = torch_per_video.run(variant, records=sweep, label_names=labels,
                                       ckpt_path=sweep_pth,
                                       n_iter=TW_SWEEP_ITERS, model_dir=sweep_dir,
                                       sample_length=t, input_size=RESNET_SIZE, device=dev)
            out2 = torch_per_video.run(variant, records=sweep, label_names=labels,
                                       ckpt_path=sweep_pth,
                                       n_iter=TW_SWEEP_ITERS, model_dir=sweep_dir,
                                       sample_length=t, input_size=RESNET_SIZE, device=dev)
        torch.cuda.synchronize()
        counts = read_counts(ops)
    res = [np.load(result_path_for(sweep_dir, r.path, labels[r.label]), allow_pickle=True).tolist()
           for r in sweep[:2]]
    fooled = [bool(np.any(r["is_adversarial"])) for r in res]
    schema = all(set(r) == SWEEP_KEYS for r in res)
    ok = (schema and out1["attacked"] == 2 and out1["skipped_misclassified"] == 1
          and out2["skipped_existing"] == sum(fooled) and sum(fooled) >= 1
          and out2["skipped_misclassified"] == 1 and out2["attacked"] == 2 - sum(fooled)
          and all(r["escalations"] <= 4 and r["perturbation/inf_norm"] <= r["final_max_norm"]
                  for r in res)
          and all(math.isfinite(v) for r in res for v in r["loss/total"]))
    print(f"[torch world] runners.torch_per_video on {variant}, n_iter {TW_SWEEP_ITERS}, fc "
          f"bias moved by {float(z[top1] - z[top2]) - TW_SWEEP_GAP:.4f} at class {top1}: the "
          f"attacked videos' clean top-1/top-2 log-prob gaps {gaps}: first "
          f"run {({k: v for k, v in out1.items() if k != 'results'})}, rerun over the ledger "
          f"{({k: v for k, v in out2.items() if k != 'results'})}; per attacked video: steps "
          f"{[len(r['loss/total']) for r in res]}, escalations {[r['escalations'] for r in res]}, "
          f"final max_norm {[round(r['final_max_norm'], 5) for r in res]}, fooled {fooled}, "
          f"first and last losses {[(round(r['loss/total'][0], 5), round(r['loss/total'][-1], 5)) for r in res]}, "
          f"steps/s {[round(r['steps_per_sec'], 2) for r in res]}; schema "
          f"{'as the JAX package' if schema else 'WRONG'}; the port's kernels launched {counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok or counts != zero:
        fail("torch_per_video: skips, ledger, escalation bound, schema or launch counts")
    sweep_run = {"variant": variant, "frames": t, "records": sweep, "labels": labels,
                 "ckpt": sweep_pth, "dir": sweep_dir, "first": out1, "results": res,
                 "decoded": decoded}

    # ---- 16d. the YAML universal runner with MODEL_NAME: r2plus1d_18 ------------------
    # native-read shards of 16x112x112 clips labelled with the victim's clean
    # predictions; the mean/std world takes no host prepack
    shard_dir = os.path.join(tmp, "torch_world_shards")
    os.makedirs(shard_dir)
    cfg = load_config(os.path.join(HERE, "configs", "run_config.yml"))
    ac = cfg.UNIVERSAL_ATTACK
    ac.MODEL_NAME, cfg.MODEL.CKPT_PATH = variant, pth
    ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shard_dir]
    ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = TW_YAML_SHARDS
    ac.BATCH_SIZE, ac.MAX_NUM_STEP = TW_YAML_PER_SHARD, TW_YAML_STEPS
    ac.PKL_RESULT_PATH = os.path.join(tmp, "torch_world_yaml") + "/"
    t0 = time.perf_counter()
    model = victim(variant, t, pth)
    probe = AttackEngine(model, TorchStyleFlickerSpec(t), meanstd)
    rng = np.random.default_rng(RESNET_SEED + 1)
    for s_i in range(TW_YAML_SHARDS):
        clips = rng.integers(0, 256, (TW_YAML_PER_SHARD, t, RESNET_SIZE, RESNET_SIZE, 3),
                             dtype=np.uint8)
        pred = probe.forward(None, {"video": torch.from_numpy(clips).to(dev),
                                    "labels": torch.zeros(len(clips), dtype=torch.long,
                                                          device=dev)},
                             adversarial=False).argmax(-1).tolist()
        with TFRecordWriter(os.path.join(shard_dir, f"shard{s_i}.tfrecords")) as w:
            for clip, label in zip(clips, pred):
                w.write(make_uint8_example(clip, label))
    del model, probe
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        out = universal.run(cfg, frames=t, size=RESNET_SIZE, device=dev)
    torch.cuda.synchronize()
    counts = read_counts(ops)
    hist = out["history"]
    pkl = os.path.join(universal.model_dir_name(ac), "res.pkl")
    ok = (out["steps"] == TW_YAML_STEPS and os.path.exists(pkl)
          and "host-prepacked" not in said.getvalue() and "[warn]" not in said.getvalue()
          and all(math.isfinite(v) for v in hist["total_loss"])
          and out["final_eval"]["total_valid_videos"] == TW_YAML_SHARDS * TW_YAML_PER_SHARD
          and tuple(out["state"].delta.shape) == (t, 1, 1, 3))
    print(f"[torch world] YAML universal runner, MODEL_NAME {variant}, {TW_YAML_SHARDS} native-read "
          f"shards x {TW_YAML_PER_SHARD} clips [{t},{RESNET_SIZE},{RESNET_SIZE},3] uint8, no host "
          f"prepack: steps {out['steps']}, losses {[round(v, 5) for v in hist['total_loss']]}, "
          f"final fooling {out['final_eval']['miss_rate']:.4f} of "
          f"{out['final_eval']['total_valid_videos']} valid, {out['steps_per_sec']:.3f} steps/s; "
          f"the port's kernels launched {counts} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok or counts != zero:
        fail("the YAML universal runner on r2plus1d_18: steps, prepack, losses, eval or counts")
    print(f"[time] phase 16 (the torch world) {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sweep_run


# phase 17, the vectorized per-video sweep: VS_SLOTS uint8 I3D clips of
# SV_FRAMES x SIZE^2 in flight as one graphed slot step (the packed head with
# B7 reading a dl a clip, "B7c"); the escalate family at n_iter VS_ITERS, so
# that each slot runs 4 x (VS_ITERS + 1) steps and four escalations in one
# chunk
VS_SLOTS, VS_ITERS = 4, 3
VS_CHUNK = 4 * (VS_ITERS + 1) + 1
VS_TIME_SLOTS, VS_TIME_ITERS = (1, 2, 4, 8), 20
VS_INIT_SCALE = 0.005  # the initial draws' scale, sweep.fit_single_video's
# a slot's trajectory against the sequential step of its clip (bf16: cuDNN
# may take other algorithms at batch 4 than at batch 1): delta within 1% of
# its own movement over the run, every loss within 3e-5 of itself, about 5x
# what sound runs read on an H100 (0.16-0.22% and 2.2-5.2e-6; PERF.md)
VS_DELTA_SHARE, VS_LOSS_REL = 0.01, 3e-5
# launches a slot step on uint8 clips (the packed head: B7 with a dl a clip)
SLOT_STEP_COUNTS = dict(zip(NAMES, (1, 19, 9, 9, 3, 3, 1, 0, 0, 0, 0, 0, 0)))
# ... and with USE_PALLAS_FUSED: B8 with a delta a clip (B8c) forward and
# backward in place of B7, and B2 as in FUSED_TRAIN_COUNTS (the stem's input
# gradient)
SLOT_STEP_FUSED_COUNTS = dict(zip(NAMES, (1, 20, 9, 9, 3, 3, 0, 0, 0, 0, 0, 1, 1)))
VS_RUNNER_CHUNK = 64  # vector_single_video_attacks' chunk


def slot_chunk_checks(engine, clips, dev, want_counts: dict, want_clip_b7: int, head: str):
    """Phase 17b's checks of the slot step on `engine` (17f's with
    USE_PALLAS_FUSED): VS_SLOTS uint8 I3D clips `clips` [N,1,T,H,W,3], each
    labelled with the engine's clean prediction, as one graphed chunk of
    VS_CHUNK from a new sweep engine, counts reset just before and read just
    after (and the device's launches under torch.profiler) against
    `want_counts` a slot step (B7's launches with a dl a clip against
    `want_clip_b7` a slot step); bit-equal to the same chunk run eagerly; and
    each slot against ``sweep.fit_single_video`` of its clip and seed (the
    sequential graphed train_step at B=1, the same stop rule).  `head` names
    the input head in the lines printed.  Returns (videos, packed, labels as
    the engine prepared them, the device's launches of the graphed chunk)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.engine import RuntimeFlags, sweep
    from flickering_adversarial_video_tpu_torch.engine.step_graph import WARMUP_STEPS
    from flickering_adversarial_video_tpu_torch.engine.vector_sweep import (
        SlotState, VectorSweepEngine)
    from flickering_adversarial_video_tpu_torch.ops import kernels, packed_apply

    fused = engine.config.use_pallas_fused
    tag = "the fused slot step: " if fused else ""
    state_fields = [f.name for f in dataclasses.fields(SlotState)]
    flags = RuntimeFlags()
    labels = [int(engine.forward(None, {"video": torch.from_numpy(c).to(dev),
                                        "labels": torch.zeros(1, dtype=torch.long, device=dev)},
                                 adversarial=False).argmax()) for c in clips]
    videos, packed, lab = engine.prepare_batch(
        {"video": torch.from_numpy(clips[:, 0]).to(dev), "labels": torch.tensor(labels)})
    seeds = torch.arange(VS_SLOTS, device=dev)

    def fresh():
        vse = VectorSweepEngine(engine, VS_SLOTS, n_iter=VS_ITERS, init_scale=VS_INIT_SCALE)
        state = vse.init_slots()
        for i in range(VS_SLOTS):
            vse.refill_slot(state, i, i, 0.2)
        return vse, state

    vse, state = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, ys = vse.run_chunk(state, videos, lab, seeds, flags, VS_CHUNK, packed=packed)
        torch.cuda.synchronize()
    counts, device = read_counts(ops), device_launches(prof, kernels)
    clip_counts = packed_apply.emit_adv_mask.clip_launches
    first_s = time.perf_counter() - t0
    want, want_device = scaled(want_counts, VS_CHUNK), scaled(want_counts, VS_CHUNK + WARMUP_STEPS)
    g_state = {k: t.clone() for k, t in zip(state_fields, state.tensors())}
    g_ys = {k: v.clone() for k, v in ys.items()}
    stats = vse.graph_stats()
    print(f"[vector] {tag}slot step, {VS_SLOTS} uint8 clips [1,{SV_FRAMES},{SIZE},{SIZE},3] "
          f"(packed: {packed}; {head}), escalate at n_iter {VS_ITERS}: one graphed chunk of "
          f"{VS_CHUNK} from a new sweep engine (its capture's {WARMUP_STEPS} warm-up iterations "
          f"included) in {first_s:.2f} s; launches as the wrappers count them {counts} (expected "
          f"{want}), B7's with a dl a clip {clip_counts} (expected {want_clip_b7 * VS_CHUNK}); as "
          f"the device ran them {device} (expected {want_device}); graph pool "
          f"{stats['pool_bytes'] / 1e9:.3f} GB, warm-up and capture {stats['capture_s']:.2f} s",
          flush=True)
    if counts != want or device != want_device or clip_counts != want_clip_b7 * VS_CHUNK:
        fail(f"{tag}the slot step's launch counts")
    del vse, state, ys, prof
    vse_e, state_e = fresh()
    state_e, ys_e = vse_e.run_chunk(state_e, videos, lab, seeds, flags, VS_CHUNK, packed=packed,
                                    eager=True)
    torch.cuda.synchronize()
    same_state = {k: torch.equal(g_state[k], t) for k, t in zip(state_fields, state_e.tensors())}
    same_ys = {k: torch.equal(g_ys[k], ys_e[k]) for k in g_ys} if g_ys.keys() == ys_e.keys() else {}
    print(f"[vector] {tag}graphed chunk against the same chunk eager, bit for bit: state "
          f"{same_state}; outputs {same_ys}", flush=True)
    if not all(same_state.values()) or not same_ys or not all(same_ys.values()):
        fail(f"{tag}the graphed slot chunk differs from its eager run")
    del vse_e, state_e, ys_e

    active = g_ys["active"].cpu().numpy()
    post = g_ys["delta_post"].float().cpu().numpy()
    mnorm = g_ys["max_norm"].cpu().numpy()
    loss = g_ys["total_loss"].float().cpu().numpy()
    fooled = g_ys["is_adversarial"].cpu().numpy()
    rows, ok = [], True
    for i in range(VS_SLOTS):
        res = sweep.fit_single_video(engine, {"video": clips[i], "labels": np.asarray([labels[i]])},
                                     flags, n_iter=VS_ITERS, max_norm=0.2, seed=i,
                                     init_scale=VS_INIT_SCALE)
        if res is None:
            fail(f"{tag}the sequential step refused clip {i} (its clean class moved)")
        ran = np.nonzero(active[:, i])[0]
        vec_delta = np.stack([np.clip(post[t, i], -mnorm[t, i], mnorm[t, i]) for t in ran])
        seq_delta = np.asarray(res["perturbation"])
        d_err = (float(np.abs(vec_delta - seq_delta).max()) if len(ran) == len(seq_delta)
                 else math.inf)
        moved = float(np.abs(seq_delta[-1] - sweep.draw_init_delta(
            tuple(engine.spec.shape), i, VS_INIT_SCALE).numpy()).max())
        seq_loss = np.asarray(res["loss/total"])
        l_err = (float((np.abs(loss[ran, i] - seq_loss) / np.abs(seq_loss)).max())
                 if len(ran) == len(seq_loss) else math.inf)
        esc = int(g_state["chances"][i])
        same = (len(ran) == len(seq_loss) and esc == res["escalations"]
                and [bool(f) for f in fooled[ran, i]] == list(res["is_adversarial"]))
        rows.append(f"slot {i}: steps {len(ran)}/{len(seq_loss)}, escalations "
                    f"{esc}/{res['escalations']}, fooled {bool(fooled[ran, i].any())}/"
                    f"{bool(np.any(res['is_adversarial']))}, delta max |diff| {d_err:.3e} (bound "
                    f"{VS_DELTA_SHARE} x its movement {moved:.3e}), losses max relative diff "
                    f"{l_err:.3e} (bound {VS_LOSS_REL})")
        ok = ok and same and d_err <= VS_DELTA_SHARE * moved and l_err <= VS_LOSS_REL
    print(f"[vector] {tag}each slot against the sequential graphed train_step of its clip and "
          "seed (sweep.fit_single_video; vector/sequential): " + "; ".join(rows), flush=True)
    if not ok:
        fail(f"{tag}a slot's trajectory is not the sequential one: step counts, escalations, "
             "verdicts or a bound")
    return videos, packed, lab, device


def fused_slot_pass(dev, model, clips) -> list:
    """Phase 17f, kernel B8 with a delta a clip (B8c): (a) its forward and
    backward at the slot step's shape [VS_SLOTS, SV_FRAMES, SIZE, SIZE, 3]
    (a black pixel under delta 0 exactly on -1) against the plain version
    (forward bit-equal; d(delta) within 1e-5 of its largest component, f32
    sum order), and each clip's forward and d(delta) bit-equal to the
    shared-delta B8 launched on that clip alone; (b) the slot step with
    USE_PALLAS_FUSED on phase 17b's uint8 clips, through
    :func:`slot_chunk_checks` against SLOT_STEP_FUSED_COUNTS, and its time a
    slot step at VS_SLOTS slots (graphed, host clock); (c) B8c's time
    with CUDA events beside its bound, its plain version and the shared B8 at
    the same shape, with the card's name and power limit.  Returns B8c's two
    rows of the kernel table (launches: the device's in (b)'s graphed chunk)."""
    import torch

    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.engine.vector_sweep import VectorSweepEngine
    from flickering_adversarial_video_tpu_torch.ops import fused_apply

    fwd, bwd = fused_apply.fused_apply_fwd, fused_apply.fused_apply_bwd

    def counters():
        return fwd.launches, fwd.clip_launches, bwd.launches, bwd.clip_launches

    gen = torch.Generator().manual_seed(SEED + 19)
    shape = (VS_SLOTS, SV_FRAMES, SIZE, SIZE, 3)
    u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    delta = (torch.rand(VS_SLOTS, SV_FRAMES, 1, 1, 3, generator=gen) - 0.5) * 0.8
    u8[1, 3, :4, :4, 0], delta[1, 3, 0, 0, 0] = 0, 0.0
    g = torch.randn(shape, generator=gen)
    u8, delta, g = u8.to(dev), delta.to(dev), g.to(dev)
    flag = torch.ones((), device=dev)

    # ---- (a) against the plain version, and each clip against B8 on it alone
    before = counters()
    out = fwd(u8, delta, flag)
    dd = bwd(u8, delta, flag, g)
    dd2 = bwd(u8, delta, flag, g)
    torch.cuda.synchronize()
    counted = counters() == (before[0], before[1] + 1, before[2], before[3] + 2)
    ferr = (out - fused_apply.fused_apply_fwd_plain(u8, delta, flag)).abs().max().item()
    want_dd = fused_apply.fused_apply_bwd_plain(u8, delta, flag, g)
    berr = (dd - want_dd).abs().max().item()
    brel = berr / max(want_dd.abs().max().item(), 1e-30)
    per_clip = [(torch.equal(out[i:i + 1], fwd(u8[i:i + 1], delta[i], flag)),
                 torch.equal(dd[i], bwd(u8[i:i + 1], delta[i], flag, g[i:i + 1])))
                for i in range(VS_SLOTS)]
    torch.cuda.synchronize()
    print(f"[check] B8c {list(shape)}, delta [{VS_SLOTS},{SV_FRAMES},1,1,3]: forward max_abs_err "
          f"{ferr:.3e} (tolerance 0); backward max_abs_err {berr:.3e} max_rel_err {brel:.3e} "
          f"(max_rel_err tolerance 1e-5), second run "
          f"{'bit-equal' if torch.equal(dd, dd2) else 'DIFFERS'}; each clip (forward, d(delta)) "
          f"bit-equal to the shared-delta B8 launched on that clip alone: {per_clip}; counted "
          f"apart as launches with a delta a clip: {counted}", flush=True)
    if (ferr != 0 or not brel <= 1e-5 or not torch.equal(dd, dd2) or not counted
            or not all(a and b for a, b in per_clip)):
        fail("B8c disagrees with its plain version or with B8 on each clip alone, or is not "
             "counted apart")
    del out, dd, dd2, want_dd

    # ---- (b) the fused slot step on phase 17b's uint8 clips
    engine = AttackEngine(model, FlickerSpec(SV_FRAMES), AttackConfig(use_pallas_fused=True),
                          track_probs=False)
    videos, packed, lab, device = slot_chunk_checks(engine, clips, dev, SLOT_STEP_FUSED_COUNTS,
                                                    0, "B8c, a delta a clip")
    if packed is not False:
        fail("the fused slot step's clips took the packed head")
    # its time: a chunk of VS_TIME_ITERS graphed slot steps, every slot
    # stepping every iteration (17c times the packed one the same way)
    vse = VectorSweepEngine(engine, VS_SLOTS, n_iter=10 ** 9, init_scale=VS_INIT_SCALE)
    st = vse.init_slots()
    for i in range(VS_SLOTS):
        vse.refill_slot(st, i, i, 0.2)
    args = (videos, lab, torch.arange(VS_SLOTS, device=dev), RuntimeFlags(), VS_TIME_ITERS)
    st, _ = vse.run_chunk(st, *args)  # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = vse.run_chunk(st, *args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / VS_TIME_ITERS
    print(f"[time] the fused slot step, N={VS_SLOTS} uint8 clips [1,{SV_FRAMES},{SIZE},{SIZE},3] "
          f"(B8c), a chunk of {VS_TIME_ITERS} graphed slot steps (host clock to a synchronize): "
          f"{step_ms:.2f} ms a slot step, {VS_SLOTS * 1e3 / step_ms:.1f} clip-steps/s, pool "
          f"{vse.graph_stats()['pool_bytes'] / 1e9:.3f} GB", flush=True)
    del engine, vse, st, args, videos
    torch.cuda.empty_cache()

    # ---- (c) times
    smi = card_name_and_limit()
    n = u8.numel()
    rows = []
    for name, kern, plain, shared, n_bytes, err in (
            ("B8cf fused_apply_fwd, a delta a clip", lambda: fwd(u8, delta, flag),
             lambda: fused_apply.fused_apply_fwd_plain(u8, delta, flag),
             lambda: fwd(u8, delta[0], flag), n * (1 + 4) + delta.numel() * 4, ferr),
            ("B8cb fused_apply_bwd, a delta a clip", lambda: bwd(u8, delta, flag, g),
             lambda: fused_apply.fused_apply_bwd_plain(u8, delta, flag, g),
             lambda: bwd(u8, delta[0], flag, g), n * (1 + 4) + 2 * delta.numel() * 4, berr)):
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        shared_ms = cuda_ms(torch, shared)
        # u8 (and g) read, f32 written (or d(delta)); ~5 f32 operations an element
        t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, 5 * n / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[time] {name} {list(shape)}: {ms:.3f} ms (bound {bound:.3f} ms, {by}; "
              f"{bound / ms:.1%} of it), plain {plain_ms:.3f} ms, the shared-delta B8 at the same "
              f"shape {shared_ms:.3f} ms, library none; {smi}", flush=True)
        key = "B8cf" if "fwd" in name else "B8cb"
        rows.append({"name": name, "route": "cuda",
                     "source": "flickering_adversarial_video_tpu_torch/csrc/fused_apply.cu",
                     "replaces": "flickering_adversarial_video_tpu/ops/fused_apply.py:"
                                 + ("132" if key == "B8cf" else "172"),
                     "launches": device[key], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
    return rows


def vector_sweep_phase(tmp: str, dev, sweep_run: dict) -> dict:
    """Phase 17: the vectorized per-video sweep (``engine/vector_sweep.py``).
    (a) B7 with a dl a clip ("B7c") bit-equal to its plain version; the
    slot step on VS_SLOTS uint8
    I3D clips, a graphed chunk (counts reset just before, read just after,
    and the device's launches under torch.profiler) bit-equal to the same
    chunk run eagerly, and each slot's trajectory beside the sequential
    graphed ``train_step`` of its clip and seed (``sweep.fit_single_video``);
    the same with USE_PALLAS_FUSED through B8 with a delta a clip ("B8c",
    :func:`fused_slot_pass`); clip-steps/s at VS_TIME_SLOTS slots against
    the B=1 step; (b) the single-video runner with SLOTS: 4 against the
    sequential runner; (c) ``torch_per_video --slots 4`` on phase 16's
    sweep.  Returns the kernel table's rows of B7c (B7's kernel at the slot
    step's shape and launches) and of B8c's forward and backward."""
    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec, perturbation
    from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
    from flickering_adversarial_video_tpu_torch.data import VideoDataset
    from flickering_adversarial_video_tpu_torch.data.npy import save_npy_clip
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.engine import sweep
    from flickering_adversarial_video_tpu_torch.engine.inference import InferenceModel
    from flickering_adversarial_video_tpu_torch.engine.vector_sweep import VectorSweepEngine
    from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
    from flickering_adversarial_video_tpu_torch.ops import packed_apply
    from flickering_adversarial_video_tpu_torch.runners import (
        common, single_video, torch_per_video)
    from flickering_adversarial_video_tpu_torch.utils.config import load_config
    from flickering_adversarial_video_tpu_torch.viz.results import load_result, result_filename

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16

    # ---- 17a. B7 with a dl a clip against its plain version at the slot step's shape ----
    # ties at both bounds: u8 0 under dl 0 is exactly -1 (clip 1), u8 255
    # under dl 1/128 exactly +1 (clip 2): mask 1 there
    gen = torch.Generator().manual_seed(SEED + 17)
    shape7 = (VS_SLOTS, SV_FRAMES // 2, SIZE // 2, SIZE // 2, 24)
    u8 = torch.randint(0, 256, shape7, generator=gen, dtype=torch.uint8)
    dl = (torch.rand(VS_SLOTS, SV_FRAMES // 2, 24, generator=gen) - 0.5) * 0.6
    u8[1, :, :4, :4, 0], dl[1, :, 0] = 0, 0.0
    u8[2, :, :4, :4, 5], dl[2, :, 5] = 255, 1.0 / 128
    u8, dl = u8.to(dev), dl.to(dev)
    b7c_err = None
    emit = packed_apply.emit_adv_mask
    for dtype in (bf16, torch.float32):
        before = emit.clip_launches
        adv, mask2 = emit(u8, dl, -1.0, 1.0, dtype)
        counted = emit.clip_launches == before + 1
        want_adv, want_mask = packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, dtype)
        err = (adv.float() - want_adv.float()).abs().max().item()
        merr = (mask2.int() - want_mask.int()).abs().max().item()
        ties = (int((mask2[1] == 1).sum()), int((mask2[2] == 1).sum()))
        nomask_adv, nomask = emit(u8, dl, -1.0, 1.0, dtype, want_mask=False)
        shared = emit(u8, dl[0], -1.0, 1.0, dtype)
        same = emit(u8, dl[:1].expand_as(dl).contiguous(), -1.0, 1.0, dtype)
        agree = torch.equal(shared[0], same[0]) and torch.equal(shared[1], same[1])
        b7c_err = max(err, float(merr)) if b7c_err is None else b7c_err
        print(f"[check] B7c         {str(dtype)[6:]:8s} {list(shape7)}, dl [{VS_SLOTS},"
              f"{SV_FRAMES // 2},24]: adv max_abs_err {err:.3e} mask max_abs_err {merr} "
              f"(tolerance 0); on a bound (mask 1): {ties[0]} at -1 in clip 1, {ties[1]} at +1 in "
              f"clip 2; without a mask equal: {nomask is None and torch.equal(nomask_adv, adv)}; "
              f"one dl for every clip equal to the shared form: {agree}; counted as a launch "
              f"with a dl a clip: {counted}", flush=True)
        if (err or merr or 0 in ties or nomask is not None or not torch.equal(nomask_adv, adv)
                or not agree or not counted):
            fail(f"B7c {dtype}: not bit-equal to its plain version (or to the shared form), no "
                 "bound hit, or not counted")
        del adv, mask2, want_adv, want_mask, nomask_adv, shared, same
    ms7 = cuda_ms(torch, lambda: emit(u8, dl, -1.0, 1.0, bf16))
    plain7 = cuda_ms(torch, lambda: packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, bf16),
                     iters=3, warmup=1)
    shared7 = cuda_ms(torch, lambda: emit(u8, dl[0], -1.0, 1.0, bf16))
    # u8 read, bf16 adv and u8 mask written, dl read; ~10 f32 operations an element
    t_bytes = (u8.numel() * (1 + 2 + 1) + dl.numel() * 4) / PEAK_BYTES * 1e3
    t_ops = 10 * u8.numel() / PEAK_F32_FLOPS * 1e3
    bound7 = max(t_bytes, t_ops)
    print(f"[time] B7c emit_adv_mask, a dl a clip {list(shape7)} bf16: {ms7:.3f} ms (bound "
          f"{bound7:.3f} ms, {'bytes' if t_bytes >= t_ops else 'operations'}; "
          f"{bound7 / ms7:.1%} of it), plain {plain7:.3f} ms; the shared form B7 at the same "
          f"shape {shared7:.3f} ms", flush=True)
    del u8, dl

    # ---- 17b. the slot step, graphed against eager and against the sequential step ------
    model = InceptionI3D(CLASSES, bf16, device=dev)
    model.load_state_dict(init_i3d_state(SEED))
    engine = AttackEngine(model, FlickerSpec(SV_FRAMES), AttackConfig(), track_probs=False)
    flags = RuntimeFlags()
    rng = np.random.default_rng(SEED + 17)
    clips = rng.integers(0, 256, (VS_SLOTS, 1, SV_FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    videos, packed, lab, device = slot_chunk_checks(engine, clips, dev, SLOT_STEP_COUNTS, 1,
                                                    "B7c, a dl a clip")
    if packed is not True:
        fail("the slot step's clips did not take the packed head")
    seeds = torch.arange(VS_SLOTS, device=dev)

    def fresh(n=VS_SLOTS, n_iter=VS_ITERS):
        vse = VectorSweepEngine(engine, n, n_iter=n_iter, init_scale=VS_INIT_SCALE)
        state = vse.init_slots()
        for i in range(n):
            vse.refill_slot(state, i, i, 0.2)
        return vse, state

    # ---- 17f. kernel B8 with a delta a clip (B8c): the fused slot step ---------------
    b8c_rows = fused_slot_pass(dev, model, clips)
    torch.cuda.empty_cache()

    # ---- 17c. clip-steps/s at N slots against the B=1 step ----------------------------
    def seq_ms():
        st = engine.init_state()
        b1 = {"video": torch.from_numpy(clips[0]).to(dev), "labels": lab[:1]}
        st = engine.train_steps(st, b1, flags, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.train_steps(st, b1, flags, VS_TIME_ITERS)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / VS_TIME_ITERS

    seq = [seq_ms()]
    timed = []
    for n in VS_TIME_SLOTS:
        vse_n, st = fresh(n, 10 ** 9)  # never done: every slot steps every iteration
        pick = [i % VS_SLOTS for i in range(n)]
        args = (videos[pick].contiguous(), lab[pick].contiguous(), torch.arange(n, device=dev))
        st, _ = vse_n.run_chunk(st, *args, flags, VS_TIME_ITERS, packed=packed)  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = vse_n.run_chunk(st, *args, flags, VS_TIME_ITERS, packed=packed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / VS_TIME_ITERS
        timed.append((n, ms, vse_n.graph_stats()))
        del vse_n, st, args
        torch.cuda.empty_cache()
    seq.append(seq_ms())
    base = 1e3 / min(seq)
    print(f"[time] vector sweep, uint8 clips [1,{SV_FRAMES},{SIZE},{SIZE},3], a chunk of "
          f"{VS_TIME_ITERS} graphed slot steps (host clock to a synchronize): the sequential "
          f"B=1 graphed step {seq[0]:.2f}, {seq[1]:.2f} ms ({base:.1f} clip-steps/s); " + "; ".join(
              f"N={n}: {ms:.2f} ms a slot step, {n * 1e3 / ms:.1f} clip-steps/s "
              f"({n * 1e3 / ms / base:.2f}x), pool {st['pool_bytes'] / 1e9:.3f} GB, capture "
              f"{st['capture_s']:.2f} s" for n, ms, st in timed), flush=True)
    del engine, model, videos
    torch.cuda.empty_cache()

    # ---- 17d. path (b): the single-video runner with SLOTS: 4 -------------------------
    # float32 clips [1,90,224,224,3]: three named with the runner's seeded
    # model's clean prediction and one with a wrong class (skipped); the
    # sequential runner over the same directory is the reference.  Each run
    # starts its k-th clip from sweep.draw_init_delta of seed k, not from the
    # reference's zeros: on random weights the adversarial gradient lies
    # below the backward's rounding, so from zeros delta moves by rounding
    # noise; from a drawn delta the regularizers move each clip's delta its
    # own way at Adam's rate, which a wrong per-slot gradient would change
    cfg = load_config(os.path.join(HERE, "configs", "run_config.yml"))
    sv = cfg.SINGLE_VIDEO_ATTACK
    sv.MAX_NUM_STEP = SV_MAX_NUM_STEP
    sv.NPY_PATH = os.path.join(tmp, "npy_slots")
    os.makedirs(sv.NPY_PATH)
    with contextlib.redirect_stdout(io.StringIO()):
        sv_engine, sv_labels = common.build_engine(sv, cfg.MODEL, frames=SV_FRAMES)
    infer = InferenceModel(sv_engine)
    rng = np.random.default_rng(SEED + 18)
    for k in range(4):
        clip = rng.uniform(-1, 1, (1, SV_FRAMES, SIZE, SIZE, 3)).astype(np.float32)
        top = int(infer(clip).argmax())
        name = sv_labels[top if k < 3 else (top + 1) % CLASSES].replace(" ", "_")
        save_npy_clip(os.path.join(sv.NPY_PATH, f"rgb_{k}@{name}.npy"), clip)
    del sv_engine, infer

    def drawn(draws):
        """init_delta drawing a run's k-th initial delta from seed k."""
        def init_delta(spec, device=None, dtype=torch.float32, generator=None):
            draws.append(sweep.draw_init_delta(tuple(spec.shape), len(draws), VS_INIT_SCALE))
            return draws[-1].to(device=device, dtype=dtype)
        return init_delta

    # each clip's result as the runner saves it: the reference names a pkl by
    # class and rounded thickness and roughness, and the noise clips share one
    # predicted class, so their pkls may overwrite one another
    save = single_video._save

    def kept(results):
        def keep(res, result_path, correct_cls, k):
            results[k] = res
            return save(res, result_path, correct_cls, k)
        return keep

    runs = {}
    for slots in (1, 4):
        sv.SLOTS = slots
        sv.PKL_RESULT_PATH = os.path.join(tmp, f"sv_slots{slots}") + "/"
        draws, results = [], {}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(perturbation, "init_delta", drawn(draws)), \
                mock.patch.object(single_video, "_save", kept(results)), \
                contextlib.redirect_stdout(io.StringIO()):
            written = single_video.run(cfg, frames=SV_FRAMES)
        torch.cuda.synchronize()
        runs[slots] = (written, [load_result(p) for p in written], read_counts(ops),
                       time.perf_counter() - t0, draws, results)
    (w1, f1, c1, s1, i1, r1), (w4, f4, c4, s4, i4, r4) = runs[1], runs[4]
    want4 = scaled(SV_STEP_COUNTS, VS_RUNNER_CHUNK, scaled(SV_CLEAN_COUNTS, 4))
    # a pkl's name is the reference's convention of its own result (class,
    # beta1, final thickness and roughness to 0.01%), in both runs; the
    # last digit may differ between the two where a thickness lies on a
    # rounding boundary
    named = all(os.path.basename(p) == result_filename(
        r["correct_cls"], r["beta_1"], r["fatness"][-1], r["smoothness"][-1])
        for p, r in zip(w1 + w4, f1 + f4))
    schema = all(set(r) == SV_RESULT_KEYS for r in f1 + f4)
    clips_same = sorted(r1) == sorted(r4) == [0, 1, 2]
    r1, r4 = [r1[k] for k in sorted(r1)], [r4[k] for k in sorted(r4)]
    same = clips_same and len(w4) == len(w1) == 3 and len(i1) >= 3 and all(
        a["correct_cls"] == b["correct_cls"] and a["total_steps"] == b["total_steps"]
        and a["is_adversarial"] == b["is_adversarial"] and torch.equal(i1[j], i4[j])
        for j, (a, b) in enumerate(zip(r4, r1)))
    rows, ok = [], same
    for j, (a, b) in enumerate(zip(r4, r1) if same else ()):
        moved = float(np.abs(b["final_delta"] - i1[j].numpy()).max())
        d_err = float(np.abs(a["final_delta"] - b["final_delta"]).max())
        want_l, got_l = np.asarray(b["total_loss_l"]), np.asarray(a["total_loss_l"])
        l_err = float((np.abs(got_l - want_l) / np.abs(want_l)).max())
        rows.append(f"clip {j}: final delta max |diff| {d_err:.3e} (bound {VS_DELTA_SHARE} x its "
                    f"movement {moved:.3e}), losses max relative diff {l_err:.3e} (bound "
                    f"{VS_LOSS_REL})")
        ok = ok and d_err <= VS_DELTA_SHARE * moved and l_err <= VS_LOSS_REL
    print(f"[vector] single-video runner, SLOTS 4 against SLOTS 1 on 3 float32 clips "
          f"[1,{SV_FRAMES},{SIZE},{SIZE},3] and a misnamed one, each from a drawn delta: pkls "
          f"{len(w4)}/{len(w1)} {sorted(set(os.path.basename(p) for p in w4))}/"
          f"{sorted(set(os.path.basename(p) for p in w1))}, each named by the reference's "
          f"convention: {named}, schema {'as the sequential runner' if schema else 'WRONG'}, "
          f"steps {[r['total_steps'] for r in r4]}/{[r['total_steps'] for r in r1]}, fooled "
          f"{[r['is_adversarial'] for r in r4]}/{[r['is_adversarial'] for r in r1]}; "
          + "; ".join(rows) + f"; launches {c4} (expected one chunk of {VS_RUNNER_CHUNK} slot "
          f"steps and 4 clean forwards: {want4}), sequential {c1}; {s4:.1f} s against "
          f"{s1:.1f} s", flush=True)
    if not (ok and named and schema and c4 == want4):
        fail("the single-video runner with SLOTS: pkls, names, schema, steps, delta, losses or "
             "counts")

    # ---- 17e. path (c): torch_per_video --slots 4 on phase 16's sweep ------------------
    sr = sweep_run
    slot_dir = sr["dir"] + "_slots"
    kw = dict(records=sr["records"], label_names=sr["labels"], ckpt_path=sr["ckpt"],
              n_iter=TW_SWEEP_ITERS, model_dir=slot_dir, sample_length=sr["frames"],
              input_size=RESNET_SIZE, device=dev, slots=4)
    t0 = time.perf_counter()
    with mock.patch.object(VideoDataset, "_decode", lambda self, path: sr["decoded"](path)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            out1 = torch_per_video.run(sr["variant"], **kw)
            out2 = torch_per_video.run(sr["variant"], **kw)
        torch.cuda.synchronize()
        counts = read_counts(ops)
    res = [np.load(sweep.result_path_for(slot_dir, r.path, sr["labels"][r.label]),
                   allow_pickle=True).tolist() for r in sr["records"][:2]]
    fooled = [bool(np.any(r["is_adversarial"])) for r in res]
    seq_fooled = [bool(np.any(r["is_adversarial"])) for r in sr["results"]]
    files_equal = sorted(os.listdir(slot_dir)) == sorted(os.listdir(sr["dir"]))
    schema = all(set(r) == SWEEP_KEYS for r in res)
    stats = {k: v for k, v in out1.items() if k != "results"}
    seq_stats = {k: v for k, v in sr["first"].items() if k != "results"}
    ok = (files_equal and schema and stats == seq_stats
          and out2["skipped_existing"] == sum(fooled) and out2["attacked"] == 2 - sum(fooled)
          and counts == {name: 0 for name in NAMES})
    print(f"[vector] runners.torch_per_video --slots 4 on {sr['variant']} (phase 16's three "
          f"videos, n_iter {TW_SWEEP_ITERS}): {stats} (sequential {seq_stats}); rerun over the "
          f"ledger {({k: v for k, v in out2.items() if k != 'results'})}; files "
          f"{'as the sequential sweep' if files_equal else 'DIFFER'}, schema "
          f"{'as the sequential sweep' if schema else 'WRONG'}; per video (slots/sequential): "
          f"steps {[len(r['loss/total']) for r in res]}/{[len(r['loss/total']) for r in sr['results']]}, "
          f"escalations {[r['escalations'] for r in res]}/{[r['escalations'] for r in sr['results']]}, "
          f"fooled {fooled}/{seq_fooled}; the port's kernels launched {counts} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not ok:
        fail("torch_per_video --slots: counts, files, schema, ledger rerun or launch counts")
    print(f"[time] phase 17 (the vectorized sweep) {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return [{"name": "B7c emit_adv_mask, a dl a clip", "route": "cuda",
            "source": "flickering_adversarial_video_tpu_torch/csrc/emit.cu",
            "replaces": "flickering_adversarial_video_tpu/ops/stem_tmajor.py:363",
            "launches": device["B7"], "max_abs_err": b7c_err, "ms": ms7, "plain_ms": plain7,
            "bound_ms": bound7, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}] + b8c_rows


# phase 18, data parallel over ranks (parallel/mesh.py): (a) world 1 over
# NCCL, in this process, through the universal runner on phase 7's shards;
# (b) two ranks on the one card over gloo with eager steps, held against one
# process on the same global batch; (c) torch_per_video --slots 4 --mesh at
# two ranks against phase 17e
DP_W, DP_STEPS, DP_TIME_ITERS = 2, 3, 10
DP_INIT_SCALE = 0.005   # 18b's drawn initial delta
DP_JOIN_S = 420         # a spawned group's own time limit
# 18b's limits against one process on the global batch, by compute dtype:
# the mean |delta - one process's| over the mean movement of one process's
# delta, and each step's losses relative.  In bf16 the split changes cuDNN's
# algorithms and the logits' rounding, and Adam turns gradient components
# near cancellation into whole steps.  Sound runs on an H100 read 5.0% and
# 5.7e-6 in bf16, 0.13% and 7.9e-8 in f32; the planted faults of
# scripts/torch_parallel_fault.py 33-40% in both (and the averaged hinge's
# losses 0.5), so every fault fails both dtypes' limits (PERF.md).
DP_LIMITS = {"bfloat16": (0.15, 1e-4), "float32": (0.01, 1e-5)}


def stub_decode(path):
    """Seeded uint8 frames of TW_FRAMES for a video path (the card has no
    cv2): phase 16's decoder, here so that spawned ranks can use it too."""
    import numpy as np

    seed = zlib.crc32(os.path.basename(path).encode())
    return np.random.default_rng(seed).integers(0, 256, TW_FRAMES + (3,), dtype=np.uint8)


def _rank_entry(rank, tmp, tag, work, args):
    """A spawned rank: `work(rank, tmp, *args)`'s result saved to
    <tmp>/<tag>_rank<r>.pt, a traceback to <tag>_rank<r>.err on failure."""
    sys.path.insert(0, HERE)
    try:
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.save(work(rank, tmp, *args), os.path.join(tmp, f"{tag}_rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"{tag}_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(tmp, tag, work, args, world=DP_W):
    """Run `work` on `world` spawned ranks under DP_JOIN_S; their results,
    in rank order.  Fails on a hang (the ranks are killed) or an error."""
    import multiprocessing

    import torch

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, tmp, tag, work, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(30)
    errs = "".join(open(os.path.join(tmp, f"{tag}_rank{r}.err")).read() for r in range(world)
                   if os.path.exists(os.path.join(tmp, f"{tag}_rank{r}.err")))
    if hung or any(p.exitcode != 0 for p in procs):
        fail(f"{tag}: {len(hung)} ranks hung past {DP_JOIN_S} s, exit codes "
             f"{[p.exitcode for p in procs]}\n{errs}")
        raise SystemExit(1)
    return [torch.load(os.path.join(tmp, f"{tag}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def dp_world1_phase(tmp, dev, shard_dir, phase7):
    """18a: world 1 over NCCL in this process (a file:// store): the
    universal runner on phase 7's shards for its steps, the train step's
    collective captured in the graph, bit-equal to phase 7's run (history
    and final delta), its launch counts as phase 3's; the graphed B=8 step
    timed with and without its all-reduce; then the CLI once under
    ``torch.distributed.run --nproc-per-node 1`` (torchrun's environment)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.data import pack_video_np
    from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
    from flickering_adversarial_video_tpu_torch.engine.loops import flags_from_config
    from flickering_adversarial_video_tpu_torch.parallel import mesh as mesh_lib
    from flickering_adversarial_video_tpu_torch.runners import common, universal
    from flickering_adversarial_video_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(HERE, "configs", "run_config.yml"))
    ac = cfg.UNIVERSAL_ATTACK
    ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shard_dir]
    ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = SHARDS
    ac.BATCH_SIZE, ac.MAX_NUM_STEP = B, RUNNER_STEPS
    ac.PKL_RESULT_PATH = os.path.join(tmp, "dp_world1")
    mesh_lib.initialize_distributed(init_method=f"file://{os.path.join(tmp, 'dp_world1.store')}",
                                    rank=0, world_size=1)
    try:
        if dist.get_backend() != "nccl":
            fail(f"18a: the group's backend is {dist.get_backend()}, not NCCL")
        real, calls = dist.all_reduce, []

        def spy(tensor, *a, **kw):
            calls.append((torch.cuda.is_current_stream_capturing(), tensor.device.type))
            return real(tensor, *a, **kw)

        said = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with mock.patch.object(dist, "all_reduce", spy), contextlib.redirect_stdout(said):
            out = universal.run(cfg, frames=T, max_steps=RUNNER_STEPS)
            torch.cuda.synchronize()
        got = read_counts(ops)
        hist, want_hist = out["history"], phase7["history"]
        n_eval = len(hist["fool_rate_steps"]) * SHARDS
        want = {k: RUNNER_STEPS * TRAIN_COUNTS[k] + n_eval * EVAL_COUNTS[k] for k in NAMES}
        same_hist = ({k: v for k, v in hist.items() if k != "perturbation"}
                     == {k: v for k, v in want_hist.items() if k != "perturbation"}
                     and len(hist["perturbation"]) == len(want_hist["perturbation"])
                     and all(np.array_equal(a, b) for a, b in zip(hist["perturbation"],
                                                                  want_hist["perturbation"])))
        same_delta = torch.equal(out["state"].delta, phase7["delta"])
        captured = sum(1 for capturing, where in calls if capturing and where == "cuda")
        ckpts = AttackCheckpointer(os.path.join(universal.model_dir_name(ac), "ckpt")).steps()
        dp_line = [ln for ln in said.getvalue().splitlines() if "data parallel" in ln]
        print(f"[parallel] 18a world 1 over NCCL: universal runner {RUNNER_STEPS} steps on phase "
              f"7's shards ({dp_line}): "
              f"history {'bit-equal' if same_hist else 'DIFFERS from'} phase 7's, final delta "
              f"{'bit-equal' if same_delta else 'DIFFERS'}; device all-reduces called in a "
              f"capture {captured}, outside {sum(1 for c, w in calls if not c and w == 'cuda')}; "
              f"checkpoints {ckpts}; launches {got} (expected {want})", flush=True)
        if not (same_hist and same_delta) or got != want or captured < 1 or (
                RUNNER_STEPS not in ckpts) or not dp_line:
            fail("18a: world 1 over NCCL is not phase 7's run, or its collective was not "
                 "captured, or the launch counts or checkpoints differ")

        # the graphed B=8 step with and without the all-reduce, in turns
        with contextlib.redirect_stdout(io.StringIO()):
            meshed, _ = common.build_engine(ac, cfg.MODEL, frames=T, track_probs=False)
            plain, _ = common.build_engine(ac, cfg.MODEL, frames=T, track_probs=False,
                                           use_mesh=False)
        if meshed.mesh is None or plain.mesh is not None:
            fail("18a: build_engine did not give the meshed engine its mesh")
        clips = np.random.default_rng(SEED).integers(0, 256, (B, T, SIZE, SIZE, 3), np.uint8)
        batch = {"video_packed": torch.from_numpy(pack_video_np(clips)).to(dev),
                 "labels": torch.zeros(B, dtype=torch.int64, device=dev)}
        flags = flags_from_config(ac)
        states = {}
        for name, eng in (("plain", plain), ("meshed", meshed)):
            states[name] = eng.train_steps(eng.init_state(), batch, flags, 1)  # captures
        ms = {"plain": [], "meshed": []}
        for name in ("plain", "meshed", "meshed", "plain"):
            eng = plain if name == "plain" else meshed

            def steps(eng=eng, name=name):
                states[name] = eng.train_steps(states[name], batch, flags, DP_TIME_ITERS)

            ms[name].append(cuda_ms(torch, steps, iters=1, warmup=1) / DP_TIME_ITERS)
        same = torch.equal(states["plain"].delta, states["meshed"].delta)
        print(f"[time] 18a graphed train step at B={B}, T={T} ({DP_TIME_ITERS} replays a call, "
              f"in turns plain, meshed, meshed, plain): without the all-reduce "
              f"{ms['plain'][0]:.3f} / {ms['plain'][1]:.3f} ms, with the world-1 NCCL all-reduce "
              f"in the graph {ms['meshed'][0]:.3f} / {ms['meshed'][1]:.3f} ms; cost "
              f"{np.mean(ms['meshed']) - np.mean(ms['plain']):+.3f} ms a step; the two deltas "
              f"{'bit-equal' if same else 'DIFFER'}", flush=True)
        if not same:
            fail("18a: the meshed step at world 1 is not the plain step bit for bit")
        del meshed, plain, states, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # the CLI under torchrun, one rank: torchrun's environment path
    ac.PKL_RESULT_PATH = os.path.join(tmp, "dp_cli")
    ac.MAX_NUM_STEP = 2
    yml = os.path.join(tmp, "dp_cli.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "flickering_adversarial_video_tpu_torch.runners.universal", yml,
           "--frames", str(T)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if "data parallel" in ln or "done:" in ln]
    res = os.path.join(universal.model_dir_name(ac), "res.pkl")
    print(f"[parallel] 18a CLI under torch.distributed.run --nproc-per-node 1: exit "
          f"{run.returncode}; {lines}; res.pkl {'written' if os.path.exists(res) else 'MISSING'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if (run.returncode != 0 or not os.path.exists(res)
            or not any("rank 0 of 1 (nccl)" in ln for ln in lines)
            or not any("done: steps=2" in ln for ln in lines)):
        fail(f"18a: the CLI under torchrun\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    print(f"[time] phase 18a {time.perf_counter() - t_phase:.1f} s", flush=True)


def _dp_model(dev, dtype):
    """Phase 3's victim: I3D, 400 classes, seed-0 weights, compute `dtype`."""
    import torch

    from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
    from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D

    model = InceptionI3D(CLASSES, getattr(torch, dtype), device=dev)
    model.load_state_dict(init_i3d_state(SEED))
    return model


def _dp_clips():
    import numpy as np

    return np.random.default_rng(SEED + 18).integers(0, 256, (B, T, SIZE, SIZE, 3), np.uint8)


def _dp_steps(engine, batch, d0, flags):
    """DP_STEPS train steps from d0: (final delta, each step's losses, ms a
    step by the host clock)."""
    import torch

    from flickering_adversarial_video_tpu_torch.engine import AttackState

    d = torch.from_numpy(d0).to(engine.device)
    state = AttackState(d, torch.zeros_like(d), torch.zeros_like(d), 0)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        state, m = engine.train_step(state, batch, flags)
        losses.append((float(m["total_loss"]), float(m["adv_loss"])))
    torch.cuda.synchronize()
    return (state.delta.cpu().numpy(), losses,
            (time.perf_counter() - t0) * 1e3 / DP_STEPS)


def _dp_rank(rank, tmp, backend, device, dtype, labels, d0, beta0, plant):
    """18b on one rank: the global batch's shard, DP_STEPS steps, on
    `device` (gloo: the one card) or the rank's own card (NCCL)."""
    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.parallel import mesh as mesh_lib

    if plant is not None:
        plant()
    dev = torch.device("cuda", rank) if backend == "nccl" else torch.device(device)
    mesh_lib.initialize_distributed(backend, f"file://{os.path.join(tmp, 'dp2.store')}", rank,
                                    DP_W)
    mesh = mesh_lib.make_mesh(dev)
    engine = AttackEngine(_dp_model(dev, dtype), FlickerSpec(T), AttackConfig(use_logits=True),
                          track_probs=False, mesh=mesh, eager=backend != "nccl")
    batch = engine.shard({"video": _dp_clips(), "labels": np.asarray(labels, np.int64)})
    ops.reset_launch_counts()
    out = _dp_steps(engine, batch, d0, RuntimeFlags(beta0=beta0))
    result = {"delta": out[0], "losses": out[1], "ms": out[2], "counts": read_counts(ops),
              "graphed": engine.graphed, "mesh": (mesh.rank, mesh.world, mesh.backend)}
    torch.distributed.destroy_process_group()
    return result


def dp_gloo_phase(tmp, dev, plant=None):
    """18b: two ranks on the one card over gloo (NCCL refuses two ranks on
    one card), spawned, eager steps: I3D at B=8 of 64x224x224 uint8 clips, 4
    a rank, DP_STEPS steps from a drawn delta, against one process's eager
    steps on the same global batch, in bf16 and in f32 (DP_LIMITS).
    USE_LOGITS, so that the adversarial gradient lies above the backward's
    rounding (the probabilities of the seeded victim saturate), and beta0
    such that the regularizers' gradient and the adversarial one are of one
    size at the start, so that a fault in either shows.  `plant`, run first
    in each rank, plants a fault (scripts/torch_parallel_fault.py).  On two
    or more cards the same over NCCL with graphed steps.  Returns the
    readings by (backend, dtype)."""
    import torch

    t_phase = time.perf_counter()
    readings = {}
    for dtype in DP_LIMITS:
        readings.update(_dp_gloo_dtype(tmp, dev, dtype, plant))
    if torch.cuda.device_count() < DP_W:
        print(f"[parallel] 18b over NCCL with graphs: not run ({torch.cuda.device_count()} card; "
              f"NCCL takes one card a rank)", flush=True)
    print(f"[time] phase 18b {time.perf_counter() - t_phase:.1f} s", flush=True)
    return readings


def _dp_gloo_dtype(tmp, dev, dtype, plant):
    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.engine.sweep import draw_init_delta

    engine = AttackEngine(_dp_model(dev, dtype), FlickerSpec(T), AttackConfig(use_logits=True),
                          track_probs=False, eager=True)
    video = torch.from_numpy(_dp_clips()).to(dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    labels = engine.forward(None, {"video": video, "labels": zeros},
                            adversarial=False).argmax(-1).cpu().numpy()
    batch = {"video": video, "labels": torch.from_numpy(labels).to(dev)}
    d0 = draw_init_delta((T, 1, 1, 3), SEED + 18, DP_INIT_SCALE).numpy()
    # beta0: the two gradients' mean sizes equal at d0
    clip, packed, lab = engine.prepare_batch(batch)
    d = torch.from_numpy(d0).to(dev).requires_grad_(True)
    _, terms = engine._loss_terms(d, clip, packed, lab, engine._step_scalars(RuntimeFlags()),
                                  torch.zeros((), dtype=torch.int32, device=dev))
    g_adv = torch.autograd.grad(terms["adv_loss"], d, retain_graph=True)[0].abs().mean().item()
    g_reg = torch.autograd.grad(terms["weighted_reg"], d)[0].abs().mean().item()
    beta0 = g_adv / g_reg
    want, want_losses, one_ms = _dp_steps(engine, batch, d0, RuntimeFlags(beta0=beta0))
    del engine, video, batch, clip, d, terms
    torch.cuda.empty_cache()
    moved = float(np.abs(want - d0).mean())
    share_limit, loss_limit = DP_LIMITS[dtype]
    readings = {}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= DP_W else [])
    for backend in backends:
        ranks = spawn_ranks(tmp, f"dp2_{backend}_{dtype}", _dp_rank,
                            (backend, str(dev), dtype, labels.tolist(), d0, beta0, plant))
        got = ranks[0]["delta"]
        equal = all(np.array_equal(r["delta"], got) for r in ranks)
        share = float(np.abs(got - want).mean()) / moved
        rel = max(abs(g - w) / abs(w) for r in ranks for gs, ws in zip(r["losses"], want_losses)
                  for g, w in zip(gs, ws))
        counts_ok = all(r["counts"] == scaled(TRAIN_COUNTS, DP_STEPS) for r in ranks)
        readings[(backend, dtype)] = {"share": share, "loss_rel": rel, "equal": equal,
                                      "max_abs": float(np.abs(got - want).max()),
                                      "beta0": beta0, "moved": moved}
        print(f"[parallel] 18b {DP_W} ranks over {backend} "
              f"({'graphed' if ranks[0]['graphed'] else 'eager'} steps), I3D {dtype} B={B} "
              f"({B // DP_W} a rank) of {T}x{SIZE}x{SIZE}, USE_LOGITS, beta0 {beta0:.6g} "
              f"(|d adv| {g_adv:.4g}, |d reg| {g_reg:.4g} a unit beta0 at the drawn delta), "
              f"{DP_STEPS} steps against one process: delta bit-equal across ranks {equal}; mean "
              f"|delta - one process's| {share:.3%} of its mean movement {moved:.4g} (limit "
              f"{share_limit:.0%}; max {readings[(backend, dtype)]['max_abs']:.3g}); losses "
              f"within {rel:.3g} relative (limit {loss_limit:g}); launches a rank "
              f"{ranks[0]['counts']} (each rank's steps: B1-B7 on every rank); ms a step "
              f"{[round(r['ms'], 1) for r in ranks]} (one process {one_ms:.1f}; two ranks "
              f"time-slice one card: a correctness run, not a scaling number)", flush=True)
        if not (equal and share <= share_limit and rel <= loss_limit and counts_ok):
            fail(f"18b over {backend} in {dtype}: the ranks' delta or losses against one "
                 f"process, delta across the ranks, or the launch counts")
    return readings


def _dp_sweep_rank(rank, tmp, kw, plant=None):
    """18c on one rank: torch_per_video --slots 4 --mesh."""
    import torch

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.data import VideoDataset
    from flickering_adversarial_video_tpu_torch.parallel import mesh as mesh_lib
    from flickering_adversarial_video_tpu_torch.runners import torch_per_video

    if plant is not None:
        plant()
    mesh_lib.initialize_distributed("gloo", f"file://{os.path.join(tmp, 'dp3.store')}", rank,
                                    DP_W)
    ops.reset_launch_counts()
    with mock.patch.object(VideoDataset, "_decode", lambda self, path: stub_decode(path)), \
            contextlib.redirect_stdout(io.StringIO()):
        out = torch_per_video.run(slots=4, use_mesh=True, **kw)
    counts = read_counts(ops)
    torch.distributed.destroy_process_group()
    return {"out": out, "counts": counts}


def dp_sweep_phase(tmp, dev, sweep_run, plant=None):
    """18c: ``torch_per_video --slots 4 --mesh`` at two ranks over gloo on
    phase 16's videos: each rank 2 slots over its videos, no collective in
    the step; its counts, files, steps, escalations and verdicts those of
    phase 17e's ``--slots 4`` in one process."""
    import numpy as np

    from flickering_adversarial_video_tpu_torch.engine import sweep

    t_phase = time.perf_counter()
    sr = sweep_run
    mesh_dir, one_dir = sr["dir"] + "_mesh", sr["dir"] + "_slots"
    kw = dict(model_name=sr["variant"], records=sr["records"], label_names=sr["labels"],
              ckpt_path=sr["ckpt"], n_iter=TW_SWEEP_ITERS, model_dir=mesh_dir,
              sample_length=sr["frames"], input_size=RESNET_SIZE, device=str(dev))
    ranks = spawn_ranks(tmp, "dp3", _dp_sweep_rank, (kw, plant))
    out = ranks[0]["out"]
    stats = {k: v for k, v in out.items() if k != "results"}
    want_stats = {k: v for k, v in sr["first"].items() if k != "results"}

    def load(d):
        return [np.load(sweep.result_path_for(d, r.path, sr["labels"][r.label]),
                        allow_pickle=True).tolist() for r in sr["records"][:2]]

    got, want = load(mesh_dir), load(one_dir)
    files = sorted(os.listdir(mesh_dir)) == sorted(os.listdir(one_dir))
    # what 17e holds against the sequential sweep: steps, escalations and the
    # verdict (the step at which a clip near its decision boundary first
    # fools may move with bf16 rounding at 2 slots a rank against 4)
    same = [(len(g["loss/total"]), g["escalations"], bool(np.any(g["is_adversarial"])))
            == (len(w["loss/total"]), w["escalations"], bool(np.any(w["is_adversarial"])))
            for g, w in zip(got, want)]
    loss = max(float(np.max(np.abs(np.asarray(g["loss/total"]) - w["loss/total"])))
               for g, w in zip(got, want))
    pert = max(float(np.max(np.abs(np.asarray(g["perturbation"]) - np.asarray(w["perturbation"]))))
               for g, w in zip(got, want))
    zero = {name: 0 for name in NAMES}
    ok = (all(r["out"] == out for r in ranks) and stats == want_stats and files and all(same)
          and all(r["counts"] == zero for r in ranks))
    print(f"[parallel] 18c torch_per_video --slots 4 --mesh, {DP_W} ranks over gloo on "
          f"{sr['variant']} (phase 16's videos, 2 slots a rank): {stats} (phase 17e {want_stats}, "
          f"every rank's alike: {all(r['out'] == out for r in ranks)}); files "
          f"{'as 17e' if files else 'DIFFER'}; per video steps, escalations, verdicts as 17e "
          f"{same}; max |loss - 17e's| {loss:.3g}, max |perturbation - 17e's| {pert:.3g}; the "
          f"port's kernels launched {[r['counts'] for r in ranks]} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if not ok:
        fail("18c: torch_per_video --slots 4 --mesh is not phase 17e's sweep")


# phase 19, the float schema: FS_CLIPS seeded f32 clips of FS_FRAMES x SIZE^2
# through float-schema records and one graphed step of the universal engine
FS_CLIPS, FS_FRAMES = 2, 16


def float_schema_phase(tmp: str, dev) -> None:
    """Phase 19, the float schema (``data/tfrecord.py``): FS_CLIPS seeded f32
    clips [FS_FRAMES, SIZE, SIZE, 3] in [-1, 1] written as float-schema
    records by the port's ``make_float_example`` and ``TFRecordWriter``, read
    back through ``tfrecord_batches(schema="float")`` into pinned buffers
    (every value and label equal to the arrays), and one graphed train step
    of the universal engine (I3D, bf16; a float clip takes the generic path)
    on that batch, its wrappers' counts those of a float clip's step: delta,
    the moments and every metric bit-equal to the same step, in the same
    graph, on the batch built from the arrays directly."""
    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
    from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
    from flickering_adversarial_video_tpu_torch.data import (
        TFRecordWriter, make_float_example, tfrecord_batches)
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 19)
    videos = rng.uniform(-1, 1, (FS_CLIPS, FS_FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, FS_CLIPS).astype(np.int64)
    path = os.path.join(tmp, "float_schema.tfrecords")
    with TFRecordWriter(path) as w:
        for video, label in zip(videos, labels):
            w.write(make_float_example(video, int(label)))
    batches = list(tfrecord_batches([path], FS_CLIPS, schema="float", use_native=False,
                                    height=SIZE, width=SIZE, pin_memory=True))
    read_ok = (len(batches) == 1 and batches[0]["video"].is_pinned()
               and np.array_equal(batches[0]["video"].numpy(), videos)
               and np.array_equal(batches[0]["labels"], labels))
    model = InceptionI3D(CLASSES, torch.bfloat16, device=dev)
    model.load_state_dict(init_i3d_state(SEED))
    engine = AttackEngine(model, FlickerSpec(FS_FRAMES), AttackConfig(), track_probs=True)
    ops.reset_launch_counts()
    runs = []
    for batch in (batches[0], {"video": videos, "labels": labels}):
        state, metrics = engine.train_step(engine.init_state(), batch, RuntimeFlags())
        torch.cuda.synchronize()
        runs.append(([t.clone() for t in (state.delta, state.mu, state.nu)],
                     {k: v.clone() if torch.is_tensor(v) else v for k, v in metrics.items()}))
    counts = read_counts(ops)
    (s1, m1), (s2, m2) = runs
    same = all(torch.equal(a, b) for a, b in zip(s1, s2)) and m1.keys() == m2.keys() and all(
        torch.equal(m1[k], m2[k]) if torch.is_tensor(m1[k]) else m1[k] == m2[k] for k in m1)
    finite = bool(torch.isfinite(m1["total_loss"])) and bool((s1[0] != 0).any())
    want = scaled(SV_STEP_COUNTS, 2)
    print(f"[float] {FS_CLIPS} float-schema records of [{FS_FRAMES},{SIZE},{SIZE},3] f32 written "
          f"and read back through tfrecord_batches(schema='float'), pinned: values and labels "
          f"equal {read_ok}; one graphed train step (graphed: {engine.graphed}) on that batch "
          f"against the same step on the arrays: delta, moments and metrics bit-equal {same}; "
          f"total_loss {float(m1['total_loss']):.6f} finite, delta moved: {finite}; launches of "
          f"the two steps {counts} (expected {want}) "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if not (read_ok and same and finite and engine.graphed and counts == want):
        fail("the float schema: records, batches, the graphed step or its counts")


# phase 20a, the TV-L1 flow at the reference's geometry: a gray clip of
# FLOW_FRAMES frames at FLOW_H x FLOW_W (the reference's resize of a 4:3 frame
# to a min side of 256), each frame moved from the one before by a whole-pixel
# shift from FLOW_SHIFTS (a cycle summing to 0, so that the crops stay inside
# the texture); the interior median of every pair within FLOW_MEDIAN_PX of its
# shift (the JAX test's tolerance), the card against the port's CPU flow on
# FLOW_PAIR_HW pairs within FLOW_CARD_ATOL_PX
FLOW_FRAMES, FLOW_H, FLOW_W, FLOW_MARGIN = 64, 256, 340, 16
FLOW_SHIFTS = ((2, 0), (0, 3), (2, 1), (-3, -1), (1, -2), (-2, -1))
FLOW_MEDIAN_PX, FLOW_BORDER = 0.5, 12
FLOW_PAIR_HW, FLOW_CARD_ATOL_PX = (64, 80), 5e-4  # measured 5.2e-5 px (H100)
# phase 20b: each kernel's bound at its timed shape in PERF.md section 6 (ms),
# which the tally's bytes and FLOPs must give within 1%
TABLE_BOUNDS = {"B1": 0.607, "B2": 0.123, "B3": 0.046, "B4": 0.069, "B5": 0.153, "B6": 0.276,
                "B7": 0.092, "B7c": 0.065, "B8f": 0.115, "B8b": 0.115, "B8cf": 0.081,
                "B8cb": 0.081, "B9f": 0.169, "B9b": 0.169}
LOADER_WORKERS, LOADER_EPOCHS = 2, 2   # phase 20c's GrainEpochLoader


def _textured_clip(torch, dev, frames: int, h: int, w: int, margin: int, seed: int):
    """(gray clip [frames, h, w] f32 on dev, the shift (dx, dy) of each pair):
    blurred uniform noise on the 0..255 scale (three passes of a 4-wide box
    on each axis, the JAX tests' `_smooth_image`), frame t+1 the crop of frame
    t moved by FLOW_SHIFTS[t % 6]."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cpu").manual_seed(seed)
    big = (torch.rand(1, 1, h + 2 * margin, w + 2 * margin, generator=gen) * 255).to(dev)
    box = torch.full((1, 1, 1, 4), 0.25, device=dev)
    for _ in range(3):
        big = F.conv2d(F.pad(big, (2, 1, 0, 0), mode="replicate"), box)
        big = F.conv2d(F.pad(big, (0, 0, 2, 1), mode="replicate"), box.transpose(2, 3))
    big = big[0, 0]
    shifts = [FLOW_SHIFTS[t % len(FLOW_SHIFTS)] for t in range(frames - 1)]
    ox = oy = 0
    out = [big[margin : margin + h, margin : margin + w]]
    for dx, dy in shifts:
        ox, oy = ox + dx, oy + dy
        # content moved by +d: crop at the origin minus the running shift
        out.append(big[margin - oy : margin - oy + h, margin - ox : margin - ox + w])
    return torch.stack(out).contiguous(), shifts


def flow_phase(dev) -> None:
    """Phase 20a, the TV-L1 flow (``data/optical_flow.py``) on the card at
    the reference's geometry: ``flow_for_video`` on the FLOW_FRAMES - 1 pairs
    of a seeded textured clip as one batch at the defaults (5 scales, 5
    warps, 30 iterations), timed (seconds a clip, ms a pair), its peak
    memory and the kernels it launched (torch.profiler); every pair's
    interior median within FLOW_MEDIAN_PX of its shift; ``frames_to_flow``
    to [1, T-1, 224, 224, 2] equal to the postprocessed flow; and 2 pairs of
    FLOW_PAIR_HW at the defaults on the card against the port's CPU flow."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flickering_adversarial_video_tpu_torch.data import optical_flow
    from flickering_adversarial_video_tpu_torch.data.video import frames_to_flow

    t_phase = time.perf_counter()
    gray, shifts = _textured_clip(torch, dev, FLOW_FRAMES, FLOW_H, FLOW_W, FLOW_MARGIN, SEED + 20)
    pairs = FLOW_FRAMES - 1
    optical_flow.flow_for_video(gray[:3])  # the first call's set-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    flow = optical_flow.flow_for_video(gray)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = optical_flow.flow_for_video(gray)
        torch.cuda.synchronize()
    launched = int(sum(n for _, n, _ in kernel_rows(prof)))
    kernel_ms = sum(ms for ms, _, _ in kernel_rows(prof))
    same_again = torch.equal(flow, again)
    inner = flow[:, FLOW_BORDER:-FLOW_BORDER, FLOW_BORDER:-FLOW_BORDER].reshape(pairs, -1, 2)
    med = inner.median(dim=1).values.cpu().numpy()
    err = np.abs(med - np.asarray(shifts, np.float32))
    finite = bool(torch.isfinite(flow).all())
    print(f"[flow] TV-L1 on the card: {pairs} pairs of [{FLOW_H},{FLOW_W}] as one batch, "
          f"{optical_flow.NSCALES} scales x {optical_flow.WARPS} warps x "
          f"{optical_flow.ITERATIONS} iterations: {clip_s:.3f} s a clip, "
          f"{clip_s / pairs * 1e3:.2f} ms a pair; peak memory {peak_gb:.3f} GB above the clip; "
          f"{launched} kernels launched ({kernel_ms:.1f} ms of kernels under torch.profiler); "
          f"a second run bit-equal {same_again}; interior median error against the shifts max "
          f"{err.max():.3f} px (tolerance {FLOW_MEDIAN_PX}), finite {finite}", flush=True)
    if not (finite and same_again and err.max() < FLOW_MEDIAN_PX and flow.is_cuda):
        fail("the TV-L1 flow on the card: shifts not recovered, not finite or not repeatable")
    t0 = time.perf_counter()
    post = frames_to_flow(gray.cpu().numpy(), 224, device=dev)[np.newaxis]
    f2f_s = time.perf_counter() - t0
    want = optical_flow.postprocess_flow(flow, 224).cpu().numpy()
    post_err = float(np.abs(post[0] - want).max())
    print(f"[flow] frames_to_flow on the card -> {list(post.shape)} in {f2f_s:.3f} s (host copy "
          f"included), max |diff| against the postprocessed flow {post_err:.3e} (tolerance 0), "
          f"range [{post.min():.3f}, {post.max():.3f}]", flush=True)
    if post.shape != (1, pairs, 224, 224, 2) or post_err != 0 or np.abs(post).max() > 1:
        fail("frames_to_flow on the card: shape, values or range")
    small = gray[:3, :FLOW_PAIR_HW[0], :FLOW_PAIR_HW[1]].contiguous()
    card = optical_flow.flow_for_video(small).cpu()
    cpu = optical_flow.flow_for_video(small.cpu())
    card_err = float((card - cpu).abs().max())
    print(f"[flow] 2 pairs of {list(FLOW_PAIR_HW)} at the defaults: the card against the port's "
          f"CPU flow max |diff| {card_err:.3e} px (tolerance {FLOW_CARD_ATOL_PX}; flow max "
          f"{float(cpu.abs().max()):.3f} px) ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if not card_err <= FLOW_CARD_ATOL_PX:
        fail("the TV-L1 flow on the card disagrees with the CPU flow")


def _accounted_inputs(torch, dev, name: str):
    """A call of kernel `name`'s wrapper at its timed shape in PERF.md section 6."""
    from flickering_adversarial_video_tpu_torch.ops import (
        fused_apply, packed_apply, pool_s1, pool_strided, stem_combine, stem_conv)

    bf16 = torch.bfloat16

    def z(*shape, dtype=bf16):
        return torch.zeros(shape, dtype=dtype, device=dev)

    x5, dy5 = (B, T // 2, 112, 112, 64), (B, T // 2, 56, 56, 64)
    xp = (B, T // 2, 28, 28, 192)
    u8_7, u8_8, u8_8c = (B, T // 2, 112, 112, 24), (B, T, SIZE, SIZE, 3), (4, 90, SIZE, SIZE, 3)
    flag = torch.ones((), device=dev)
    return {
        "B1": lambda: stem_conv.stem_conv_bn_relu(
            z(B, T // 2, 112, 112, 24), z(4, 4, 4, 24, 64), z(64, dtype=torch.float32),
            torch.ones(64, device=dev), z(64, dtype=torch.float32)),
        "B2": lambda: stem_combine.temporal_combine(z(B, T // 2, 56, 56, 192), 64, 1),
        "B3": lambda: pool_s1.pool333_fwd(z(*xp)),
        "B4": lambda: pool_s1.pool333_bwd(z(*xp), z(*xp)),
        "B5": lambda: pool_strided.pool133_s2_fwd(z(*x5)),
        "B6": lambda: pool_strided.pool133_s2_bwd(z(*x5), z(*dy5)),
        "B7": lambda: packed_apply.emit_adv_mask(z(*u8_7, dtype=torch.uint8),
                                                 z(T // 2, 24, dtype=torch.float32), -1, 1, bf16),
        "B7c": lambda: packed_apply.emit_adv_mask(z(4, 45, 112, 112, 24, dtype=torch.uint8),
                                                  z(4, 45, 24, dtype=torch.float32), -1, 1, bf16),
        "B8f": lambda: fused_apply.fused_apply_fwd(z(*u8_8, dtype=torch.uint8),
                                                   z(T, 1, 1, 3, dtype=torch.float32), flag),
        "B8b": lambda: fused_apply.fused_apply_bwd(z(*u8_8, dtype=torch.uint8),
                                                   z(T, 1, 1, 3, dtype=torch.float32), flag,
                                                   z(*u8_8, dtype=torch.float32)),
        "B8cf": lambda: fused_apply.fused_apply_fwd(z(*u8_8c, dtype=torch.uint8),
                                                    z(4, 90, 1, 1, 3, dtype=torch.float32), flag),
        "B8cb": lambda: fused_apply.fused_apply_bwd(z(*u8_8c, dtype=torch.uint8),
                                                    z(4, 90, 1, 1, 3, dtype=torch.float32), flag,
                                                    z(*u8_8c, dtype=torch.float32)),
        "B9f": lambda: pool_strided.pool133_s2_pair_fwd(z(*x5)),
        "B9b": lambda: pool_strided.pool133_s2_pair_bwd(z(*dy5, dtype=torch.uint8), z(*dy5)),
    }[name]


def tally_phase(tmp: str, dev):
    """Phase 20b, tracing and the tally (``utils/profiling.py``,
    ``ops/accounting.py``) on the full-width I3D engine (B=8 uint8 clips of
    T x SIZE^2, bf16): ``trace_steps`` around 3 replays of the graphed step
    writes a trace naming B1's and B4's kernels; ``recording()`` around one
    eager step tallies each tag as often as the wrappers count its launches,
    which are a train step's (TRAIN_COUNTS), and the same step on a CPU copy
    (f32, 2 clips of 8 x 32^2) tallies the same tags and counts; each
    kernel's accounted bytes and FLOPs at its timed shape give its bound in
    PERF.md section 6 (TABLE_BOUNDS) within 1%.  Returns the engine and a
    state for phase 20c."""
    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch import ops
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
    from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
    from flickering_adversarial_video_tpu_torch.engine import AttackEngine, RuntimeFlags
    from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
    from flickering_adversarial_video_tpu_torch.ops import accounting, kernels
    from flickering_adversarial_video_tpu_torch.utils.profiling import trace_steps

    t_phase = time.perf_counter()
    flags = RuntimeFlags()
    model = InceptionI3D(CLASSES, torch.bfloat16, device=dev)
    model.load_state_dict(init_i3d_state(SEED, CLASSES))
    engine = AttackEngine(model, FlickerSpec(frames=T), track_probs=False)
    rng = np.random.default_rng(SEED + 21)
    batch = {"video": torch.from_numpy(rng.integers(0, 256, (B, T, SIZE, SIZE, 3),
                                                    dtype=np.uint8)).to(dev),
             "labels": torch.from_numpy(rng.integers(0, CLASSES, (B,))).to(dev)}
    state = engine.train_steps(engine.init_state(), batch, flags, 1)  # warm-up and capture
    torch.cuda.synchronize()
    log_dir = os.path.join(tmp, "trace")
    with trace_steps(log_dir):
        for _ in range(3):
            state = engine.train_steps(state, batch, flags, 1)
    path = os.path.join(log_dir, "trace.json")
    text = open(path).read() if os.path.exists(path) else ""
    named = {k: sum(text.count(m) for m in kernels.KERNEL_SYMBOLS[LAUNCHERS[k]])
             for k in ("B1", "B4")}
    # the trace must name both kernels; torch.profiler has been seen to drop a
    # few of a run's kernel events (one of the 3 B1 events here, 39 of phase
    # 20a's 65,742), so the counts are printed beside the launches, not held
    print(f"[trace] trace_steps around 3 replays of the graphed B={B} step: {path} "
          f"({len(text) / 1e6:.2f} MB), mentions of B1's kernel {named['B1']} (3 launched), "
          f"of B4's {named['B4']} (27 launched)", flush=True)
    if not (named["B1"] and named["B4"]):
        fail("trace_steps: no trace file, or B1's and B4's kernels missing from it")

    def eager_tally(eng, batch_):
        ops.reset_launch_counts()
        with accounting.recording() as tally:
            eng._train_step(eng.init_state(), *eng.prepare_batch(batch_), flags)
        return tally, read_counts(ops)

    tally, counts = eager_tally(engine, batch)
    torch.cuda.synchronize()
    launched = {k: n for k, n in counts.items() if n}
    want = {k: n for k, n in TRAIN_COUNTS.items() if n}
    cpu_model = InceptionI3D(CLASSES, torch.float32, device="cpu")
    cpu_model.load_state_dict(init_i3d_state(SEED, CLASSES))
    cpu_batch = {"video": batch["video"][:2, :8, :32, :32].contiguous().cpu(),
                 "labels": batch["labels"][:2].cpu()}
    cpu_tally, _ = eager_tally(AttackEngine(cpu_model, FlickerSpec(frames=8), track_probs=False),
                               cpu_batch)
    print(f"[tally] recording() around one eager B={B} step on the card: calls by tag "
          f"{tally.counts()}, the wrappers' launches {launched} (a train step's {want}); "
          f"{tally.flops / 1e9:.3f} GFLOP and {tally.hbm_bytes / 1e9:.3f} GB accounted; the same "
          f"step on a CPU copy (f32, [2,8,32,32,3]): {cpu_tally.counts()}", flush=True)
    if not (tally.counts() == launched == want == cpu_tally.counts()):
        fail("the tally's calls differ from the wrappers' launch counts or between the devices")
    for name, table_ms in TABLE_BOUNDS.items():
        with accounting.recording() as one:
            _accounted_inputs(torch, dev, name)()
        torch.cuda.synchronize()
        (tag, flops, nbytes), = one.calls
        peak = PEAK_BF16_FLOPS if name == "B1" else PEAK_F32_FLOPS
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[tally] {name}: {nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP accounted -> bound "
              f"{bound:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; at 3.35 TB/s, "
              f"989 / 67 TFLOP/s); PERF.md's {table_ms} ms", flush=True)
        if tag != name or abs(bound - table_ms) > 0.01 * table_ms:
            fail(f"{name}: the tally's bound differs from PERF.md's by more than 1%")
    print(f"[tally] ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return engine, state


def epoch_loader_phase(shard_dir: str, dev, engine, state) -> None:
    """Phase 20c, the epoch loader (``data/grain_pipeline.py``):
    ``GrainEpochLoader`` with LOADER_WORKERS spawned workers over
    LOADER_EPOCHS epochs of phase 7's shards; each epoch, as a multiset of
    (label, digest of the video), equal to one pass of the native reader over
    the same shards, with exact boundaries (every epoch the shards' records,
    in batches of B); the host MB/s of each epoch; one graphed step of phase
    20b's engine on its first batch."""
    import hashlib

    import numpy as np
    import torch

    from flickering_adversarial_video_tpu_torch.data import list_shards, tfrecord_batches
    from flickering_adversarial_video_tpu_torch.data.grain_pipeline import GrainEpochLoader
    from flickering_adversarial_video_tpu_torch.engine import RuntimeFlags

    def keys(batches):
        return sorted((int(label), hashlib.sha1(np.ascontiguousarray(video).tobytes()).hexdigest())
                      for b in batches for video, label in zip(b["video"], b["labels"]))

    shards = list_shards(shard_dir)
    native = keys(tfrecord_batches(shards, B, frames=T))
    t0 = time.perf_counter()
    loader = GrainEpochLoader(shards, B, epochs=LOADER_EPOCHS, frames=T,
                              worker_count=LOADER_WORKERS, seed=SEED)
    rows, first = [], None
    for epoch in range(LOADER_EPOCHS):
        t1 = time.perf_counter()
        batches = list(loader.epoch_batches())
        secs = time.perf_counter() - t1
        nbytes = sum(b["video"].nbytes for b in batches)
        exact = ([len(b["labels"]) for b in batches] == [B] * (SHARDS * PER_SHARD // B)
                 and keys(batches) == native)
        rows.append(f"epoch {epoch + 1}: {len(batches)} batches, equal to the native reader's "
                    f"pass {exact}, {nbytes / secs / 1e6:.0f} MB/s")
        if not exact:
            fail(f"GrainEpochLoader epoch {epoch + 1} differs from the native reader's pass")
        first = first or batches[0]
    total_s = time.perf_counter() - t0
    state, metrics = engine.train_step(state, first, RuntimeFlags())
    torch.cuda.synchronize()
    loss = float(metrics["total_loss"])
    print(f"[loader] GrainEpochLoader({LOADER_WORKERS} spawned workers, {LOADER_EPOCHS} epochs) "
          f"on phase 7's shards: {'; '.join(rows)} (the first epoch's time includes the "
          f"workers' start; {total_s:.1f} s in all; phase 7's [input] lines give the readers' "
          f"MB/s); one graphed step on its first batch: total_loss {loss:.6f}, graphed "
          f"{engine.graphed}", flush=True)
    if not (math.isfinite(loss) and engine.graphed):
        fail("the graphed step on the epoch loader's batch")


def main() -> None:
    sys.path.insert(0, HERE)
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from flickering_adversarial_video_tpu_torch import ops
        from flickering_adversarial_video_tpu_torch.attack import FlickerSpec, SparseSpec
        from flickering_adversarial_video_tpu_torch.convert import (
            cli as convert_cli, convert_i3d_var_map, golden, i3d_var_map, init_i3d_state,
            to_flax_variables)
        from flickering_adversarial_video_tpu_torch.data import (
            PrefetchIterator, TFRecordWriter, list_shards, make_uint8_example, pack_video_np,
            tfrecord_batches)
        from flickering_adversarial_video_tpu_torch.utils.labels import kinetics600_labels
        from flickering_adversarial_video_tpu_torch.engine import (
            AttackConfig, AttackEngine, RuntimeFlags)
        from flickering_adversarial_video_tpu_torch.engine import attack_step, loops
        from flickering_adversarial_video_tpu_torch.engine.step_graph import WARMUP_STEPS
        from flickering_adversarial_video_tpu_torch.data.npy import save_npy_clip
        from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
        from flickering_adversarial_video_tpu_torch.engine.inference import InferenceModel
        from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
        from flickering_adversarial_video_tpu_torch.ops import fused_apply, kernels, packed_apply
        from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided
        from flickering_adversarial_video_tpu_torch.ops import stem_combine, stem_conv
        from flickering_adversarial_video_tpu_torch.ops.space_to_depth import pack_input
        from flickering_adversarial_video_tpu_torch.runners import (
            class_gen, common, single_video, universal)
        from flickering_adversarial_video_tpu_torch.utils import system
        from flickering_adversarial_video_tpu_torch.utils.config import load_config
        from flickering_adversarial_video_tpu_torch.viz.results import load_result
        from torch.profiler import ProfilerActivity, profile
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if any(m == "jax" or m.startswith(("jax.", "flickering_adversarial_video_tpu."))
           for m in sys.modules):
        fail("jax or the JAX package was imported")
    info = system.system_info()
    print(f"[system] {info}; device_kind {system.device_kind()!r}; num_devices "
          f"{system.num_devices()} (torch.cuda.device_count() {torch.cuda.device_count()})",
          flush=True)
    if system.num_devices() != torch.cuda.device_count() or info["backend"] != "cuda":
        fail("utils.system counts other devices than torch.cuda")
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

    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def drandn(*shape, dtype=torch.float32):
        """Made on the card: the many large tensors of the later checks."""
        return torch.randn(*shape, generator=dgen, device=dev).to(dtype)

    def drandint(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=dgen, device=dev).to(dtype)

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
    # the branch_3 pool's input of the other Mixed blocks B4 runs at (3b is
    # shapes["B4"], 5c shape5c): 28x28 in 4 tiles, 14x14 in one, and C = 528,
    # which is no multiple of 32 channels; then an odd geometry, partial in
    # every tile dimension, and one whose C takes the scalar tail (not a
    # multiple of B4's 16-byte channel vector)
    b4_shapes = {"Mixed_3c": (B, T // 2, th // 4, tw // 4, 256),
                 "Mixed_4b": (B, T // 4, th // 8, tw // 8, 480),
                 "Mixed_4f": (B, T // 4, th // 8, tw // 8, 528),
                 "odd": (1, 3, 5, 7, 40), "odd, C=13": (2, 3, 5, 7, 13)}
    # relative tolerances, max |err| / max |plain|: bf16 rounds differently
    # when the f32 sums' order differs (B1 64-tap contraction); every other
    # kernel, B4 and B6 included, is held bit-equal (tolerance 0)
    tol = {("B1", torch.bfloat16): 1e-2, ("B1", torch.float32): 1e-5}
    checks = {}
    inputs = {}

    def hold(name, kern, plain, dtype):
        """Run a kernel and its plain version; (max abs err, max rel err),
        failing above the kernel's tolerance."""
        got = kern()
        torch.cuda.synchronize()
        err, rel = compare(got, plain())
        limit = tol.get((name.split()[0], dtype), 0.0)
        print(f"[check] {name:13s} {str(dtype)[6:]:8s} max_abs_err {err:.3e} "
              f"max_rel_err {rel:.3e} (max_rel_err tolerance {limit:g})", flush=True)
        if not rel <= limit:
            fail(f"{name} {dtype} disagrees with its plain version")
        return err, rel

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
            checks[(name, dtype)] = hold(name, kern, plain, dtype)
        for block, shape4 in b4_shapes.items():
            x4, dy4 = drandn(*shape4, dtype=dtype), drandn(*shape4, dtype=dtype)
            hold(f"B4 {block}", lambda: pool_s1.pool333_bwd(x4, dy4),
                 lambda: pool_s1.pool333_bwd_plain(x4, dy4), dtype)
            del x4, dy4
        if dtype == torch.bfloat16:
            inputs = dict(x1=x1, pk=pk, bn=bn, xp=xp, dy=dy, x5=x5, dy5=dy5, runs=runs,
                          b2_stem=runs_5c["B2 stem dgrad"])
    for name, shape4 in (("B4", shapes["B4"]), ("B4 Mixed_5c", shape5c),
                         ("B4 odd", b4_shapes["odd"]), ("B4 odd, C=13", b4_shapes["odd, C=13"])):
        ties = torch.randint(0, 3, shape4, generator=gen).to(dev, torch.float32)
        dyi = torch.randint(-8, 9, shape4, generator=gen).to(dev, torch.float32)
        err, _ = compare(pool_s1.pool333_bwd(ties, dyi), pool_s1.pool333_bwd_plain(ties, dyi))
        print(f"[check] {name} integer tie grid f32 max_abs_err {err:.3e} (tolerance 0)",
              flush=True)
        if err != 0:
            fail(f"{name} is not exact on the integer tie grid")
        del ties, dyi

    def same(got, want):
        """Bit-equal, NaN where NaN."""
        nan = want.isnan()
        return torch.equal(got.isnan(), nan) and torch.equal(got.masked_fill(nan, 0),
                                                             want.masked_fill(nan, 0))

    # B5, B9 forward and B6 at the step's three strided pools (MaxPool3d_2a,
    # 3a, the spatial half of 4a: C = 480 is no multiple of a 64-channel
    # group; 3a and 4a take two groups of channel vectors), the single-video
    # clip's three (B*T' = 45: runs of window rows) and six edge geometries
    # (one window with the pads in both axes; 3 window rows; the scalar
    # channel tail; W' = 1; H' = 17 in runs of 5; C = 40 over 112 window
    # columns, split into groups): bit-equal on random, integer-tie and
    # NaN/-inf grids (NaN where NaN); B9 forward's y equals B5's, its index
    # the plain version's, and without an index it writes y alone
    b6_shapes = {"2a": shapes["B6"], "3a": (B, T // 2, th // 2, tw // 2, 192),
                 "4a spatial": (B, T // 2, th // 4, tw // 4, 480)}
    for key, shape6 in list(b6_shapes.items()):
        b6_shapes[f"{key} [1,{SV_FRAMES // 2},..]"] = (1, SV_FRAMES // 2, *shape6[2:])
    b6_shapes.update({"one window": (1, 3, 2, 2, 8), "3 rows": (2, 3, 6, 10, 40),
                      "C=13": (2, 1, 4, 6, 13), "W'=1": (2, 3, 10, 2, 8),
                      "H'=17": (1, 1, 34, 8, 8), "C=40 groups": (1, 3, 8, 224, 40)})
    # the odd geometry's MaxPool3d_2a (ODD_SIZE 220: 110x110; its 3a is odd
    # and takes the generic pool, its 4a is the step's) and the wide clip's
    # three (WIDE_SIZE 288: 144, 72, 36)
    wide_pools = {"2a wide": (1, SV_FRAMES // 2, WIDE_SIZE // 2, WIDE_SIZE // 2, 64),
                  "3a wide": (1, SV_FRAMES // 2, WIDE_SIZE // 4, WIDE_SIZE // 4, 192),
                  "4a wide": (1, SV_FRAMES // 2, WIDE_SIZE // 8, WIDE_SIZE // 8, 480)}
    b6_shapes.update({"2a odd": (B, (ODD_FRAMES + 1) // 2, ODD_SIZE // 2, ODD_SIZE // 2, 64),
                      **wide_pools})
    for block, shape6 in b6_shapes.items():
        pooled6 = (*shape6[:2], shape6[2] // 2, shape6[3] // 2, shape6[4])
        for dtype in (torch.bfloat16, torch.float32):
            for grid in ("random", "integer ties", "NaN/-inf"):
                if grid == "random":
                    x6, dy6 = drandn(*shape6, dtype=torch.float32), drandn(*pooled6)
                else:
                    x6 = drandint(0, 3, shape6, torch.float32)
                    dy6 = drandint(-8 if grid == "integer ties" else 1, 9, pooled6, torch.float32)
                if grid == "NaN/-inf":
                    spots = torch.randint(0, x6.numel(), (max(1, x6.numel() // 1000),),
                                          generator=dgen, device=dev)
                    x6.view(-1)[spots] = float("nan")
                    x6[:, :, shape6[2] // 2:, shape6[3] // 2:] = float("-inf")
                x6, dy6 = x6.to(dtype), dy6.to(dtype)
                y5 = pool_strided.pool133_s2_fwd(x6)
                y9, idx9 = pool_strided.pool133_s2_pair_fwd(x6)
                canary = torch.full((y9.numel(),), 171, dtype=torch.uint8, device=dev)
                y0, no_idx = pool_strided.pool133_s2_pair_fwd(x6, want_idx=False)
                got = pool_strided.pool133_s2_bwd(x6, dy6)
                dx9 = pool_strided.pool133_s2_pair_bwd(idx9, dy6)
                torch.cuda.synchronize()
                want_y, want_idx = pool_strided.pool133_s2_pair_fwd_plain(x6)
                ok5 = same(y5, pool_strided.pool133_s2_fwd_plain(x6))
                ok9 = (same(y9, want_y) and torch.equal(idx9, want_idx) and same(y9, y5)
                       and no_idx is None and same(y0, y9) and bool((canary == 171).all()))
                want = pool_strided.pool133_s2_bwd_plain(x6, dy6)
                err, _ = compare(got, want)
                # B9's backward against its plain version on the same index,
                # and against B6 where no window holds a NaN (B6 routes one by
                # select-and-scatter, B9 not at all)
                ok9b = (same(dx9, pool_strided.pool133_s2_pair_bwd_plain(want_idx, dy6))
                        and (grid == "NaN/-inf" or torch.equal(dx9, got)))
                print(f"[check] B5/B9/B6 {block} {list(shape6)} {str(dtype)[6:]:8s} {grid}: B5 "
                      f"{'bit-equal' if ok5 else 'DIFFERS'}; B9 forward y, index, y against B5, "
                      f"null index {'equal' if ok9 else 'DIFFER'}; B6 max_abs_err {err:.3e}; B9 "
                      f"backward {'bit-equal' if ok9b else 'DIFFERS'} (tolerance 0)", flush=True)
                if not ok5:
                    fail(f"B5 is not bit-equal to its plain version at {shape6} {dtype} ({grid})")
                if not ok9:
                    fail(f"B9 forward disagrees with its plain version at {shape6} {dtype} ({grid})")
                if not torch.equal(got, want):
                    fail(f"B6 is not bit-equal to its plain version at {shape6} {dtype} ({grid})")
                if not ok9b:
                    fail(f"B9 backward disagrees with its plain version or B6 at {shape6} {dtype} "
                         f"({grid})")
                del x6, dy6, got, want, y5, y9, idx9, canary, y0, want_y, want_idx, dx9

    def nan_grid(shape):
        """An integer-tie grid with NaNs (one value in 1000) and a -inf block."""
        x = drandint(0, 3, shape, torch.float32)
        spots = torch.randint(0, x.numel(), (max(1, x.numel() // 1000),), generator=dgen,
                              device=dev)
        x.view(-1)[spots] = float("nan")
        x[:, :, shape[2] // 2:, shape[3] // 2:] = float("-inf")
        return x

    # B3 at the nine branch pools of the step, the single-video clip's three
    # and edge geometries (H, W of 1 and across the 14-cell tile; T = 1, 2;
    # C = 13, the scalar tail), bit-equal on random, integer-tie and NaN/-inf
    # grids
    b3_shapes = {**POOL_STEP, **{f"T'={tq}": (1, tq, *POOL_STEP[k][2:])
                                 for tq, k in ((SV_FRAMES // 2, "Mixed_3b"), (23, "Mixed_4b"),
                                               (12, "Mixed_5b"))},
                 "edge 1": (2, 1, 15, 29, 13), "edge 2": (1, 2, 29, 15, 16),
                 "edge 3": (3, 2, 1, 1, 8), "edge 4": (1, 1, 29, 1, 40)}
    for block, shape3 in b3_shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            for grid in ("random", "integer ties", "NaN/-inf"):
                x3 = (drandn(*shape3) if grid == "random" else
                      drandint(0, 3, shape3, torch.float32) if grid == "integer ties" else
                      nan_grid(shape3)).to(dtype)
                got = pool_s1.pool333_fwd(x3)
                torch.cuda.synchronize()
                ok = same(got, pool_s1.pool333_fwd_plain(x3))
                print(f"[check] B3 {block} {list(shape3)} {str(dtype)[6:]:8s} {grid}: "
                      f"{'bit-equal' if ok else 'DIFFERS'} (tolerance 0)", flush=True)
                if not ok:
                    fail(f"B3 is not bit-equal to its plain version at {shape3} {dtype} ({grid})")
                del x3, got

    # B2 at every distinct combine shape of the step, bit-equal
    seen = set()
    for block, dims, cin in COMBINE_STEP:
        if (dims, cin) in seen:
            continue
        seen.add((dims, cin))
        for dtype in (torch.bfloat16, torch.float32):
            part2 = drandn(*dims, 3 * cin, dtype=dtype)
            got = stem_combine.temporal_combine(part2, cin, 1)
            torch.cuda.synchronize()
            ok = torch.equal(got, stem_combine.temporal_combine_plain(part2, cin, 1))
            print(f"[check] B2 {block} {list(part2.shape)} {str(dtype)[6:]:8s}: "
                  f"{'bit-equal' if ok else 'DIFFERS'} (tolerance 0)", flush=True)
            if not ok:
                fail(f"B2 is not bit-equal to its plain version at {block} {dtype}")
            del part2, got

    # B1 at the edges of its tiling: W' = 112 (a ragged second 64-position
    # tile), 56 (one tile), 100 with an odd H' (a half-used row pair), 128
    # (the widest row) with T' = 1
    for edge in ((2, 3, 8, 112, 24), (2, 3, 8, 56, 24), (1, 2, 7, 100, 24), (2, 1, 6, 128, 24)):
        for dtype in (torch.bfloat16, torch.float32):
            xe = (torch.randint(0, 256, edge, generator=gen).float() / 128 - 1).to(dev, dtype)
            pke = randn(4, 4, 4, 24, 64, dtype=dtype) * 0.05
            bne = (randn(64), randn(64).abs() + 0.5, randn(64))
            hold(f"B1 {list(edge)}", lambda: stem_conv.stem_conv_bn_relu(xe, pke, *bne),
                 lambda: stem_conv.stem_conv_bn_relu_plain(xe, pke, *bne), dtype)

    # B1 above its 128 columns: the wide clip's [1,45,144,144,24] in 2 column
    # segments against the plain version (B1's tolerance), and the segments'
    # independence: bit-equal to 4 segments (max_w 40), and at W' = 112 two
    # segments (max_w 64) bit-equal to one launch
    b1_wide = (1, SV_FRAMES // 2, WIDE_SIZE // 2, WIDE_SIZE // 2, 24)
    for dtype in (torch.bfloat16, torch.float32):
        xw = (drandint(0, 256, b1_wide, torch.float32) / 128 - 1).to(dtype)
        pkw = drandn(4, 4, 4, 24, 64, dtype=dtype) * 0.05
        bnw = (drandn(64), drandn(64).abs() + 0.5, drandn(64))
        checks[("B1 wide", dtype)] = hold(
            f"B1 {list(b1_wide)}", lambda: stem_conv.stem_conv_bn_relu(xw, pkw, *bnw),
            lambda: stem_conv.stem_conv_bn_relu_plain(xw, pkw, *bnw), dtype)
        two = stem_conv.stem_conv_bn_relu(xw, pkw, *bnw)
        four = stem_conv.stem_conv_bn_relu(xw, pkw, *bnw, max_w=40)
        x112 = xw[:, :4, :16, :112].contiguous()
        one = stem_conv.stem_conv_bn_relu(x112, pkw, *bnw)
        split = stem_conv.stem_conv_bn_relu(x112, pkw, *bnw, max_w=64)
        torch.cuda.synchronize()
        ok = torch.equal(two, four) and torch.equal(one, split)
        print(f"[check] B1 column segments {str(dtype)[6:]:8s}: W'=144 in "
              f"{len(stem_conv.stem_segments(144))} against {len(stem_conv.stem_segments(144, 40))} "
              f"segments, W'=112 in one launch against {len(stem_conv.stem_segments(112, 64))}: "
              f"{'bit-equal' if ok else 'DIFFER'} (tolerance 0)", flush=True)
        if not ok:
            fail(f"B1's result depends on its column segments ({dtype})")
        if dtype == torch.bfloat16:
            inputs["b1_wide"] = (pkw, bnw)
        del xw, two, four, x112, one, split

    # The NaN rule: a NaN and a -inf block reach B1 and B3..B6.  Each kernel
    # equals its plain version: NaN positions equal, and the other values
    # equal (B1 to its tolerance; the pools and their routed gradients exactly)
    for dtype in (torch.bfloat16, torch.float32):
        xn = torch.randint(0, 3, (1, 2, 4, 4, 2), generator=gen).float()
        xn[0, 0, 0, 1, 0] = float("nan")
        xn[0, :, 2:, 2:, :] = float("-inf")
        xn = xn.to(dev, dtype)
        dyn = torch.randint(1, 9, xn.shape, generator=gen).to(dev, dtype)
        dyn5 = torch.randint(1, 9, (1, 2, 2, 2, 2), generator=gen).to(dev, dtype)
        xs1 = (torch.randint(-3, 4, (1, 2, 4, 4, 24), generator=gen).float() / 4).to(dev, dtype)
        xs1[0, 0, 0, 0, 5] = float("nan")
        xs1[0, :, 3, 3, :] = float("-inf")
        pkn = randn(4, 4, 4, 24, 64, dtype=dtype) * 0.05
        bnn = (randn(64), randn(64).abs() + 0.5, randn(64))
        for name, kern, plain in (
            ("B1", lambda: stem_conv.stem_conv_bn_relu(xs1, pkn, *bnn),
             lambda: stem_conv.stem_conv_bn_relu_plain(xs1, pkn, *bnn)),
            ("B3", lambda: pool_s1.pool333_fwd(xn), lambda: pool_s1.pool333_fwd_plain(xn)),
            ("B4", lambda: pool_s1.pool333_bwd(xn, dyn), lambda: pool_s1.pool333_bwd_plain(xn, dyn)),
            ("B5", lambda: pool_strided.pool133_s2_fwd(xn),
             lambda: pool_strided.pool133_s2_fwd_plain(xn)),
            ("B6", lambda: pool_strided.pool133_s2_bwd(xn, dyn5),
             lambda: pool_strided.pool133_s2_bwd_plain(xn, dyn5)),
        ):
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            inf = want.isinf()
            same_nan = torch.equal(got.isnan(), want.isnan()) and torch.equal(got[inf], want[inf])
            keep = want.isfinite()
            err, rel = compare(got[keep], want[keep])
            limit = tol.get((name, dtype), 0.0) if name == "B1" else 0.0
            print(f"[check] {name} NaN/-inf grid {str(dtype)[6:]:8s} NaN positions "
                  f"{'equal' if same_nan else 'DIFFER'} ({int(want.isnan().sum())} NaN, {int(inf.sum())} inf, "
                  f"equal); finite values "
                  f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (max_rel_err tolerance "
                  f"{limit:g})", flush=True)
            if not (same_nan and rel <= limit):
                fail(f"{name} {dtype} breaks the NaN rule of its plain version")
        del xn, dyn, dyn5, xs1

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

    # B9: the index pair at MaxPool3d_2a's and 3a's shapes and at the
    # single-video clip's.  Forward: values bit-equal to the plain version and
    # to B5's, the index equal everywhere (the plain version's first-match
    # rule is held against the Pallas kernel on the CPU).  Backward: bit-equal
    # to the plain version (the same <=4 f32 terms in the same order, one
    # rounding), exact on integer grids; and bit-equal to B6 on the same
    # (x, dy): without NaN both route a window to its first maximum and sum
    # a cell's terms in ascending tap order in f32, rounding once.
    pair_shapes = (shapes["B5"], (B, T // 2, th // 2, tw // 2, 192),
                   (1, SV_FRAMES // 2, th, tw, 64))
    for shape9 in pair_shapes:
        pooled9 = (*shape9[:2], shape9[2] // 2, shape9[3] // 2, shape9[4])
        for dtype in (torch.bfloat16, torch.float32):
            for grid in ("random", "integer ties"):
                if grid == "random":
                    x9, dy9 = drandn(*shape9, dtype=dtype), drandn(*pooled9, dtype=dtype)
                else:
                    x9 = drandint(0, 3, shape9, dtype)
                    dy9 = drandint(-8, 9, pooled9, dtype)
                y9, idx9 = pool_strided.pool133_s2_pair_fwd(x9)
                torch.cuda.synchronize()
                want_y, want_idx = pool_strided.pool133_s2_pair_fwd_plain(x9)
                yerr, _ = compare(y9, want_y)
                ierr = (idx9.int() - want_idx.int()).abs().max().item()
                b5err, _ = compare(y9, pool_strided.pool133_s2_fwd(x9))
                del want_y
                canary = torch.full((y9.numel(),), 171, dtype=torch.uint8, device=dev)
                y_only, no_idx = pool_strided.pool133_s2_pair_fwd(x9, want_idx=False)
                torch.cuda.synchronize()
                null_ok = (no_idx is None and torch.equal(y_only, y9)
                           and bool((canary == 171).all()))
                del canary, y_only
                dx9 = pool_strided.pool133_s2_pair_bwd(idx9, dy9)
                torch.cuda.synchronize()
                berr, _ = compare(dx9, pool_strided.pool133_s2_pair_bwd_plain(want_idx, dy9))
                b6err, _ = compare(dx9, pool_strided.pool133_s2_bwd(x9, dy9))
                print(f"[check] B9 {list(shape9)} {str(dtype)[6:]:8s} {grid}: forward y "
                      f"max_abs_err {yerr:.3e}, index max_abs_err {ierr}, y against B5 {b5err:.3e} "
                      f"(tolerance 0); indices used {sorted(idx9.unique().tolist())}; null-index "
                      f"forward {'writes values only' if null_ok else 'DIFFERS'}; backward "
                      f"max_abs_err {berr:.3e} (tolerance 0); against B6 max_abs_err {b6err:.3e} "
                      f"(tolerance 0)", flush=True)
                if yerr != 0 or ierr != 0 or b5err != 0 or not null_ok or berr != 0:
                    fail(f"B9 disagrees with its plain version at {shape9} {dtype} ({grid})")
                if b6err != 0:
                    fail(f"B9 backward disagrees with B6 at {shape9} {dtype} ({grid})")
                if grid == "random" and shape9 == shapes["B5"] and dtype == torch.bfloat16:
                    checks[("B9f", dtype)] = (max(yerr, float(ierr)), 0.0)
                    checks[("B9b", dtype)] = (berr, 0.0)
                del x9, dy9, y9, idx9, want_idx, dx9
    x5, dy5 = inputs["x5"], inputs["dy5"]
    idx5 = pool_strided.pool133_s2_pair_fwd(x5)[1]
    inputs["runs"]["B9f"] = (lambda: pool_strided.pool133_s2_pair_fwd(x5),
                             lambda: pool_strided.pool133_s2_pair_fwd_plain(x5))
    inputs["runs"]["B9b"] = (lambda: pool_strided.pool133_s2_pair_bwd(idx5, dy5),
                             lambda: pool_strided.pool133_s2_pair_bwd_plain(idx5, dy5))

    # B1..B4 at the single-video attack's shapes (B5's and B6's are above): B=1,
    # T=90 gives T' = 45 -> 23 -> 12 down the trunk, so B*T' is odd
    tp = SV_FRAMES // 2
    sv_part = {45: (1, 45, th // 2, tw // 2, 3 * 64),     # Conv3d_2c backward
               23: (1, 23, th // 8, tw // 8, 3 * 112),    # Mixed_4c Branch_1 3x3 backward
               12: (1, 12, th // 16, tw // 16, 3 * 160)}  # Mixed_5b Branch_1 3x3 backward
    sv_pool = ((1, 45, th // 4, tw // 4, 192), (1, 23, th // 8, tw // 8, 480),
               (1, 12, th // 16, tw // 16, 832))
    for dtype in (torch.bfloat16, torch.float32):
        x1s = (drandint(0, 256, (1, tp, th, tw, 24), torch.float32) / 128 - 1).to(dtype)
        pks = drandn(4, 4, 4, 24, 64, dtype=dtype) * 0.05
        bns = (drandn(64), drandn(64).abs() + 0.5, drandn(64))
        hold("B1 [1,45,..]", lambda: stem_conv.stem_conv_bn_relu(x1s, pks, *bns),
             lambda: stem_conv.stem_conv_bn_relu_plain(x1s, pks, *bns), dtype)
        for tq, pshape in sv_part.items():
            part_s = drandn(*pshape, dtype=dtype)
            cin = pshape[-1] // 3
            hold(f"B2 T'={tq}", lambda: stem_combine.temporal_combine(part_s, cin, 1),
                 lambda: stem_combine.temporal_combine_plain(part_s, cin, 1), dtype)
        # the stem's own dgrad (a float32 clip takes an input gradient): the
        # step's 20th B2 launch, 4 taps of 24 channels
        part4s = drandn(1, tp, th, tw, 4 * 24, dtype=dtype)
        hold(f"B2 stem T'={tp}", lambda: stem_combine.temporal_combine(part4s, 24, 1),
             lambda: stem_combine.temporal_combine_plain(part4s, 24, 1), dtype)
        for pshape in sv_pool:
            xs, dys = drandn(*pshape, dtype=dtype), drandn(*pshape, dtype=dtype)
            hold(f"B3 T'={pshape[1]}", lambda: pool_s1.pool333_fwd(xs),
                 lambda: pool_s1.pool333_fwd_plain(xs), dtype)
            hold(f"B4 T'={pshape[1]}", lambda: pool_s1.pool333_bwd(xs, dys),
                 lambda: pool_s1.pool333_bwd_plain(xs, dys), dtype)
        del x1s, pks, xs, dys, part_s, part4s

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

    def traced(run):
        """`run()` with every launch count set to 0 just before and read just
        after, under torch.profiler: (its result, the wrappers' counts, the
        launches of each wrapper's kernels that ran on the device)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run()
            torch.cuda.synchronize()
        return out, read_counts(ops), device_launches(prof, kernels)

    def main_path():
        state = engine.train_steps(engine.init_state(), batch, flags, STEPS)
        state, metrics = engine.train_step(state, batch, flags)
        return state, metrics, engine.eval_step(state.delta, batch, flags)

    # the main path from a new engine, the first call's warm-up and capture
    # included: the wrappers count a capture's launches once and each replay
    # adds them (the step's counts); the device also ran the warm-up's steps
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, metrics, ev), counts, main_device = traced(main_path)
    main_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_train = STEPS + 1
    want = scaled(TRAIN_COUNTS, n_train, EVAL_COUNTS)
    want_device = scaled(TRAIN_COUNTS, WARMUP_STEPS + n_train, EVAL_COUNTS)
    print(f"[slice] {n_train} train steps + 1 eval step in {main_s:.2f} s (traced; the step "
          f"graph's {WARMUP_STEPS} warm-up steps and capture included); launches counted by the "
          f"wrappers {counts} (expected {want}); launches on the device by torch.profiler "
          f"{main_device} (expected {want_device}); peak memory {peak_gb:.2f} GB", flush=True)
    if counts != want or main_device != want_device:
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

    # the same step with MaxPool3d_2a on the index pair (B9): exact counts,
    # the first loss and the first d(delta) beside the default engine's.  Both
    # compute the same pooled values; the routed gradient differs by the f32
    # sum order in cells that collect several windows, then by bf16 rounding
    # downstream: 1e-3 relative on the loss, cosine >= 0.99 on d(delta)
    # (Adam's first moment after one step from zero is 0.1 * gradient)
    def with_pair(pools):
        m = InceptionI3D(CLASSES, torch.bfloat16, device=dev, pair_pools=pools)
        m.load_state_dict(model.state_dict())
        return AttackEngine(m, FlickerSpec(frames=T), track_probs=False)

    pair_engine = with_pair(("MaxPool3d_2a_3x3",))
    first, first_m = engine.train_step(engine.init_state(), batch, flags)
    (pfirst, pfirst_m), got_train, dev_train = traced(
        lambda: pair_engine.train_step(pair_engine.init_state(), batch, flags))
    pev, got_eval, dev_eval = traced(lambda: pair_engine.eval_step(pfirst.delta, batch, flags))
    want_dev_train = scaled(PAIR_TRAIN_COUNTS, WARMUP_STEPS + 1)
    l0, l1 = float(first_m["total_loss"]), float(pfirst_m["total_loss"])
    g0, g1 = (first.mu * 10).flatten().double(), (pfirst.mu * 10).flatten().double()
    cos = F.cosine_similarity(g0, g1, dim=0).item()
    print(f"[slice] pair at MaxPool3d_2a: train step launches {got_train} (expected "
          f"{PAIR_TRAIN_COUNTS}), on the device with the capture's warm-up {dev_train} (expected "
          f"{want_dev_train}); eval step launches {got_eval}, on the device {dev_eval} (expected "
          f"{PAIR_EVAL_COUNTS}); first total_loss {l1:.6f} against the default engine's "
          f"{l0:.6f} (rel diff {abs(l1 - l0) / max(abs(l0), 1e-30):.2e}, tolerance 1e-3); first "
          f"d(delta) max abs {g0.abs().max().item():.3e}, max abs difference "
          f"{(g1 - g0).abs().max().item():.3e}, cosine {cos:.6f} (required >= 0.99)", flush=True)
    if (got_train != PAIR_TRAIN_COUNTS or dev_train != want_dev_train
            or got_eval != PAIR_EVAL_COUNTS or dev_eval != PAIR_EVAL_COUNTS):
        fail("kernel launch counts of the pair configuration differ from the per-step counts")
    if not (abs(l1 - l0) <= 1e-3 * abs(l0) and cos >= 0.99):
        fail("the pair configuration's first step disagrees with the default engine's")
    if not torch.isfinite(pev["adv_probs"]).all():
        fail("the pair configuration's eval probabilities are not finite")
    del first, pfirst, pev, g0, g1

    # the graphed step against the eager step (the engine's _train_step)
    # from init_state, 3 steps each, at full width in the four configurations:
    # delta, mu, nu and every metric bit for bit (NaN where NaN); the graphed
    # run's launches, counted and on the device, exact
    def bit_equal(a, b):
        if not torch.is_tensor(a):
            return a == b
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    def eager_step(eng, state_, batch_, flags_=flags, seed=0):
        return eng._train_step(state_, *eng.prepare_batch(batch_), flags_, seed)

    def three_steps(model_, batch_, cfg, spec, graphed, flags_=flags, seed=0):
        e = AttackEngine(model_, spec, cfg, track_probs=False)
        s, ms = e.init_state(), []
        for _ in range(3):
            s, m = (e.train_step(s, batch_, flags_, seed) if graphed
                    else eager_step(e, s, batch_, flags_, seed))
            ms.append(m)
        torch.cuda.synchronize()
        return [s.delta.clone(), s.mu.clone(), s.nu.clone(), s.step] + [
            m[k] for m in ms for k in sorted(m)]

    sv_batch = {"video": torch.from_numpy(np.random.default_rng(SEED + 3).uniform(
        -1, 1, (1, SV_FRAMES, SIZE, SIZE, 3)).astype(np.float32)).to(dev),
        "labels": batch["labels"][:1]}
    # the odd geometry (uint8 clips of ODD_FRAMES x ODD_SIZE^2), the L1,2
    # sparse attack (a full delta) and the cyclic rolls (both flags, seeded:
    # the shifts come from the seed and the device's step count) take the
    # generic input path
    odd_batch = {"video": torch.from_numpy(rng.integers(
        0, 256, (B, ODD_FRAMES, ODD_SIZE, ODD_SIZE, 3), dtype=np.uint8)).to(dev),
        "labels": batch["labels"]}
    cyclic_flags = RuntimeFlags(cyclic_flag=1.0, cyclic_pert_flag=1.0)
    graph_device = {}
    for tag, model_, batch_, cfg, spec, flags_, seed, step_counts in (
        (f"B={B} default", model, batch, AttackConfig(), FlickerSpec(T), flags, 0, TRAIN_COUNTS),
        (f"B={B} pair at MaxPool3d_2a", pair_engine.model, batch, AttackConfig(), FlickerSpec(T),
         flags, 0, PAIR_TRAIN_COUNTS),
        (f"B={B} USE_PALLAS_FUSED", model, batch, AttackConfig(use_pallas_fused=True),
         FlickerSpec(T), flags, 0, FUSED_TRAIN_COUNTS),
        (f"B=1 T={SV_FRAMES} float32 clip", model, sv_batch, AttackConfig(),
         FlickerSpec(SV_FRAMES), flags, 0, SV_STEP_COUNTS),
        (f"B={B} odd geometry {ODD_FRAMES}x{ODD_SIZE}x{ODD_SIZE} uint8", model, odd_batch,
         AttackConfig(), FlickerSpec(ODD_FRAMES), flags, 0, ODD_TRAIN_COUNTS),
        (f"B={B} sparse (L1,2, delta [{T},{SIZE},{SIZE},3])", model, batch,
         AttackConfig(attack_kind="sparse"), SparseSpec(T, SIZE, SIZE), flags, 0,
         SPARSE_TRAIN_COUNTS),
        (f"B=1 T={SV_FRAMES} float32 clip, cyclic (both flags, seed {CYCLIC_SEED})", model,
         sv_batch, AttackConfig(enable_cyclic=True), FlickerSpec(SV_FRAMES), cyclic_flags,
         CYCLIC_SEED, SV_STEP_COUNTS),
    ):
        t0 = time.perf_counter()
        eager = three_steps(model_, batch_, cfg, spec, False, flags_, seed)
        graphed, got, got_dev = traced(
            lambda: three_steps(model_, batch_, cfg, spec, True, flags_, seed))
        graph_device[tag] = got_dev
        ok = len(graphed) == len(eager) and all(map(bit_equal, graphed, eager))
        counted = (got == scaled(step_counts, 3)
                   and got_dev == scaled(step_counts, WARMUP_STEPS + 3))
        print(f"[graph] {tag}: 3 graphed steps against 3 eager steps (delta, mu, nu, step and "
              f"{len(graphed) - 4} metrics): {'bit-equal' if ok else 'DIFFER'}; graphed launches "
              f"{got}, on the device (the capture's {WARMUP_STEPS} warm-up steps and 3 replays) "
              f"{got_dev}: {'exact' if counted else 'NOT the per-step counts'}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            fail(f"the graphed step differs from the eager step ({tag})")
        if not counted:
            fail(f"the graphed step's launch counts differ from the per-step counts ({tag})")
        del eager, graphed
        torch.cuda.empty_cache()

    # the cyclic engine: train_steps(3) (3 replays of one graph, no host
    # between) against 3 train_step calls, bit for bit, each step's shifts
    # drawn from (seed, its step count); a seed of its own rolls otherwise
    from flickering_adversarial_video_tpu_torch.attack.perturbation import roll_shifts

    def cyclic_run(n_calls, seed):
        e = AttackEngine(model, FlickerSpec(SV_FRAMES), AttackConfig(enable_cyclic=True),
                         track_probs=False)
        if n_calls == 1:
            s = e.train_steps(e.init_state(), sv_batch, cyclic_flags, 3, seed=seed)
        else:
            s = e.init_state()
            for _ in range(3):
                s, _ = e.train_step(s, sv_batch, cyclic_flags, seed)
        torch.cuda.synchronize()
        return s.delta.clone(), s.mu.clone(), s.nu.clone()

    chained, stepped = cyclic_run(1, CYCLIC_SEED), cyclic_run(3, CYCLIC_SEED)
    other = cyclic_run(1, CYCLIC_SEED + 1)
    shifts = [tuple(int(v) for v in roll_shifts(torch.tensor(CYCLIC_SEED, device=dev),
                                                 torch.tensor(c, device=dev), SV_FRAMES,
                                                 SV_FRAMES)) for c in (1, 2, 3)]
    ok = all(map(bit_equal, chained, stepped))
    print(f"[graph] cyclic, seed {CYCLIC_SEED}: train_steps(3) against 3 train_step calls "
          f"(delta, mu, nu): {'bit-equal' if ok else 'DIFFER'}; the steps' (input, delta) shifts "
          f"{shifts}; seed {CYCLIC_SEED + 1} gives another delta: "
          f"{not torch.equal(other[0], chained[0])}", flush=True)
    if not ok or torch.equal(other[0], chained[0]) or len(set(shifts)) == 1:
        fail("the cyclic engine's chained steps differ from its single steps, or the rolls "
             "do not depend on the seed and the step")
    del chained, stepped, other

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
    # the step graphed (one train_steps call a step: pack, copy into the
    # graph's clip, replay; and n = 10 replays a call, the lax.scan
    # counterpart) and eager, in turns
    torch.cuda.reset_peak_memory_stats()
    eager_ms = [cuda_ms(torch, lambda: eager_step(engine, state, batch), iters=5, warmup=1)]
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    graph_ms = [cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1), iters=5,
                        warmup=1)]
    eager_ms.append(cuda_ms(torch, lambda: eager_step(engine, state, batch), iters=5, warmup=1))
    graph_ms.append(cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 1), iters=5,
                            warmup=1))
    chained_ms = cuda_ms(torch, lambda: engine.train_steps(state, batch, flags, 10), iters=2,
                         warmup=1) / 10
    step_ms, eager_step_ms = min(graph_ms), min(eager_ms)
    print(f"[time] train step at B={B} T={T} {SIZE}x{SIZE} bf16: eager {eager_ms[0]:.2f}, "
          f"{eager_ms[1]:.2f} ms; graphed {graph_ms[0]:.2f}, {graph_ms[1]:.2f} ms "
          f"({1000 / step_ms:.3f} steps/s); graphed, 10 replays a call, {chained_ms:.2f} ms a step; "
          f"eager peak memory {eager_peak:.2f} GB; {graph_stats(engine)}", flush=True)
    # the same at B=1, T=90 on a float32 clip (the single-video path)
    b1_engine = AttackEngine(model, FlickerSpec(frames=SV_FRAMES), track_probs=False)
    b1_state = b1_engine.init_state()

    def sv_step(n=1):
        return lambda: b1_engine.train_steps(b1_state, sv_batch, flags, n)

    def sv_eager():
        return eager_step(b1_engine, b1_state, sv_batch)

    torch.cuda.reset_peak_memory_stats()
    sv_eager_ms = [cuda_ms(torch, sv_eager, iters=10, warmup=2)]
    sv_peak = torch.cuda.max_memory_allocated() / 1e9
    sv_graph_ms = [cuda_ms(torch, sv_step(), iters=10, warmup=2)]
    sv_eager_ms.append(cuda_ms(torch, sv_eager, iters=10, warmup=2))
    sv_graph_ms.append(cuda_ms(torch, sv_step(), iters=10, warmup=2))
    sv_chained = cuda_ms(torch, sv_step(10), iters=2, warmup=1) / 10
    sv_ms, sv_eager_min = min(sv_graph_ms), min(sv_eager_ms)
    print(f"[time] train step at B=1 T={SV_FRAMES} {SIZE}x{SIZE} bf16, float32 clip (the "
          f"single-video path): eager {sv_eager_ms[0]:.2f}, {sv_eager_ms[1]:.2f} ms; graphed "
          f"{sv_graph_ms[0]:.2f}, {sv_graph_ms[1]:.2f} ms ({1000 / sv_ms:.3f} steps/s); "
          f"graphed, 10 replays a call, {sv_chained:.2f} ms a step; eager peak memory "
          f"{sv_peak:.2f} GB; {graph_stats(b1_engine)}", flush=True)
    fused_engine = AttackEngine(model, FlickerSpec(frames=T), AttackConfig(use_pallas_fused=True),
                                track_probs=False)
    torch.cuda.reset_peak_memory_stats()
    fused_ms = cuda_ms(torch, lambda: fused_engine.train_steps(state, batch, flags, 1),
                       iters=5, warmup=1)
    print(f"[time] train step (USE_PALLAS_FUSED) {fused_ms:.2f} ms ({1000 / fused_ms:.3f} steps/s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    for tag, eng in (("pair at MaxPool3d_2a", pair_engine),
                     ("pair at MaxPool3d_2a and 3a",
                      with_pair(("MaxPool3d_2a_3x3", "MaxPool3d_3a_3x3")))):
        torch.cuda.reset_peak_memory_stats()
        pair_ms = cuda_ms(torch, lambda: eng.train_steps(state, batch, flags, 1), iters=5, warmup=1)
        print(f"[time] train step ({tag}) {pair_ms:.2f} ms ({1000 / pair_ms:.3f} steps/s), peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; default "
              f"{step_ms:.2f} ms in this run", flush=True)
    del pair_engine, eng

    # the odd geometry, the sparse attack and the cyclic rolls: the step
    # graphed (one train_steps call a step) and eager, in turns
    new_step_ms, new_paths = {}, []
    for tag, eng_, batch_, flags_, seed in (
        (f"odd geometry B={B} {ODD_FRAMES}x{ODD_SIZE}x{ODD_SIZE} uint8",
         AttackEngine(model, FlickerSpec(ODD_FRAMES), track_probs=False), odd_batch, flags, 0),
        (f"sparse (L1,2) B={B} T={T} {SIZE}x{SIZE} uint8",
         AttackEngine(model, SparseSpec(T, SIZE, SIZE), AttackConfig(attack_kind="sparse"),
                      track_probs=False), batch, flags, 0),
        (f"cyclic B=1 T={SV_FRAMES} float32 clip",
         AttackEngine(model, FlickerSpec(SV_FRAMES), AttackConfig(enable_cyclic=True),
                      track_probs=False), sv_batch, cyclic_flags, CYCLIC_SEED),
    ):
        st = eng_.init_state()
        torch.cuda.reset_peak_memory_stats()
        e_ms = [cuda_ms(torch, lambda: eager_step(eng_, st, batch_, flags_, seed), iters=5,
                        warmup=1)]
        e_peak = torch.cuda.max_memory_allocated() / 1e9
        g_ms = [cuda_ms(torch, lambda: eng_.train_steps(st, batch_, flags_, 1, seed=seed), iters=5,
                        warmup=1)]
        e_ms.append(cuda_ms(torch, lambda: eager_step(eng_, st, batch_, flags_, seed), iters=5,
                            warmup=1))
        g_ms.append(cuda_ms(torch, lambda: eng_.train_steps(st, batch_, flags_, 1, seed=seed),
                            iters=5, warmup=1))
        print(f"[time] train step, {tag}: eager {e_ms[0]:.2f}, {e_ms[1]:.2f} ms; graphed "
              f"{g_ms[0]:.2f}, {g_ms[1]:.2f} ms ({1000 / min(g_ms):.3f} steps/s); eager peak "
              f"memory {e_peak:.2f} GB; {graph_stats(eng_)}", flush=True)
        new_step_ms[tag.split()[0]] = min(g_ms)
        new_paths.append((tag, eng_, st, batch_, flags_, seed))

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
        # B9 forward: x read, y and one index byte an output written; 8 max and
        # 9 compares an output.  Backward: dy and the index read, dx written
        "B9f": (nb["B5"] * isz + nb["B5"] // 4 * (isz + 1), 17 * nb["B5"] // 4, PEAK_F32_FLOPS),
        "B9b": (nb["B5"] // 4 * (isz + 1) + nb["B5"] * isz, 18 * nb["B5"] // 4, PEAK_F32_FLOPS),
    }
    x1p = F.pad(x1.permute(0, 4, 1, 2, 3), (1, 2) * 3)
    w1 = stem_conv.pk_to_oidhw(pk).contiguous(memory_format=torch.channels_last_3d)
    xpp = F.pad(xp.permute(0, 4, 1, 2, 3), (1, 1) * 3, value=float("-inf"))
    x5p = F.pad(x5.permute(0, 4, 1, 2, 3), (0, 1, 0, 1), value=float("-inf"))
    # B4's yardstick: ATen's max-pool backward on the same dy in
    # channels_last_3d, which needs the forward's int64 indices (taken here
    # from F.max_pool3d on the same x) and follows another NaN rule
    xp_cl = xp.permute(0, 4, 1, 2, 3)
    idx4 = F.max_pool3d(xp_cl, 3, 1, 1, return_indices=True)[1]
    dy_cl = inputs["dy"].permute(0, 4, 1, 2, 3)
    # B6's: the same call on x padded by one -inf row and column (the (0,1)
    # pads), fed the int64 indices of F.max_pool3d on that padded x; it writes
    # a padded dx and routes a NaN window by another rule
    x5p_cl = x5p.contiguous(memory_format=torch.channels_last_3d)
    idx6 = F.max_pool3d(x5p_cl, (1, 3, 3), (1, 2, 2), return_indices=True)[1]
    dy5_cl = inputs["dy5"].permute(0, 4, 1, 2, 3)
    library = {
        "B1": lambda: F.conv3d(x1p, w1),
        "B3": lambda: F.max_pool3d(xpp, 3, 1),
        "B4": lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            dy_cl, xp_cl, [3, 3, 3], [1, 1, 1], [1, 1, 1], [1, 1, 1], False, idx4),
        "B5": lambda: F.max_pool3d(x5p, (1, 3, 3), (1, 2, 2)),
        "B6": lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            dy5_cl, x5p_cl, [1, 3, 3], [1, 2, 2], [0, 0, 0], [1, 1, 1], False, idx6),
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
        "B9f": "flickering_adversarial_video_tpu/ops/pallas_pool.py:397",
        "B9b": "flickering_adversarial_video_tpu/ops/pallas_pool.py:429",
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
        "B9f": "flickering_adversarial_video_tpu_torch/csrc/pool_pair.cu",
        "B9b": "flickering_adversarial_video_tpu_torch/csrc/pool_pair.cu",
    }
    # launches: on the device, by torch.profiler, in phase 3's run of the
    # kernel's path (B8: USE_PALLAS_FUSED, B9: the pair; graphed, from a new
    # engine: the capture's warm-up steps and the replays)
    path_launches = {**main_device,
                     **{k: graph_device[f"B={B} USE_PALLAS_FUSED"][k] for k in ("B8f", "B8b")},
                     **{k: graph_device[f"B={B} pair at MaxPool3d_2a"][k] for k in ("B9f", "B9b")}}
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
            "replaces": replaces[name], "launches": path_launches[name],
            "max_abs_err": checks[(name, torch.bfloat16)][0],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        })
        print(f"[time] {full_name}: {ms:.3f} ms (bound {bound_ms:.3f} ms, "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}; {bound_ms / ms:.1%} of it), "
              f"plain {plain_ms:.3f} ms, library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}", flush=True)

    # B3 and B4 at the nine branch-pool shapes of the step: one B=8 step's time
    for kernel, n_bytes in (("B3", 2), ("B4", 3)):
        sum4, bound4 = 0.0, 0.0
        for block, shape4 in POOL_STEP.items():
            x4 = drandn(*shape4, dtype=torch.bfloat16)
            dy4 = drandn(*shape4, dtype=torch.bfloat16)
            ms4 = cuda_ms(torch, (lambda: pool_s1.pool333_fwd(x4)) if kernel == "B3" else
                          (lambda: pool_s1.pool333_bwd(x4, dy4)))
            b4 = n_bytes * x4.numel() * isz / PEAK_BYTES * 1e3
            sum4, bound4 = sum4 + ms4, bound4 + b4
            print(f"[time] {kernel} {block} {list(shape4)}: {ms4:.4f} ms (bound {b4:.4f} ms, "
                  f"bytes; {b4 / ms4:.1%} of it)", flush=True)
            del x4, dy4
        print(f"[time] {kernel} a B=8 step (the nine branch pools, one launch each): {sum4:.4f} "
              f"ms (bound {bound4:.4f} ms, bytes; {bound4 / sum4:.1%} of it)", flush=True)

    # B2 at its 19 launches of the step: one B=8 step's time
    sum2, bound2 = 0.0, 0.0
    for block, dims, cin in COMBINE_STEP:
        part2 = drandn(*dims, 3 * cin, dtype=torch.bfloat16)
        ms2 = cuda_ms(torch, lambda: stem_combine.temporal_combine(part2, cin, 1))
        b2 = part2.numel() * 4 // 3 * isz / PEAK_BYTES * 1e3
        sum2, bound2 = sum2 + ms2, bound2 + b2
        print(f"[time] B2 {block} {list(part2.shape)}: {ms2:.4f} ms (bound {b2:.4f} ms, bytes; "
              f"{b2 / ms2:.1%} of it)", flush=True)
        del part2
    print(f"[time] B2 a B=8 step (the {len(COMBINE_STEP)} combines, one launch each): "
          f"{sum2:.4f} ms (bound {bound2:.4f} ms, bytes; {bound2 / sum2:.1%} of it)", flush=True)
    lib4 = next(row["library_ms"] for row in table if row["name"].split()[0] == "B4")
    print(f"[time] B4's library yardstick at {list(shapes['B4'])}: "
          f"aten.max_pool3d_with_indices_backward in channels_last_3d {lib4:.4f} "
          f"ms; it needs the forward's int64 indices (a read of 8 bytes an output) and routes "
          f"by another NaN rule", flush=True)

    # B5 and B6 at the three strided pools of the step: one B=8 step's time
    sum5, bound5, sum6, bound6 = 0.0, 0.0, 0.0, 0.0
    for block in ("2a", "3a", "4a spatial"):
        shape6 = b6_shapes[block]
        x6 = drandn(*shape6, dtype=torch.bfloat16)
        dy6 = drandn(*shape6[:2], shape6[2] // 2, shape6[3] // 2, shape6[4], dtype=torch.bfloat16)
        ms5 = cuda_ms(torch, lambda: pool_strided.pool133_s2_fwd(x6))
        b5 = (x6.numel() + dy6.numel()) * isz / PEAK_BYTES * 1e3
        sum5, bound5 = sum5 + ms5, bound5 + b5
        ms6 = cuda_ms(torch, lambda: pool_strided.pool133_s2_bwd(x6, dy6))
        b6 = (2 * x6.numel() + dy6.numel()) * isz / PEAK_BYTES * 1e3
        sum6, bound6 = sum6 + ms6, bound6 + b6
        print(f"[time] B5 MaxPool3d_{block} {list(shape6)}: {ms5:.4f} ms (bound {b5:.4f} ms, "
              f"bytes; {b5 / ms5:.1%} of it); B6 {ms6:.4f} ms (bound {b6:.4f} ms, "
              f"bytes; {b6 / ms6:.1%} of it)", flush=True)
        del x6, dy6
    print(f"[time] B5 a B=8 step (the three strided pools, one launch each): {sum5:.4f} ms "
          f"(bound {bound5:.4f} ms, bytes; {bound5 / sum5:.1%} of it)", flush=True)
    lib6 = next(row["library_ms"] for row in table if row["name"].split()[0] == "B6")
    print(f"[time] B6 a B=8 step (the three strided pools, one launch each): {sum6:.4f} ms "
          f"(bound {bound6:.4f} ms, bytes; {bound6 / sum6:.1%} of it); its library yardstick at "
          f"{list(shapes['B6'])}: aten.max_pool3d_with_indices_backward in channels_last_3d on x "
          f"padded by one -inf row and column {lib6:.4f} ms (needs F.max_pool3d's int64 indices, "
          f"writes the padded dx, another NaN rule)", flush=True)

    # B1 at the single-video path's shape, beside F.conv3d and its bound
    x1s = (drandint(0, 256, (1, SV_FRAMES // 2, th, tw, 24), torch.float32) / 128 - 1).to(
        torch.bfloat16)
    macs_s = 24 * 64 * n_in_range(SV_FRAMES // 2, 1, 4) * n_in_range(th, 1, 4) * n_in_range(tw, 1, 4)
    bytes_s = x1s.numel() * isz + pk.numel() * isz + x1s.numel() // 24 * 64 * isz + 3 * 64 * 4
    bound_s = max(2 * macs_s / PEAK_BF16_FLOPS, bytes_s / PEAK_BYTES) * 1e3
    ms1s = cuda_ms(torch, lambda: stem_conv.stem_conv_bn_relu(x1s, pk, *bn))
    x1sp = F.pad(x1s.permute(0, 4, 1, 2, 3), (1, 2) * 3)
    lib1s = cuda_ms(torch, lambda: F.conv3d(x1sp, w1))
    print(f"[time] B1 at the single-video clip's {list(x1s.shape)}: {ms1s:.3f} ms (bound "
          f"{bound_s:.3f} ms, operations; {bound_s / ms1s:.1%} of it), F.conv3d {lib1s:.3f} ms",
          flush=True)
    del x1s, x1sp

    # B1 at the wide clip's shape (2 column segments, 2 launches), and B5 and
    # B6 at the new geometries' strided pools, each beside its bound
    pkw, bnw = inputs["b1_wide"]
    xws = (drandint(0, 256, b1_wide, torch.float32) / 128 - 1).to(torch.bfloat16)
    macs_w = 24 * 64 * n_in_range(b1_wide[1], 1, 4) * n_in_range(b1_wide[2], 1, 4) * n_in_range(
        b1_wide[3], 1, 4)
    bytes_w = xws.numel() * isz + pkw.numel() * isz + xws.numel() // 24 * 64 * isz + 3 * 64 * 4
    bound_w = max(2 * macs_w / PEAK_BF16_FLOPS, bytes_w / PEAK_BYTES) * 1e3
    ms1w = cuda_ms(torch, lambda: stem_conv.stem_conv_bn_relu(xws, pkw, *bnw))
    plain1w = cuda_ms(torch, lambda: stem_conv.stem_conv_bn_relu_plain(xws, pkw, *bnw), iters=3,
                      warmup=1)
    x1wp = F.pad(xws.permute(0, 4, 1, 2, 3), (1, 2) * 3)
    w1w = stem_conv.pk_to_oidhw(pkw).contiguous(memory_format=torch.channels_last_3d)
    lib1w = cuda_ms(torch, lambda: F.conv3d(x1wp, w1w))
    print(f"[time] B1 at the wide clip's {list(b1_wide)} in "
          f"{len(stem_conv.stem_segments(b1_wide[3]))} column segments: {ms1w:.3f} ms (bound "
          f"{bound_w:.3f} ms, operations; {bound_w / ms1w:.1%} of it), plain {plain1w:.3f} ms, "
          f"F.conv3d {lib1w:.3f} ms", flush=True)
    del xws, x1wp
    for block in ("2a odd", *wide_pools):
        shape6 = b6_shapes[block]
        x6 = drandn(*shape6, dtype=torch.bfloat16)
        dy6 = drandn(*shape6[:2], shape6[2] // 2, shape6[3] // 2, shape6[4], dtype=torch.bfloat16)
        ms5 = cuda_ms(torch, lambda: pool_strided.pool133_s2_fwd(x6))
        b5 = (x6.numel() + dy6.numel()) * isz / PEAK_BYTES * 1e3
        ms6 = cuda_ms(torch, lambda: pool_strided.pool133_s2_bwd(x6, dy6))
        b6 = (2 * x6.numel() + dy6.numel()) * isz / PEAK_BYTES * 1e3
        lib5 = cuda_ms(torch, lambda: F.max_pool3d(
            F.pad(x6.permute(0, 4, 1, 2, 3), (0, 1, 0, 1), value=float("-inf")), (1, 3, 3),
            (1, 2, 2)))
        print(f"[time] B5 MaxPool3d_{block} {list(shape6)}: {ms5:.4f} ms (bound {b5:.4f} ms, "
              f"bytes; {b5 / ms5:.1%} of it; F.max_pool3d on the padded x, the pad included, "
              f"{lib5:.4f} ms); B6 {ms6:.4f} ms (bound {b6:.4f} ms, bytes; {b6 / ms6:.1%} of it)",
              flush=True)
        del x6, dy6

    kern, plain = inputs["b2_stem"]
    n4 = B * (T // 2) * th * tw * 24
    print(f"[time] B2 at the stem's dgrad [{B},{T // 2},{th},{tw},96] (USE_PALLAS_FUSED): "
          f"{cuda_ms(torch, kern):.3f} ms (bound {5 * n4 * isz / PEAK_BYTES * 1e3:.3f} ms, bytes), "
          f"plain {cuda_ms(torch, plain, iters=3, warmup=1):.3f} ms", flush=True)
    part4s = drandn(1, SV_FRAMES // 2, th, tw, 4 * 24, dtype=torch.bfloat16)
    n4s = part4s.numel() // 4
    ms4s = cuda_ms(torch, lambda: stem_combine.temporal_combine(part4s, 24, 1))
    plain4s = cuda_ms(torch, lambda: stem_combine.temporal_combine_plain(part4s, 24, 1),
                      iters=3, warmup=1)
    print(f"[time] B2 at the stem's dgrad {list(part4s.shape)} (the single-video clip): "
          f"{ms4s:.3f} ms (bound {5 * n4s * isz / PEAK_BYTES * 1e3:.3f} ms, bytes), "
          f"plain {plain4s:.3f} ms", flush=True)
    del part4s

    # ---- 6. where the step's device time goes ---------------------------------
    symbols = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]

    def breakdown(tag, step_fn, untraced_ms, top=12):
        """PROFILE_STEPS calls of `step_fn` under torch.profiler: the device's
        busy share of the traced wall, kernel time by group, the slowest
        kernels, and the kernels' sum against the untraced step time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms = cuda_ms(torch, step_fn, iters=PROFILE_STEPS, warmup=0)
        rows = kernel_rows(prof, PROFILE_STEPS)
        busy = sum(r[0] for r in rows)
        if not busy > 0:
            print(f"[profile] {tag}: torch.profiler saw no device time: breakdown not measured")
            return None
        groups = defaultdict(float)
        for ms, _, name in rows:
            if any(sym in name for sym in symbols):
                groups["the port's kernels B1-B9"] += ms
            elif any(mark in name.lower() for mark in CONV_MARKS):
                groups["convolution / matmul (cuDNN, cuBLAS)"] += ms
            else:
                groups["other (elementwise, reductions, copies)"] += ms
        print(f"[profile] {tag}, {PROFILE_STEPS} train steps: wall {wall_ms:.2f} ms/step; kernels "
              f"{busy:.2f} ms/step in {sum(r[1] for r in rows):.0f} launches/step; device busy "
              f"{busy / wall_ms:.1%}, idle {1 - busy / wall_ms:.1%}; untraced the step takes "
              f"{untraced_ms:.2f} ms, so the kernels fill {busy / untraced_ms:.1%} of it")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[profile]   {g:42s} {ms:9.2f} ms/step  {ms / busy:6.1%}")
        ours = groups["the port's kernels B1-B9"]
        for launcher, syms in kernels.KERNEL_SYMBOLS.items():
            ms = sum(r[0] for r in rows if any(sym in r[2] for sym in syms))
            n = sum(r[1] for r in rows if any(sym in r[2] for sym in syms))
            if n:
                print(f"[profile]   port kernel {launcher:24s} {ms:8.3f} ms/step {n:5.1f} launches/step"
                      f"  {ms / max(ours, 1e-12):6.1%} of the port's, {ms / busy:6.1%} of all")
        for ms, n, name in sorted(rows, reverse=True)[:top]:
            print(f"[profile]   slowest: {ms:8.3f} ms/step {n:5.1f} launches/step  {name[:90]}")
        return busy

    busy_graphed = breakdown(f"B={B} T={T}, graphed",
                             lambda: engine.train_steps(state, batch, flags, 1), step_ms)
    busy_eager = breakdown(f"B={B} T={T}, eager", lambda: eager_step(engine, state, batch),
                           eager_step_ms)
    if busy_graphed and busy_eager:
        print(f"[profile] kernel time a B={B} step: graphed {busy_graphed:.2f} ms, eager "
              f"{busy_eager:.2f} ms ({busy_graphed / busy_eager - 1:+.1%})", flush=True)
    packed, is_packed, _ = engine.prepare_batch(batch)
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: engine._logits(state.delta, packed, is_packed,
                                                        engine._step_scalars(flags),
                                                        engine._eval_counter),
                         iters=5, warmup=1)
    print(f"[profile] forward alone (no grad, eager) {fwd_ms:.2f} ms; backward + Adam + metrics "
          f"{eager_step_ms - fwd_ms:.2f} ms of the {eager_step_ms:.2f} ms eager step", flush=True)
    sv_busy = breakdown(f"single-video B=1 T={SV_FRAMES}, graphed", sv_step(), sv_ms, top=8)
    sv_busy_eager = breakdown(f"single-video B=1 T={SV_FRAMES}, eager", sv_eager, sv_eager_min,
                              top=8)
    if sv_busy and sv_busy_eager:
        print(f"[profile] kernel time a B=1 T={SV_FRAMES} step: graphed {sv_busy:.2f} ms, "
              f"eager {sv_busy_eager:.2f} ms ({sv_busy / sv_busy_eager - 1:+.1%})", flush=True)
    # the odd geometry, the sparse attack and the cyclic rolls, graphed
    for tag, eng_, st, batch_, flags_, seed in new_paths:
        breakdown(f"{tag}, graphed",
                  lambda: eng_.train_steps(st, batch_, flags_, 1, seed=seed),
                  new_step_ms[tag.split()[0]], top=8)
    del new_paths, eng_, st
    torch.cuda.empty_cache()


    # ---- 7. the universal runner, default configuration ---------------------------
    del inputs, engine, fused_engine, packed, b1_engine, b1_state, sv_batch, odd_batch
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

        # the input pipeline alone: the native reader (the runners' default)
        # against the Python reader, every batch, packed and unpacked, on the
        # host and as the engine receives it: pinned buffers filled in place
        # and copied without blocking on the producer thread, each copy queued
        # behind a busy stream while the reader fills the next buffers
        shards = list_shards(shard_dir)
        for prepack in (True, False):
            key = "video_packed" if prepack else "video"
            kw = dict(frames=T, prepack=prepack)
            want = list(tfrecord_batches(shards, B, use_native=False, **kw))
            host = list(tfrecord_batches(shards, B, **kw))
            produce = (loops._to_device(b, dev) for b in tfrecord_batches(
                shards, B, repeat=PIPE_REPEAT, pin_memory=True, **kw))
            got = []
            for batch in PrefetchIterator(produce, depth=2):
                torch.cuda._sleep(100_000_000)  # ~60 ms: longer than a batch's read
                got.append(batch)
            torch.cuda.synchronize()
            if len(want) != SHARDS or len(host) != SHARDS or len(got) != SHARDS * PIPE_REPEAT:
                fail(f"pipeline ({key}): {len(host)} native and {len(got)} pinned batches, "
                     f"{len(want)} from the Python reader")
            same_host = all(np.array_equal(h[key], w[key]) and np.array_equal(h["labels"], w["labels"])
                            for h, w in zip(host, want))
            same_dev = all(np.array_equal(g[key].cpu().numpy(), want[i % SHARDS][key])
                           and np.array_equal(g["labels"].cpu().numpy(), want[i % SHARDS]["labels"])
                           for i, g in enumerate(got))
            print(f"[input] {key}: native batches bit-equal to the Python reader's on the host: "
                  f"{same_host}; {len(got)} pinned batches on the card bit-equal: {same_dev}",
                  flush=True)
            if not (same_host and same_dev):
                fail(f"pipeline ({key}): the native batches differ from the Python reader's")
            del got
        torch.cuda.empty_cache()

        def read_rate(**kw):
            """(best, median) MB/s of parsed batches over 5 passes of the shards."""
            rates = []
            for _ in range(5):
                t0 = time.perf_counter()
                n = sum(np.asarray(b["video_packed" if kw.get("prepack") else "video"]).nbytes
                        for b in tfrecord_batches(shards, B, frames=T, **kw))
                rates.append(n / (time.perf_counter() - t0) / 1e6)
            return max(rates), sorted(rates)[2]

        for tag, kw in (("native, packed, pinned", dict(prepack=True, pin_memory=True)),
                        ("native, packed", dict(prepack=True)),
                        ("Python, packed", dict(prepack=True, use_native=False)),
                        ("native, unpacked", dict(prepack=False)),
                        ("Python, unpacked", dict(prepack=False, use_native=False))):
            best, median = read_rate(**kw)
            print(f"[input] {tag}: {best:.0f} MB/s of parsed batches (best of 5 passes over "
                  f"{SHARDS} batches of {B}; median {median:.0f}), on the host's one producer "
                  f"thread", flush=True)

        def run_runner(tag, out_dir, max_steps, train_counts, eval_counts, step_alone_ms,
                       profiled=False):
            """universal.run with the counts reset just before and read just
            after; checks steps, finite losses, the final eval's count, the
            files on disk and the exact launch counts (traced: also those that
            ran on the device, the one capture's warm-up steps among them)."""
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
            if prof is not None:
                got_dev = device_launches(prof, kernels)
                want_dev = scaled(train_counts, WARMUP_STEPS, want)
                print(f"[runner] {tag}: launches on the device by torch.profiler {got_dev} "
                      f"(expected {want_dev})", flush=True)
                if got_dev != want_dev:
                    fail(f"runner {tag}: the device's launch counts differ from the per-step counts")
            rate, rate_after = out["steps_per_sec"], out["steps_per_sec_after_first"]
            print(f"[time] runner {tag}: {rate:.3f} steps/s by the loop's timer "
                  f"({1000 / max(rate, 1e-9):.1f} ms/step), {rate_after:.3f} after the first step "
                  f"({1000 / max(rate_after, 1e-9):.1f} ms/step; on CUDA the first step of a batch "
                  f"shape captures its graph); the step alone takes {step_alone_ms:.1f} ms",
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
            return out, said, wall, prof

        out, said, _, _ = run_runner(
            "default", "default", RUNNER_STEPS, TRAIN_COUNTS, EVAL_COUNTS, step_ms)
        if "Begin new training" not in said or "host-prepacked" not in said:
            fail("runner default: not a fresh start on the host-prepacked pipeline")
        if out["final_eval"]["total_valid_videos"] != SHARDS * PER_SHARD:
            fail(f"runner default: {out['final_eval']['total_valid_videos']} valid videos, "
                 f"expected {SHARDS * PER_SHARD}")
        default_loss = out["history"]["total_loss"][0]
        default_hist = out["history"]
        rate_default = out["steps_per_sec_after_first"]
        delta12 = out["state"].delta.clone()

        out, said, _, _ = run_runner("resumed", "default", RESUME_STEPS, TRAIN_COUNTS,
                                     EVAL_COUNTS, step_ms)
        if f"Continue training from step {RUNNER_STEPS}" not in said:
            fail("runner resumed: the resume line is missing")
        if out["history"]["fool_rate_steps"][0] != RUNNER_STEPS:
            fail("runner resumed: did not start at the checkpoint's step")
        if torch.equal(out["state"].delta, delta12):
            fail("runner resumed: delta did not move after the resume")

        # the same 12 steps with the train step eager on the card: the step
        # graph's effect on the runner, on this machine
        with mock.patch.object(attack_step, "StepGraphs", lambda *args: None):
            run_runner("default, eager step (control)", "eager", RUNNER_STEPS, TRAIN_COUNTS,
                       EVAL_COUNTS, eager_step_ms)

        def traced_share(tag, out_dir):
            """The 12 steps under torch.profiler, which slows the host: the
            steps/s are the untraced run's, the busy shares this one's.
            Returns the steps' busy share (None if not measured) and the run."""
            out, _, wall, prof = run_runner(
                f"{tag}, traced", out_dir, RUNNER_STEPS, TRAIN_COUNTS, EVAL_COUNTS, step_ms,
                profiled=True)
            spans = (loops.STEP_SPAN, loops.EVAL_SPAN)
            busy_ms = sum(r[0] for r in kernel_rows(prof, spans=spans))
            share = loop_share(prof, loops.EVAL_SPAN, spans)
            if not (busy_ms > 0 and share is not None):
                print(f"[profile] runner {tag}: torch.profiler gave no device time, eval spans or "
                      "launch records: busy share not measured")
                return None, out
            print(f"[profile] runner {tag}, whole run (initial eval, {RUNNER_STEPS} steps, "
                  f"{len(out['history']['fool_rate_steps']) - 1} more evals, host pipeline): "
                  f"kernels and copies {busy_ms / 1e3:.2f} s of {wall:.2f} s wall; device busy "
                  f"{busy_ms / 1e3 / wall:.1%}, idle {1 - busy_ms / 1e3 / wall:.1%}")
            k_ms, w_ms, unmatched = share
            print(f"[profile] runner {tag}, the {RUNNER_STEPS} steps alone (traced in the "
                  f"loop, its evals taken out): kernels {k_ms / RUNNER_STEPS:.2f} ms a step in "
                  f"{w_ms / RUNNER_STEPS:.1f} ms a step of wall; device busy {k_ms / w_ms:.1%}, "
                  f"idle {1 - k_ms / w_ms:.1%} ({unmatched} kernels without a launch record "
                  f"left out)", flush=True)
            return k_ms / w_ms, out

        # the native reader against the Python reader on this machine, in
        # turns: native (the run above), Python, native; each untraced for
        # its rate, then traced for its busy share
        turns = [("native", rate_default, *traced_share("default", "traced"))]
        python_reader = (lambda *a, **kw: tfrecord_batches(*a, use_native=False, **kw))
        with mock.patch.object(universal, "tfrecord_batches", python_reader):
            out, _, _, _ = run_runner("Python reader (control)", "python", RUNNER_STEPS,
                                      TRAIN_COUNTS, EVAL_COUNTS, step_ms)
            turns.append(("Python reader", out["steps_per_sec_after_first"],
                          *traced_share("Python reader (control)", "python_traced")))
        for k in ("total_loss", "fool_rate"):
            if out["history"][k] != default_hist[k]:
                fail(f"runner: the Python reader's {k} {out['history'][k]} differs from the native "
                     f"reader's {default_hist[k]}")
        unpinned = (lambda *a, **kw: tfrecord_batches(*a, **{**kw, "pin_memory": False}))
        with mock.patch.object(universal, "tfrecord_batches", unpinned):
            out, _, _, _ = run_runner("native, unpinned batches", "unpinned", RUNNER_STEPS,
                                      TRAIN_COUNTS, EVAL_COUNTS, step_ms)
        turns.append(("native, unpinned batches", out["steps_per_sec_after_first"], None, None))
        out, _, _, _ = run_runner("native, second turn", "native2", RUNNER_STEPS, TRAIN_COUNTS,
                                  EVAL_COUNTS, step_ms)
        turns.append(("native, second turn", out["steps_per_sec_after_first"],
                      *traced_share("native, second turn", "native2_traced")))
        print("[time] runner readers in turns on this machine (steps/s after the first step; "
              "busy share of the steps alone): " + "; ".join(
                  f"{tag} {rate:.3f}" + (f" ({share:.1%})" if share is not None else "")
                  for tag, rate, share, _ in turns), flush=True)

        # ---- 8. the runner with USE_PALLAS_FUSED: True -------------------------------
        ac.USE_PALLAS_FUSED = True
        ac.MAX_NUM_STEP = FUSED_STEPS
        out, said, _, _ = run_runner(
            "USE_PALLAS_FUSED", "fused", FUSED_STEPS, FUSED_TRAIN_COUNTS, FUSED_EVAL_COUNTS,
            fused_ms)
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
        del grads
        torch.cuda.empty_cache()

        # ---- 9. the single-video runner at full width ---------------------------------
        sv = cfg.SINGLE_VIDEO_ATTACK
        # a pkl is named by class, thickness and roughness alone (the
        # reference's convention), and on random weights every clip gets one
        # class and numbers that agree to the 0.01% printed: the two kept
        # clips lie in a directory each, so that neither pkl overwrites the other
        npy_dirs = [os.path.join(tmp, "npy", d) for d in ("a", "b")]
        for d in npy_dirs:
            os.makedirs(d)
        sv.MAX_NUM_STEP = SV_MAX_NUM_STEP
        if sv.COMPUTE_DTYPE != "bfloat16" or sv.TARGETED_ATTACK or sv.SLOTS != 1:
            fail("configs/run_config.yml is not the single-video configuration this phase expects")
        pair_env = ("FLICKER_POOL_PALLAS_2A", "FLICKER_POOL_PALLAS_3A")
        for key in pair_env:
            os.environ.pop(key, None)
        with contextlib.redirect_stdout(io.StringIO()):
            sv_engine, sv_labels = common.build_engine(sv, cfg.MODEL, frames=SV_FRAMES)
        # three clips: two named with the seeded model's clean prediction (one
        # of noise, one darker and smoother), the third with a wrong class
        rng = np.random.default_rng(SEED + 9)
        infer = InferenceModel(sv_engine)
        for k in range(3):
            clip = rng.uniform(-1, 1, (1, SV_FRAMES, SIZE, SIZE, 3)).astype(np.float32)
            if k == 1:
                clip = 0.5 * clip - 0.4
            top = int(infer(clip).argmax())
            cls = top if k < 2 else (top + 1) % CLASSES
            save_npy_clip(os.path.join(
                npy_dirs[k == 1], f"rgb_{k}@{sv_labels[cls].replace(' ', '_')}.npy"), clip)
        del sv_engine, infer

        def run_single(tag, out_dir, pair, step_counts, clean_counts):
            """single_video.run over both clip directories, with the counts
            reset just before and read just after; checks the pkls and the
            exact launch counts."""
            if pair:
                os.environ["FLICKER_POOL_PALLAS_2A"] = "2"
            said = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                written = []
                with contextlib.redirect_stdout(said):
                    for npy_dir in npy_dirs:
                        sv.NPY_PATH = npy_dir
                        sv.PKL_RESULT_PATH = os.path.join(tmp, out_dir, os.path.basename(npy_dir))
                        written += single_video.run(cfg, frames=SV_FRAMES)
            finally:
                os.environ.pop("FLICKER_POOL_PALLAS_2A", None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts(ops)
            said = said.getvalue()
            # the runner's line per clip, in the order of `written`
            lines = re.findall(r"fooled=(\w+) steps=(\d+) .*\(([\d.]+) steps/s\)", said)
            steps = [int(n) + 1 for _, n, _ in lines]
            n_steps = sum(steps)
            want = {k: n_steps * step_counts[k] + 3 * clean_counts[k] for k in NAMES}
            results = [load_result(path) for path in written]
            print(f"[single-video] {tag}: {len(written)} pkls "
                  f"{[os.path.basename(w) for w in written]} in {wall:.2f} s; steps {steps}, "
                  f"fooled {[f for f, _, _ in lines]}, final thickness and roughness in % "
                  f"{[(round(r['fatness'][-1], 5), round(r['smoothness'][-1], 5)) for r in results]}"
                  f", steps/s a clip {[float(r) for _, _, r in lines]}; launches {got} (expected {want})",
                  flush=True)
            if (len(set(written)) != 2 or len(lines) != 2
                    or not all(os.path.isfile(w) for w in written)
                    or said.count("clean model misclassifies") != 1):
                fail(f"single-video {tag}: expected two pkls and one skipped clip")
            if [r["total_steps"] + 1 for r in results] != steps:
                fail(f"single-video {tag}: the pkls' total_steps differ from the printed lines")
            if got != want:
                fail(f"single-video {tag}: kernel launch counts differ from the per-step counts")
            for path, r in zip(written, results):
                n = r["total_steps"] + 1
                if set(r) != SV_RESULT_KEYS:
                    fail(f"single-video {tag}: result keys {sorted(set(r) ^ SV_RESULT_KEYS)} differ")
                if "_beta1_0.5_th_" not in os.path.basename(path) or not path.endswith("%.pkl"):
                    fail(f"single-video {tag}: {path} does not follow the filename pattern")
                lists = ("total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l",
                         "diff_norm_reg_loss_l", "fatness", "smoothness", "perturbation", "softmax")
                if any(len(r[k]) != n for k in lists) or not 2 <= n <= 40 * SV_MAX_NUM_STEP + 1:
                    fail(f"single-video {tag}: history lengths differ from total_steps + 1 = {n}")
                if not all(math.isfinite(v) for k in lists[:5] for v in r[k]):
                    fail(f"single-video {tag}: a loss is not finite")
                if (r["final_delta"].shape != (SV_FRAMES, 1, 1, 3)
                        or not np.abs(r["final_delta"]).max() > 0
                        or r["perturbation"][0].shape != (SV_FRAMES, 1, 1, 3)
                        or r["adv_video"].shape != (1, SV_FRAMES, SIZE, SIZE, 3)
                        or not np.isfinite(r["adv_video"]).all()):
                    fail(f"single-video {tag}: final_delta did not move or a shape is wrong")
            rate = n_steps / sum(n / float(r) for n, (_, _, r) in zip(steps, lines))
            print(f"[time] single-video {tag}: {rate:.3f} steps/s by the loop's timer "
                  f"({1000 / max(rate, 1e-9):.1f} ms/step; the chained step alone takes "
                  f"{sv_ms:.1f} ms)", flush=True)
            return results

        sv_default = run_single("default", "sv_default", False, SV_STEP_COUNTS, SV_CLEAN_COUNTS)
        sv_pair = run_single(
            "FLICKER_POOL_PALLAS_2A=2", "sv_pair", True, SV_PAIR_STEP_COUNTS, SV_PAIR_CLEAN_COUNTS)
        for a, b in zip(sv_default, sv_pair):
            la, lb = a["total_loss_l"][0], b["total_loss_l"][0]
            lrel = abs(la - lb) / max(abs(la), 1e-30)
            print(f"[single-video] {a['correct_cls']}: first-step total_loss default {la:.6f}, "
                  f"pair {lb:.6f} (rel diff {lrel:.2e}, tolerance 1e-3)", flush=True)
            if not lrel <= 1e-3:
                fail("the pair configuration's first single-video loss disagrees")
        del sv_default, sv_pair

        # ---- 10. the class-gen runner and the inference wrapper -------------------------
        cg = cfg.CLASS_GEN_ATTACK
        cg.TF_RECORDS_TRAIN_PATH = [shard_dir]
        cg.TF_RECORDS_VAL_PATH = [shard_dir]
        cg.NUM_OF_TRAIN_TF_RECORDS = SHARDS
        cg.NUM_OF_VAL_TF_RECORDS = SHARDS
        cg.PKL_RESULT_PATH = os.path.join(tmp, "class_gen") + "/"
        cg.BATCH_SIZE = B
        if cg.get("COMPUTE_DTYPE", "bfloat16") != "bfloat16" or cg.TARGETED_ATTACK:
            fail("configs/run_config.yml is not the class-gen configuration this phase expects")
        for max_steps, resumed in ((SHARDS, False), (2 * SHARDS, True)):
            cg.MAX_NUM_STEP = max_steps
            said = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with contextlib.redirect_stdout(said):
                out = class_gen.run(cfg, frames=T)
            torch.cuda.synchronize()
            got = read_counts(ops)
            hist = out["history"]
            start = hist["fool_rate_steps"][0]
            n_eval = len(hist["fool_rate_steps"]) * SHARDS
            want = {k: (max_steps - start) * TRAIN_COUNTS[k] + n_eval * EVAL_COUNTS[k]
                    for k in NAMES}
            ckpts = AttackCheckpointer(os.path.join(cg.PKL_RESULT_PATH, "ckpt")).steps()
            with open(os.path.join(cg.PKL_RESULT_PATH, "res.pkl"), "rb") as f:
                res = pickle.load(f)
            print(f"[class-gen] steps {start}->{out['steps']}; evals at {hist['fool_rate_steps']}; "
                  f"final eval {out['final_eval']}; checkpoints {ckpts}; "
                  f"{out['steps_per_sec']:.3f} steps/s by the loop's timer; launches {got} "
                  f"(expected {want})", flush=True)
            if out["steps"] != max_steps or start != (SHARDS if resumed else 0):
                fail("class-gen: wrong start or end step")
            if resumed != (f"resumed from step {SHARDS}" in said.getvalue()):
                fail("class-gen: the resume line is missing or unexpected")
            if got != want:
                fail("class-gen: kernel launch counts differ from the per-step counts")
            if max_steps not in ckpts or set(res) != CLASS_GEN_KEYS or res["total_steps"] != max_steps:
                fail("class-gen: the epoch-end checkpoint or res.pkl is missing or malformed")
            if out["final_eval"]["total_valid_videos"] != SHARDS * PER_SHARD:
                fail("class-gen: not every self-labelled clip counted as valid")
            if not (math.isfinite(out["final_eval"]["miss_rate"])
                    and all(math.isfinite(v) for v in res["total_loss_l"])):
                fail("class-gen: a loss or the fooling rate is not finite")
        with contextlib.redirect_stdout(io.StringIO()):
            eng, _ = common.build_engine(cg, cfg.MODEL, frames=T, track_probs=False)
        infer = InferenceModel(eng, out["state"].delta.cpu().numpy())
        clip = first_batch["video"][:1]
        one = {"video": clip, "labels": first_batch["labels"][:1]}
        for adv_flag, adversarial in ((0.0, False), (1.0, True)):
            probs = infer(clip, adv_flag=adv_flag)
            ref = eng.forward(out["state"].delta, one, flags, adversarial=adversarial).cpu().numpy()
            err = float(np.abs(probs - ref).max())
            print(f"[inference] InferenceModel adv_flag={adv_flag:g} against engine.forward("
                  f"adversarial={adversarial}): max_abs_err {err:.3e} (tolerance 1e-6), top-1 "
                  f"{int(probs.argmax())}", flush=True)
            if probs.shape != (1, CLASSES) or not err <= 1e-6:
                fail("InferenceModel disagrees with engine.forward")
        del eng, infer
        torch.cuda.empty_cache()

        # ---- 11. the real-victim path: checkpoint files, rgb and rgb600 ---------------
        # seed 1, not build_victim's seed 0: a silent random init would show.
        # The card has no TensorFlow to write a DeepMind checkpoint, so the
        # state goes through the checkpoint's names and back (the TF bundle
        # reader is held against TensorFlow on the CPU)
        weights = {}
        for world, classes in (("rgb", CLASSES), ("rgb600", 600)):
            state = init_i3d_state(1, classes)
            back = convert_i3d_var_map(i3d_var_map(state, bare_names=world == "rgb600"),
                                       eval_type=world)
            if set(back) != set(state) or not all(torch.equal(back[k], state[k]) for k in state):
                fail(f"real victim ({world}): the DeepMind names do not convert back bit-equal")
            weights[world] = (state, os.path.join(tmp, f"i3d_{world}.pt"))
            convert_cli.save_weights(back, weights[world][1])
        npz = os.path.join(tmp, "golden_rgb.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            convert_cli.main(["i3d", weights["rgb"][1], "--dump-golden", npz])
        report = golden.verify_golden(npz)
        print(f"[victim] seed-1 states (400 classes, prefixed names; 600 classes, bare names) "
              f"through the DeepMind names and back: bit-equal; convert.cli wrote "
              f"{[os.path.basename(w[1]) for w in weights.values()]}; golden file at "
              f"{golden.GOLDEN_GEOMETRY['tanh']} verified: {report}", flush=True)

        built = []

        def keep_victim(*args, **kw):
            built.append(real_build_victim(*args, **kw))
            return built[-1]

        real_build_victim = common.build_victim
        cfg.MODEL.CKPT_PATH = weights["rgb"][1]
        ac.USE_PALLAS_FUSED = False
        ac.MAX_NUM_STEP = VICTIM_STEPS
        with mock.patch.object(common, "build_victim", keep_victim):
            out, said, _, _ = run_runner("real victim (seed-1 .pt)", "victim", VICTIM_STEPS,
                                         TRAIN_COUNTS, EVAL_COUNTS, step_ms)
        if "[warn]" in said or "random init" in said:
            fail("real victim: the runner warned of random init")
        state = weights["rgb"][0]
        got_sd = built[0].state_dict()
        if set(got_sd) != set(state) or not all(torch.equal(got_sd[k].cpu(), state[k]) for k in state):
            fail("real victim: the runner's model does not hold the checkpoint's weights")
        direct = InceptionI3D(CLASSES, torch.bfloat16, device=dev)
        direct.load_state_dict(state)
        x = torch.from_numpy(first_batch["video"]).to(dev).float() / 128.0 - 1.0
        with torch.no_grad():
            mine, theirs = built[0](x)[0], direct(x)[0]
        print(f"[victim] universal runner on {os.path.basename(weights['rgb'][1])}: "
              f"{out['steps']} steps, final eval {out['final_eval']}; clean logits of its model "
              f"bit-equal to a model given the state: {torch.equal(mine, theirs)} (top-1 "
              f"{mine.argmax(-1).tolist()})", flush=True)
        if not torch.equal(mine, theirs):
            fail("real victim: the runner's clean logits differ from the directly loaded model's")
        victim_hist, victim_delta = out["history"], out["state"].delta.clone()
        del built, direct, mine, theirs, x
        default_ckpt = cfg.MODEL.CKPT_PATH = "data/checkpoints/rgb_imagenet/model.ckpt"

        cfg600 = load_config(os.path.join(HERE, "configs", "run_config_rgb600.yml"))
        sv6 = cfg600.SINGLE_VIDEO_ATTACK
        if (cfg600.MODEL.EVAL_TYPE != "rgb600" or sv6.COMPUTE_DTYPE != "bfloat16"
                or sv6.TARGETED_ATTACK):
            fail("configs/run_config_rgb600.yml is not the configuration this phase expects")
        cfg600.MODEL.CKPT_PATH = weights["rgb600"][1]
        sv6.NPY_PATH = os.path.join(tmp, "npy600")
        sv6.PKL_RESULT_PATH = os.path.join(tmp, "sv600") + "/"
        sv6.MAX_NUM_STEP = 1
        os.makedirs(sv6.NPY_PATH)
        with contextlib.redirect_stdout(io.StringIO()):
            eng600, labels600 = common.build_engine(sv6, cfg600.MODEL, frames=SV_FRAMES)
        clip = np.random.default_rng(SEED + 11).uniform(
            -1, 1, (1, SV_FRAMES, SIZE, SIZE, 3)).astype(np.float32)
        top = int(InferenceModel(eng600)(clip).argmax())
        if labels600 != kinetics600_labels() or eng600.model.num_classes != 600:
            fail("rgb600: the engine is not 600-way or its labels are not Kinetics-600's")
        save_npy_clip(os.path.join(sv6.NPY_PATH, f"rgb_0@{labels600[top].replace(' ', '_')}.npy"),
                      clip)
        del eng600
        said = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(said):
            written = single_video.run(cfg600, frames=SV_FRAMES)
        torch.cuda.synchronize()
        got = read_counts(ops)
        said = said.getvalue()
        results = [load_result(w) for w in written]
        n_steps = sum(r["total_steps"] + 1 for r in results)
        want = {k: n_steps * SV_STEP_COUNTS[k] + SV_CLEAN_COUNTS[k] for k in NAMES}
        print(f"[victim] rgb600 single-video ({os.path.basename(HERE)}/configs/"
              f"run_config_rgb600.yml): class {labels600[top]!r} ({top}); pkls "
              f"{[os.path.basename(w) for w in written]}; steps {n_steps}; fooled "
              f"{[r['is_adversarial'] for r in results]}; launches {got} (expected {want})",
              flush=True)
        if len(written) != 1 or not os.path.isfile(written[0]) or "[warn]" in said:
            fail("rgb600: expected one pkl and no random-init warning")
        r = results[0]
        if r["softmax_init"].shape[-1] != 600 or not all(
                math.isfinite(v) for k in ("total_loss_l", "adv_loss_l", "reg_loss_l") for v in r[k]):
            fail("rgb600: the pkl's softmax is not 600-way or a loss is not finite")
        if got != want:
            fail("rgb600: kernel launch counts differ from the per-step counts")

        # ---- 12. the universal runner, the L1,2 sparse attack ---------------------------
        # FLICKERING_ATTACK: False on phase 7's shards: a full delta
        # [T,224,224,3], no host prepack (the generic path), results under
        # SUP_ATTACK; seed-0 random weights (no checkpoint), as phase 7
        ac.FLICKERING_ATTACK = False
        ac.MAX_NUM_STEP = VICTIM_STEPS
        out, said, _, _ = run_runner("sparse (FLICKERING_ATTACK: False)", "sparse", VICTIM_STEPS,
                                     SPARSE_TRAIN_COUNTS, SPARSE_EVAL_COUNTS,
                                     new_step_ms["sparse"])
        model_dir = universal.model_dir_name(ac)
        with open(os.path.join(model_dir, "res.pkl"), "rb") as f:
            res = pickle.load(f)
        shapes_pkl = {tuple(p.shape) for p in res["history"]["perturbation"]}
        print(f"[sparse] results under {os.path.relpath(model_dir, tmp)}; delta "
              f"{list(out['state'].delta.shape)}, range [{out['state'].delta.min().item():.3e}, "
              f"{out['state'].delta.max().item():.3e}]; res.pkl perturbations {shapes_pkl}; "
              f"first losses {[round(v, 6) for v in out['history']['total_loss']]}; l12 logged "
              f"on every step", flush=True)
        if ("SUP_ATTACK" not in model_dir or "host-prepacked" in said
                or tuple(out["state"].delta.shape) != (T, SIZE, SIZE, 3)
                or shapes_pkl != {(T, SIZE, SIZE, 3)}
                or not out["state"].delta.abs().max().item() > 1e-7):
            fail("sparse runner: not under SUP_ATTACK, prepacked, or a delta of the wrong "
                 "shape or unmoved")
        ac.FLICKERING_ATTACK = True

        # ---- 13. a .msgpack of Flax variables through the universal runner ------------
        # phase 11's seed-1 state as the JAX package's Flax tree, written by
        # the port's save_variables (flax's msgpack bytes; the card has no
        # flax and no msgpack): read back bit-equal, and the runner on it
        # runs phase 11's 4 steps, history and delta bit for bit
        msgpack_path = os.path.join(tmp, "i3d_rgb.msgpack")
        convert_cli.save_variables(to_flax_variables(weights["rgb"][0]), msgpack_path)
        back = convert_cli.load_weights(msgpack_path)
        state = weights["rgb"][0]
        if set(back) != set(state) or not all(torch.equal(back[k], state[k]) for k in state):
            fail(".msgpack: the weights do not read back bit-equal")
        built = []
        cfg.MODEL.CKPT_PATH = msgpack_path
        with mock.patch.object(common, "build_victim", keep_victim):
            out, said, _, _ = run_runner("real victim (seed-1 .msgpack)", "victim_msgpack",
                                         VICTIM_STEPS, TRAIN_COUNTS, EVAL_COUNTS, step_ms)
        got_sd = built[0].state_dict()
        same_w = set(got_sd) == set(state) and all(torch.equal(got_sd[k].cpu(), state[k])
                                                   for k in state)
        same_run = (out["history"]["total_loss"] == victim_hist["total_loss"]
                    and out["history"]["fool_rate"] == victim_hist["fool_rate"]
                    and torch.equal(out["state"].delta, victim_delta))
        print(f"[msgpack] {os.path.basename(msgpack_path)} ({os.path.getsize(msgpack_path) / 1e6:.1f}"
              f" MB) written by save_variables, read back bit-equal; the runner's model holds "
              f"the weights of the .pt route: {same_w}; history and final delta equal to the .pt "
              f"route's run: {same_run}", flush=True)
        if "[warn]" in said or not same_w or not same_run:
            fail(".msgpack: the runner warned, or its weights or run differ from the .pt route's")
        del built, got_sd, back
        cfg.MODEL.CKPT_PATH = default_ckpt

        # ---- 14. the cyclic rolls through the single-video runner ----------------------
        # CYCLIC_ATTACK and CYCLIC_PERTURBATION_ATTACK on phase 9's first
        # directory (a kept clip, seed 0, and the misnamed clip, seed 1,
        # skipped after its clean forward): exact launch counts, a pkl,
        # finite losses
        sv.CYCLIC_ATTACK = sv.CYCLIC_PERTURBATION_ATTACK = True
        sv.NPY_PATH, sv.MAX_NUM_STEP = npy_dirs[0], SV_MAX_NUM_STEP
        sv.PKL_RESULT_PATH = os.path.join(tmp, "sv_cyclic") + "/"
        said = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(said):
            written = single_video.run(cfg, frames=SV_FRAMES)
        torch.cuda.synchronize()
        got = read_counts(ops)
        results = [load_result(w) for w in written]
        n_steps = sum(r["total_steps"] + 1 for r in results)
        n_clips = len(os.listdir(npy_dirs[0]))
        want = {k: n_steps * SV_STEP_COUNTS[k] + n_clips * SV_CLEAN_COUNTS[k] for k in NAMES}
        rate = re.findall(r"\(([\d.]+) steps/s\)", said.getvalue())
        print(f"[cyclic] single-video runner, both cyclic flags: pkls "
              f"{[os.path.basename(w) for w in written]}; steps {n_steps}; {rate} steps/s by the "
              f"loop's timer; launches {got} (expected {want})", flush=True)
        if len(written) != 1 or got != want:
            fail("cyclic single-video: expected one pkl and the per-step launch counts")
        r = results[0]
        if not (all(math.isfinite(v) for v in r["total_loss_l"])
                and np.abs(r["final_delta"]).max() > 0):
            fail("cyclic single-video: a loss is not finite or delta did not move")
        sv.CYCLIC_ATTACK = sv.CYCLIC_PERTURBATION_ATTACK = False

        # ---- 15. a clip wider than 256 columns ---------------------------------------
        # one float32 clip [1,90,288,288,3]: its packed stem has W' = 144, B1
        # in 2 column segments.  Up to Mixed_5c with an input gradient (the
        # float-clip stem: B1 forward, B2 its dgrad): exact counts, the stem
        # against B1's plain version, a finite input gradient.  Through the
        # single-video runner its clean forward reaches the Logits, whose 7x7
        # average pool leaves a 3x3 map at 288: neither package squeezes it
        # (the JAX package's jnp.squeeze raises there too), so the runner
        # raises after B1 ran in its segments
        rng = np.random.default_rng(SEED + 13)
        wide = rng.uniform(-1, 1, (1, SV_FRAMES, WIDE_SIZE, WIDE_SIZE, 3)).astype(np.float32)
        xw = torch.from_numpy(wide).to(dev).requires_grad_(True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        y, ep = model(xw, final_endpoint="Mixed_5c")
        y.float().sum().backward()
        torch.cuda.synchronize()
        got = read_counts(ops)
        with torch.no_grad():
            want_stem = stem_conv.stem_conv_bn_relu_plain(
                pack_input(xw.detach().to(torch.bfloat16)), *model.stem_params())
        err, rel = compare(ep["Conv3d_1a_7x7"], want_stem)
        gfin = bool(torch.isfinite(xw.grad).all()) and xw.grad.abs().max().item() > 0
        print(f"[wide] [1,{SV_FRAMES},{WIDE_SIZE},{WIDE_SIZE},3] up to Mixed_5c "
              f"{list(y.shape)} with its input gradient: launches {got} (expected "
              f"{WIDE_FORWARD_COUNTS}); the stem [1,{SV_FRAMES // 2},{WIDE_SIZE // 2},"
              f"{WIDE_SIZE // 2},64] against B1's plain version max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tolerance {tol[('B1', torch.bfloat16)]:g}); input gradient finite and "
              f"nonzero: {gfin}", flush=True)
        if got != WIDE_FORWARD_COUNTS or not rel <= tol[("B1", torch.bfloat16)] or not gfin:
            fail("wide clip: launch counts, the segmented stem or the input gradient")
        del y, ep, xw, want_stem
        sv.NPY_PATH = os.path.join(tmp, "npy_wide")
        sv.PKL_RESULT_PATH = os.path.join(tmp, "sv_wide") + "/"
        os.makedirs(sv.NPY_PATH)
        save_npy_clip(os.path.join(sv.NPY_PATH, f"rgb_0@{sv_labels[0].replace(' ', '_')}.npy"),
                      wide)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                single_video.run(cfg, frames=SV_FRAMES)
            raised = None
        except ValueError as e:
            raised = str(e)
        torch.cuda.synchronize()
        got = read_counts(ops)
        print(f"[wide] single-video runner at {WIDE_SIZE}x{WIDE_SIZE}: raised {raised!r} after "
              f"its clean forward's launches {got} (expected {WIDE_CLEAN_COUNTS})", flush=True)
        if raised is None or "squeezable" not in raised or got != WIDE_CLEAN_COUNTS:
            fail("wide clip: the runner did not refuse the unsqueezable logits after B1's "
                 "segments ran")
        del wide

        # ---- 16. the torch world --------------------------------------------------------
        del model
        torch.cuda.empty_cache()
        sweep_run = torch_world_phase(tmp, dev)

        # ---- 17. the vectorized per-video sweep -------------------------------------------
        torch.cuda.empty_cache()
        table.extend(vector_sweep_phase(tmp, dev, sweep_run))

        # ---- 18. data parallel over ranks -------------------------------------------------
        torch.cuda.empty_cache()
        dp_world1_phase(tmp, dev, shard_dir, {"history": default_hist, "delta": delta12})
        torch.cuda.empty_cache()
        dp_gloo_phase(tmp, dev)
        dp_sweep_phase(tmp, dev, sweep_run)

        # ---- 19. the float schema -----------------------------------------------------
        torch.cuda.empty_cache()
        float_schema_phase(tmp, dev)

        # ---- 20. the last modules: the flow, tracing and the tally, the epoch loader --------
        torch.cuda.empty_cache()
        flow_phase(dev)
        torch.cuda.empty_cache()
        tally_engine, tally_state = tally_phase(tmp, dev)
        epoch_loader_phase(shard_dir, dev, tally_engine, tally_state)
        del tally_engine, tally_state
    print(f"[time] whole run {time.perf_counter() - t_start:.1f} s")
    print(card_name_and_limit())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Run chip_smoke.py's phase 18 (data parallel over ranks) alone on one card.

    python3 scripts/torch_parallel_phase.py [--with-sweep]

18a holds the universal runner at world 1 over NCCL against a run of the
same runner in one process on the same shards: the script writes
chip_smoke.SHARDS shards of chip_smoke.PER_SHARD seeded uint8 clips of
64x224x224 (seeded labels), runs ``runners.universal.run`` on them for
chip_smoke.RUNNER_STEPS steps without a group (phase 7's run), then 18a
against it, then 18b and 18d (the mesh shrunk to rank 0 by a batch of 3
over two ranks).  ``--with-sweep`` also runs phases 16 and 17 for the
per-video sweep that 18c reruns over two ranks (about two minutes more).
Builds the port's kernels first; needs one CUDA card; exits non-zero on the
first failed check, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--with-sweep", action="store_true",
                   help="also phases 16 and 17, and 18c on their sweep")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", flush=True)
        return 1
    from flickering_adversarial_video_tpu_torch.data import TFRecordWriter, make_uint8_example
    from flickering_adversarial_video_tpu_torch.ops import kernels
    from flickering_adversarial_video_tpu_torch.runners import universal
    from flickering_adversarial_video_tpu_torch.utils.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="fav_dp_") as tmp:
        shard_dir = os.path.join(tmp, "shards")
        os.makedirs(shard_dir)
        rng = np.random.default_rng(cs.SEED)
        for s in range(cs.SHARDS):
            clips = rng.integers(0, 256, (cs.PER_SHARD, cs.T, cs.SIZE, cs.SIZE, 3), np.uint8)
            with TFRecordWriter(os.path.join(shard_dir, f"shard{s}.tfrecords")) as w:
                for clip in clips:
                    w.write(make_uint8_example(clip, int(rng.integers(0, cs.CLASSES))))
        cfg = load_config(os.path.join(cs.HERE, "configs", "run_config.yml"))
        ac = cfg.UNIVERSAL_ATTACK
        ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shard_dir]
        ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = cs.SHARDS
        ac.BATCH_SIZE, ac.MAX_NUM_STEP = cs.B, cs.RUNNER_STEPS
        ac.PKL_RESULT_PATH = os.path.join(tmp, "reference")
        with contextlib.redirect_stdout(io.StringIO()):
            ref = universal.run(cfg, frames=cs.T, max_steps=cs.RUNNER_STEPS)
        print(f"[parallel] reference run in one process: {ref['steps']} steps, evals at "
              f"{ref['history']['fool_rate_steps']}", flush=True)
        cs.dp_world1_phase(tmp, dev, shard_dir, {"history": ref["history"],
                                                 "delta": ref["state"].delta.clone()})
        torch.cuda.empty_cache()
        cs.dp_gloo_phase(tmp, dev)
        cs.dp_shrink_phase(tmp, dev, shard_dir)
        if args.with_sweep:
            sweep_run = cs.torch_world_phase(tmp, dev)
            cs.vector_sweep_phase(tmp, dev, sweep_run)
            cs.dp_sweep_phase(tmp, dev, sweep_run)
    print(f"[time] phase 18 alone {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

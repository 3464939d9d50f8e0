"""Universal attack runner.

Port of the JAX package's ``runners/universal.py``: one flickering delta
optimized over all-class Kinetics tfrecord shards, step-cadenced checkpoints
(every 100 steps, keep 5), resume from the latest checkpoint else the
zero-perturbation start, TensorBoard scalars every 50 steps with the
reference's tag names, and an exclude-misclassified fooling eval over the
val shards.  FLICKERING_ATTACK false selects the L1,2 sparse variant (a full
[T,H,W,3] delta), whose results go under ``SUP_ATTACK``.

Data parallel under torchrun (``runners/common.build_engine``): each rank
of the mesh (the d ranks that divide ``BATCH_SIZE``) attacks with
``BATCH_SIZE / d`` clips a step from its own shards, d(delta) summed over
the ranks in the step; rank 0 writes the checkpoints, the scalars and
res.pkl, and the idle ranks wait for the end and return None.  In one
process the runner runs as it always did.

Usage: python -m flickering_adversarial_video_tpu_torch.runners.universal [run_config.yml]
       torchrun --nproc-per-node N -m flickering_adversarial_video_tpu_torch.runners.universal cfg.yml
"""

from __future__ import annotations

import os
import pickle
import sys

from ..data.tfrecord import list_shards, tfrecord_batches
from ..engine.checkpoint import AttackCheckpointer
from ..engine.loops import batched_attack_loop, flags_from_config
from ..parallel import mesh as mesh_lib
from ..utils.config import load_config
from ..viz.tensorboard import ScalarWriter
from .common import build_engine, make_shard_batches


def model_dir_name(attack_cfg) -> str:
    """Naming parity with the reference."""
    attack_type = (
        "FLICKERING_ATTACK" if attack_cfg.get("FLICKERING_ATTACK", True) else "SUP_ATTACK"
    )
    source_class = str(attack_cfg.TF_RECORDS_TRAIN_PATH[-1]).rstrip("/").split("/")[-1]
    n_train = attack_cfg.NUM_OF_VID_EACH_TF_RECORDS * attack_cfg.NUM_OF_TRAIN_TF_RECORDS
    n_val = attack_cfg.NUM_OF_VID_EACH_TF_RECORDS * attack_cfg.NUM_OF_VAL_TF_RECORDS
    return os.path.join(
        attack_cfg.PKL_RESULT_PATH,
        attack_type,
        f"{source_class}_t{n_train}_v{n_val}_",
    )


def run(cfg, *, frames: int = 90, size=None, max_steps=None, device=None):
    """Run the attack of cfg.UNIVERSAL_ATTACK on `device` (CUDA unless the
    caller asks for "cpu")."""
    attack_cfg = cfg.UNIVERSAL_ATTACK
    attack_kind = "flickering" if attack_cfg.get("FLICKERING_ATTACK", True) else "sparse"
    engine, labels = build_engine(
        attack_cfg, cfg.MODEL, frames=frames, size=size, attack_kind=attack_kind,
        track_probs=False, device=device,
    )
    if engine is None:  # an idle rank: the batch splits over fewer ranks
        mesh_lib.join_world()
        return None
    flags = flags_from_config(attack_cfg)

    train_shards = list_shards(
        attack_cfg.TF_RECORDS_TRAIN_PATH, attack_cfg.NUM_OF_TRAIN_TF_RECORDS
    )
    val_shards = list_shards(
        attack_cfg.TF_RECORDS_VAL_PATH, attack_cfg.NUM_OF_VAL_TF_RECORDS
    )
    print("train shards:", *train_shards, sep="\n  ")
    print("val shards:", *val_shards, sep="\n  ")
    batch_size = int(attack_cfg.BATCH_SIZE)
    batches, _ = make_shard_batches(
        attack_cfg, engine, lambda *a, **kw: tfrecord_batches(*a, **kw),
        frames=frames, size=size, batch_size=batch_size,
    )

    rank = 0 if engine.mesh is None else engine.mesh.rank
    model_dir = model_dir_name(attack_cfg)
    os.makedirs(model_dir, exist_ok=True)
    ckpt = AttackCheckpointer(os.path.join(model_dir, "ckpt"), max_to_keep=5, rank=rank)
    writer = ScalarWriter(os.path.join(model_dir, "train")) if rank == 0 else None

    # resume: latest checkpoint else fresh zero-pert state (warm-start parity)
    state = engine.init_state()
    start_step = 0
    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        start_step = int(state.step)
        print(f"Continue training from step {start_step}")
    else:
        print("Begin new training from the zero-perturbation start")

    targeted_label = None
    if attack_cfg.TARGETED_ATTACK:
        targeted_label = labels.index(attack_cfg.TARGETED_CLASS)

    out = batched_attack_loop(
        engine,
        lambda: batches(train_shards),
        lambda: batches(val_shards),
        flags,
        max_steps=max_steps or int(attack_cfg.MAX_NUM_STEP),
        state=state,
        # estimator-style throttled eval; EVAL_EVERY_STEPS null/absent keeps
        # the epoch-boundary cadence
        eval_every_steps=(
            int(attack_cfg["EVAL_EVERY_STEPS"])
            if attack_cfg.get("EVAL_EVERY_STEPS")
            else None
        ),
        checkpointer=ckpt,
        checkpoint_every=100,
        writer=writer,
        log_every=50,
        targeted_label=targeted_label,
        start_step=start_step,
    )
    mesh_lib.join_world()
    if rank != 0:
        return out
    writer.close()
    with open(os.path.join(model_dir, "res.pkl"), "wb") as f:
        pickle.dump({"history": out["history"], "final_eval": out["final_eval"]}, f)
    print(
        f"done: steps={out['steps']} fooling={out['final_eval']['miss_rate']:.4f} "
        f"({out['steps_per_sec']:.2f} steps/s)"
    )
    return out


def main(argv=None):
    import argparse

    argv = argv if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default=None, help="run_config.yml path")
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--size", type=int, default=None)
    p.add_argument(
        "--max-steps", type=int, default=None,
        help="override MAX_NUM_STEP (rehearsal/smoke runs)",
    )
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    run(cfg, frames=args.frames, size=args.size, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()

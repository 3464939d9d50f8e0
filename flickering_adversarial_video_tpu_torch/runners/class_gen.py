"""Single-class generalization attack runner.

Port of the JAX package's ``runners/class_gen.py``: one delta fooling every
video of one Kinetics class: an epoch loop over the class's tfrecord shards
with the exclude-misclassified fooling eval, a checkpoint at every epoch end
and a pkl dump, resuming from the latest checkpoint.  Data parallel under
torchrun as the universal runner (rank 0 writes the checkpoints, the scalars
and res.pkl; ranks outside the mesh wait for the end and return None).

Usage: python -m flickering_adversarial_video_tpu_torch.runners.class_gen [run_config.yml]
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


def run(cfg, *, frames: int = 90, size=None, max_steps=None, device=None):
    """Run the attack of cfg.CLASS_GEN_ATTACK on `device` (CUDA unless the
    caller asks for "cpu")."""
    attack_cfg = cfg.CLASS_GEN_ATTACK
    engine, labels = build_engine(
        attack_cfg, cfg.MODEL, frames=frames, size=size, track_probs=False, device=device
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
    batch_size = int(attack_cfg.BATCH_SIZE)

    rank = 0 if engine.mesh is None else engine.mesh.rank
    result_path = attack_cfg.PKL_RESULT_PATH
    os.makedirs(result_path, exist_ok=True)
    ckpt = AttackCheckpointer(os.path.join(result_path, "ckpt"), rank=rank)
    writer = ScalarWriter(os.path.join(result_path, "train")) if rank == 0 else None

    state = engine.init_state()
    start_step = 0
    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        start_step = int(state.step)
        print(f"resumed from step {start_step}")

    targeted_label = None
    if attack_cfg.TARGETED_ATTACK:
        targeted_label = labels.index(attack_cfg.TARGETED_CLASS)

    # host-prepacked input: the same default-on path as the universal runner
    batches, _ = make_shard_batches(
        attack_cfg, engine, lambda *a, **kw: tfrecord_batches(*a, **kw),
        frames=frames, size=size, batch_size=batch_size,
    )

    out = batched_attack_loop(
        engine,
        lambda: batches(train_shards),
        lambda: batches(val_shards),
        flags,
        max_steps=max_steps or int(attack_cfg.MAX_NUM_STEP),
        state=state,
        checkpointer=ckpt,
        checkpoint_every=None,  # epoch-end cadence
        writer=writer,
        targeted_label=targeted_label,
        start_step=start_step,
    )
    mesh_lib.join_world()
    if rank != 0:
        return out
    writer.close()

    h = out["history"]
    res_dict = {
        "total_loss_l": h["total_loss"],
        "adv_loss_l": h["adv_loss"],
        "reg_loss_l": h["reg_loss"],
        "norm_reg_loss_l": h["norm_reg"],
        "diff_norm_reg_loss_l": h["diff_norm_reg"],
        "perturbation": h["perturbation"],
        "total_steps": out["steps"],
        "beta_1": float(attack_cfg.BETA_1),
        "beta_2": float(attack_cfg.BETA_2),
        "fatness": h["thickness"],
        "smoothness": h["roughness"],
        "fool_rate": h["fool_rate"],
    }
    with open(os.path.join(result_path, "res.pkl"), "wb") as f:
        pickle.dump(res_dict, f)
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

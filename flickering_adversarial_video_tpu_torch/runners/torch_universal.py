"""Universal attack on the video-ResNet victims (the mean/std world).

Port of the JAX package's ``runners/torch_universal.py``: delta [T,1,1,3]
with an L-inf budget (0.1 by default), the epoch fit with train and valid
phases (``engine/epoch_fit.py``; each train step is ``train_eval_step``),
one result ``.npy`` an epoch, and a resume from the newest.  The model is
chosen by the reference's string ('r2plus1d_18' | 'r3d_18' | 'mc3_18' |
'r2plus1d_34'); videos are decoded with OpenCV (``data/video_dataset.py``),
which the port's card lacks: there, stub ``VideoDataset._decode``.

Usage:
  python -m flickering_adversarial_video_tpu_torch.runners.torch_universal \\
      --model r2plus1d_18 --train-split train.txt --valid-split val.txt \\
      --video-root /data/kinetics400 --epochs 22 --lr 1e-3 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..attack import TorchStyleFlickerSpec
from ..data.video_dataset import VideoDataset, records_from_split_file
from ..engine import AttackConfig, AttackEngine, RuntimeFlags
from ..engine.epoch_fit import find_resume, fit_universal_epochs
from ..parallel import mesh as mesh_lib
from .common import build_victim

# per-model batch sizes of the reference's runs
BATCH_SIZES = {"r2plus1d_18": 16, "r3d_18": 16, "mc3_18": 20}


def run(
    model_name: str = "r2plus1d_18",
    *,
    train_records=None,
    valid_records=None,
    ckpt_path: str = None,
    epochs: int = 22,
    lr: float = 1e-3,
    l_inf_norm: float = 0.1,
    batch_size: int = None,
    sample_length: int = 16,
    input_size: int = 112,
    model_dir: str = "checkpoints_torch_universal",
    loss_cfg: dict = None,
    max_batches: int = None,
    use_one_cycle_policy: bool = False,
    warmup_pct: float = 0.3,
    num_classes: int = None,
    compute_dtype=torch.bfloat16,
    device=None,
):
    """The epoch fit on `device` (CUDA unless the caller asks for "cpu");
    returns this call's epoch results.  One process: the JAX package's fit
    has no mesh, so a run of several ranks is refused."""
    mesh_lib.refuse_world("runners.torch_universal (the epoch fit)", "run it in one process")
    loss_cfg = loss_cfg or {}
    batch_size = batch_size or BATCH_SIZES.get(model_name, 16)
    model = build_victim(model_name, ckpt_path, compute_dtype, sample_length, input_size,
                         num_classes=num_classes, device=device)
    spec = TorchStyleFlickerSpec(frames=sample_length, max_norm=l_inf_norm)
    cfg = AttackConfig(
        improve_loss=loss_cfg.get("improve_loss", True),
        margin=loss_cfg.get("margin", 0.05),
        targeted=loss_cfg.get("targeted", False),
        use_logits=loss_cfg.get("use_logits", False),
        norm_world="meanstd",
        reg_weighting="torch",
        target_class=loss_cfg.get("target_class"),
    )
    engine = AttackEngine(model, spec, cfg, track_probs=True)
    flags = RuntimeFlags(
        beta0=loss_cfg.get("lambda_", 1.0),
        beta1=loss_cfg.get("beta_1", 0.5),
        learning_rate=lr,
        max_norm=l_inf_norm,
    )
    train_ds = VideoDataset(train_records, sample_length=sample_length, input_size=input_size)
    valid_ds = VideoDataset(valid_records, sample_length=sample_length, input_size=input_size,
                            random_offset=False, random_crop=False, random_flip=False)

    def limit(it):
        for i, b in enumerate(it):
            if max_batches is not None and i >= max_batches:
                break
            yield b

    delta0, last_epoch = find_resume(model_dir, model_name)
    state = engine.init_state()
    if delta0 is not None:
        state.delta = torch.as_tensor(delta0, dtype=torch.float32, device=engine.device)
        print(f"resuming from epoch {last_epoch}")
    return fit_universal_epochs(
        engine,
        lambda: limit(train_ds.batches(batch_size)),
        lambda: limit(valid_ds.batches(batch_size, shuffle=False)),
        flags,
        epochs=epochs,
        lr=lr,
        model_dir=model_dir,
        model_name=model_name,
        use_one_cycle_policy=use_one_cycle_policy,
        warmup_pct=warmup_pct,
        start_epoch=last_epoch + 1,
        state=state,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="r2plus1d_18")
    p.add_argument("--train-split", required=True)
    p.add_argument("--valid-split", required=True)
    p.add_argument("--video-root", default="")
    p.add_argument("--ckpt", default=None, help="torchvision state_dict path (.pt/.pth) or .msgpack")
    p.add_argument("--epochs", type=int, default=22)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--linf", type=float, default=0.1)
    p.add_argument("--model-dir", default="checkpoints_torch_universal")
    p.add_argument("--one-cycle", action="store_true",
                   help="one-cycle LR policy (reference use_one_cycle_policy)")
    p.add_argument("--warmup-pct", type=float, default=0.3)
    p.add_argument("--num-classes", type=int, default=None,
                   help="head width (359/487 for ig65m r2plus1d_34; default: the checkpoint's)")
    p.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    run(
        args.model,
        train_records=records_from_split_file(args.train_split, args.video_root),
        valid_records=records_from_split_file(args.valid_split, args.video_root),
        ckpt_path=args.ckpt,
        epochs=args.epochs,
        lr=args.lr,
        l_inf_norm=args.linf,
        model_dir=args.model_dir,
        use_one_cycle_policy=args.one_cycle,
        warmup_pct=args.warmup_pct,
        num_classes=args.num_classes,
        device=args.device,
    )


if __name__ == "__main__":
    main()

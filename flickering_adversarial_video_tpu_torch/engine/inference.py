"""Inference wrapper: a frozen victim callable with an adversarial flag, used
to pre-screen candidate videos and to evaluate saved perturbations.

Port of the JAX package's ``engine/inference.py``.  The cyclic flags are
per-call runtime scalars; they roll the input and delta when the engine was
built with ``AttackConfig.enable_cyclic`` and are inert otherwise, as in the
JAX package.  Each call draws its rolls from the seed of its call number
(the JAX wrapper's ``jax.random.key(self._step)``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..attack import perturbation as pert_lib
from .attack_step import AttackEngine, RuntimeFlags


class InferenceModel:
    """callable(clips, adv_flag=0, cyclic_input_flag=0, cyclic_eps_flag=0) -> probs.

    Wraps an AttackEngine with a fixed (loadable) delta; the flags are
    per-call scalars, like the reference's placeholders."""

    def __init__(self, engine: AttackEngine, delta: Optional[np.ndarray] = None):
        self.engine = engine
        self.delta = pert_lib.init_delta(engine.spec, device=engine.device)
        if delta is not None:
            self.load_perturbation(delta)
        self._step = 0

    def load_perturbation(self, delta: np.ndarray) -> None:
        self.delta = torch.as_tensor(
            np.asarray(delta), dtype=torch.float32, device=self.engine.device
        )

    def __call__(
        self,
        clips: np.ndarray,
        adv_flag: float = 0.0,
        cyclic_input_flag: float = 0.0,
        cyclic_eps_flag: float = 0.0,
        labels: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        clips = np.asarray(clips)
        if clips.ndim == 4:
            clips = clips[None]
        batch = {
            "video": clips,
            "labels": labels if labels is not None else np.zeros((clips.shape[0],), np.int64),
        }
        flags = RuntimeFlags(adv_flag=float(adv_flag), cyclic_flag=float(cyclic_input_flag),
                             cyclic_pert_flag=float(cyclic_eps_flag))
        self._step += 1
        probs = self.engine.forward(self.delta, batch, flags, adversarial=True, seed=self._step)
        return probs.cpu().numpy()  # the copy waits for the device

    def evaluate(
        self,
        samples,
        adv_flag: float = 0.0,
        report_every: int = 100,
        verbose: bool = True,
    ) -> dict:
        """Per-video inference statistics: for each video, given as (clips,
        label) with clips [N, T, H, W, C], N sampled clips of the same video,
        time one inference, record the video-level prediction (summed clip
        outputs) and every clip-level prediction, and report the average
        inference time plus video and clip accuracy.

        The clock stops after the probabilities have been copied to the host,
        which waits for the device."""
        ret = dict(
            infer_times=[],
            video_preds=[],
            video_trues=[],
            clip_preds=[],
            clip_trues=[],
        )
        for i, (clips, label) in enumerate(samples):
            if verbose and i and i % report_every == 0:
                print(f"Processing {i} samples..")
            clips = np.asarray(clips)
            if clips.ndim == 4:
                clips = clips[None]
            start = time.perf_counter()
            probs = self(clips, adv_flag=adv_flag)
            ret["infer_times"].append(time.perf_counter() - start)
            ret["video_preds"].append(int(probs.sum(axis=0).argmax()))
            ret["video_trues"].append(int(label))
            ret["clip_preds"].extend(int(p) for p in probs.argmax(axis=1))
            ret["clip_trues"].extend([int(label)] * clips.shape[0])
        n = len(ret["video_trues"])
        if n:
            video_acc = float(
                np.mean(np.array(ret["video_preds"]) == np.array(ret["video_trues"]))
            )
            clip_acc = float(
                np.mean(np.array(ret["clip_preds"]) == np.array(ret["clip_trues"]))
            )
            ret["video_accuracy"] = video_acc
            ret["clip_accuracy"] = clip_acc
            if verbose:
                print(
                    f"Avg. inference time per video ({n} videos) =",
                    round(float(np.mean(ret["infer_times"])) * 1000, 2),
                    "ms",
                )
                print("Video prediction accuracy =", round(video_acc, 2))
                print("Clip prediction accuracy =", round(clip_acc, 2))
        return ret

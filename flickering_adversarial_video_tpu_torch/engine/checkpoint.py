"""Attack-state checkpointing.

Port of the JAX package's ``engine/checkpoint.py`` (same class and methods)
with ``torch.save`` in place of orbax: only the attack state is
checkpointed -- (delta, mu, nu, step) -- into step-numbered files
``ckpt_<step>.pt``, each written to a temporary name and renamed, the oldest
pruned beyond `max_to_keep`.  The victim's weights are immutable inputs, so
a fresh AttackState IS the zero-perturbation warm start.  Over ranks, rank 0
saves (its state is every rank's) and every rank restores the same file.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from .attack_step import AttackState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class AttackCheckpointer:
    """save/restore/latest over a directory of step-numbered checkpoints;
    `rank` other than 0 restores but does not save."""

    def __init__(self, directory: str, max_to_keep: int = 5, rank: int = 0):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.rank = rank
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, state: AttackState) -> None:
        if self.rank != 0:
            return
        path = self._path(int(state.step))
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        for step in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(step))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: AttackState, step: Optional[int] = None) -> Optional[AttackState]:
        """The checkpoint of `step` (default: the latest) on the device of
        `template` (an init_state() result); None when the directory holds
        no checkpoint, and the caller starts from zero."""
        target = step if step is not None else self.latest_step()
        if target is None:
            return None
        loaded = torch.load(self._path(target), map_location="cpu", weights_only=True)
        return template.load_state_dict(loaded)

    def close(self):
        pass

"""The attack's train step as CUDA graphs: the port's counterpart of the JAX
engine's ``jax.jit(_train_step_impl, donate_argnums=(0,))`` and of
``train_steps``' ``lax.scan`` (``engine/attack_step.py:161,165,668``).

Eagerly, PyTorch dispatches the ~1,730 launches of an I3D step one by one
from the host.  Here each step shape is captured once with
``torch.cuda.graph`` and then replayed: one launch a step.

* **State.**  The graphs of an engine share one static state: delta, mu, nu
  and the step count (a device int32 the graph increments; Adam's bias
  corrections are computed from it on the device, in f32, as optax does).  A
  state that is not this static state (``init_state()``, a checkpoint) is
  copied into it before a replay; a state whose tensors are the static ones
  is not copied.  The returned ``AttackState`` holds the static tensors, so a
  state handed to a graphed step is donated, as the JAX engine donates it:
  the next step overwrites it.  Its ``step`` is a host int that mirrors the
  device count; a caller that hands back an older state object resets the
  device count to that state's step.
* **Inputs.**  The runtime flags live in the engine's static scalar buffer
  (written only when they change).  The batch, packed or not, is copied into
  the graph's static clip and labels; the packing and the host-to-device copy
  stay outside the graph.
* **One graph a (clip shape, clip dtype, packed?, labels shape)**, cached on
  the engine's ``StepGraphs``: the last short batch of a universal epoch, a
  single-video clip and a fused-kernel batch each key their own.  Each graph
  has its own memory pool, freed with the engine; ``stats`` gives what its
  capture reserved and how long the warm-up and capture took.
* **Metrics** are written inside the graph into one packed byte buffer, and
  copied out after the replay in one copy, so that the returned metrics do
  not alias the next replay's.
* **Launch counts.**  The ``ops`` wrappers count on the host.  A capture
  counts its launches once (the warm-up's are taken back), and each replay
  adds them.
* **No fallback.**  A capture or a replay that fails raises.  The CPU runs the
  eager step (``AttackEngine._train_step``) because it is the CPU; on the
  card that eager step is only the reference the graph is held to.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import ops

WARMUP_STEPS = 2  # eager steps on a side stream before a capture


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    video: torch.Tensor
    labels: torch.Tensor
    packed_metrics: torch.Tensor  # uint8: every metric's bytes, in 8-byte aligned slots
    layout: List[Tuple[str, int, int, torch.dtype, Tuple[int, ...]]]  # name, offset, bytes, ...
    launches: Dict[str, int]      # kernel launches a replay, by wrapper name
    pool_bytes: int               # what the capture reserved
    capture_s: float              # host seconds of the warm-up and the capture


class StepGraphs:
    """The train-step graphs of one engine and their static state.  Holds no
    reference to the engine (its step function is passed to each call), so
    the graphs and their pools go with the engine."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device):
        self.delta = torch.zeros(shape, device=device)
        self.mu = torch.zeros_like(self.delta)
        self.nu = torch.zeros_like(self.delta)
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self._step_value: Optional[int] = None  # host mirror of self.step
        self._graphs: Dict[tuple, _Graph] = {}

    def stats(self) -> Dict[tuple, Dict[str, float]]:
        """Each graph's pool (the bytes its capture reserved) and the host
        seconds its warm-up and capture took, by its key."""
        return {key: {"pool_bytes": g.pool_bytes, "capture_s": g.capture_s}
                for key, g in self._graphs.items()}

    def _load(self, state) -> None:
        for static, given in ((self.delta, state.delta), (self.mu, state.mu), (self.nu, state.nu)):
            if given is not static:
                static.copy_(given)
        if state.step != self._step_value:
            self.step.fill_(state.step)
            self._step_value = int(state.step)

    def run(self, step_fn: Callable, state, video: torch.Tensor, packed: bool,
            labels: torch.Tensor, n: int, with_metrics: bool):
        """n replays of the step graph of this batch's key from `state`:
        (the new state, holding the static tensors; the last step's metrics
        or None).  `step_fn(delta, mu, nu, step, video, packed, labels)`
        is the engine's step on tensors."""
        key = (tuple(video.shape), video.dtype, packed, tuple(labels.shape))
        self._load(state)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(step_fn, video, packed, labels)
        if video.data_ptr() != entry.video.data_ptr():
            entry.video.copy_(video)
        entry.labels.copy_(labels)
        for _ in range(n):
            entry.graph.replay()
        for name, fn in ops.kernel_wrappers():
            fn.launches += n * entry.launches[name]
        first = self._step_value
        self._step_value = first + n
        new_state = type(state)(self.delta, self.mu, self.nu, self._step_value)
        if not with_metrics:
            return new_state, None
        out = entry.packed_metrics.clone()  # one copy: no alias of the next replay
        metrics = {name: out[off:off + nbytes].view(dtype).view(shape)
                   for name, off, nbytes, dtype, shape in entry.layout}
        metrics["step"] = first + n - 1
        return new_state, metrics

    def _capture(self, step_fn: Callable, video: torch.Tensor, packed: bool,
                 labels: torch.Tensor) -> _Graph:
        t0 = time.perf_counter()
        video, labels = video.clone(), labels.clone()
        static = (self.delta, self.mu, self.nu, self.step)

        def step():
            (delta, mu, nu, count), metrics = step_fn(
                self.delta, self.mu, self.nu, self.step, video, packed, labels)
            for dst, src in zip(static, (delta, mu, nu, count)):
                dst.copy_(src)
            return metrics

        saved = [t.clone() for t in static]
        counts = ops.launch_counts()
        try:
            # warm-up on a side stream: cuDNN's plans, the kernels' first-launch
            # set-up (shared-memory limits, occupancy), autograd's threads
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step()
            torch.cuda.current_stream().wait_stream(side)
            for dst, src in zip(static, saved):
                dst.copy_(src)
            _set_counts(counts)

            graph = torch.cuda.CUDAGraph()
            # torch.cuda.graph empties the allocator's cache as it enters:
            # empty it first, so that the growth of the reserved memory is
            # the graph's pool
            torch.cuda.synchronize(video.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(video.device)
            # thread_local: a runner's producer thread pins and copies the
            # next batch meanwhile, on the default stream
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                metrics = step()
                layout, offset = [], 0
                for name, t in metrics.items():
                    nbytes = t.numel() * t.element_size()
                    layout.append((name, offset, nbytes, t.dtype, tuple(t.shape)))
                    offset += -(-nbytes // 8) * 8
                packed_metrics = torch.empty(offset, dtype=torch.uint8, device=video.device)
                for (_, off, nbytes, dtype, shape), t in zip(layout, metrics.values()):
                    packed_metrics[off:off + nbytes].view(dtype).view(shape).copy_(t)
            pool_bytes = torch.cuda.memory_reserved(video.device) - reserved
            launches = {name: n - counts[name] for name, n in ops.launch_counts().items()}
        finally:
            _set_counts(counts)
        return _Graph(graph, video, labels, packed_metrics, layout, launches, pool_bytes,
                      time.perf_counter() - t0)


def _set_counts(counts: Dict[str, int]) -> None:
    for name, fn in ops.kernel_wrappers():
        fn.launches = counts[name]

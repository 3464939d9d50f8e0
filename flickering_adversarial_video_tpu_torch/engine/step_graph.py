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
* **One graph a (clip shape, clip dtype, packed?, labels shape, kind)**,
  cached on the engine's ``StepGraphs``: the last short batch of a universal
  epoch, a single-video clip and a fused-kernel batch each key their own,
  and ``train_eval_step`` (kind ``"train_eval"``: the step and its fooling
  counters) has graphs of its own beside ``train_step``'s (``"train"``),
  over the same static state.  Each graph
  has its own memory pool, freed with the engine; ``stats`` gives what its
  capture reserved and how long the warm-up and capture took.
* **Metrics** are written inside the graph into one packed byte buffer, and
  copied out after the replay in one copy, so that the returned metrics do
  not alias the next replay's.
* **Collectives.**  With a mesh (``parallel/mesh.py``) the step's one
  all-reduce is captured with the rest, which NCCL allows once its
  communicator exists: the warm-up's steps make the first collective, before
  the capture, and every replay runs it again.  A gloo group cannot be
  captured; the engine refuses it on the card unless asked for eager steps.
* **Launch counts.**  The ``ops`` wrappers count on the host.  A capture
  counts its launches once (the warm-up's are taken back), and each replay
  adds them.
* **No fallback.**  A capture or a replay that fails raises.  The CPU runs the
  eager step (``AttackEngine._train_step``) because it is the CPU; on the
  card that eager step is only the reference the graph is held to.
* **Span.**  Each graph's warm-up and capture is one ``step_graph/capture``
  span in a torch.profiler trace (``SPANS``).

:class:`SlotGraph` is the vectorized sweep's counterpart of the JAX sweep's
``jax.jit(lax.scan(body), donate)`` (``engine/vector_sweep.py:105,
231-292``): one iteration of the slot loop (the stop rules' bookkeeping as
masked tensor arithmetic, the slot step, the state written back in place, the
iteration's outputs written into row ``row`` of ``[chunk, N, ...]`` buffers
and ``row`` advanced) is captured once and replayed ``chunk`` times a chunk;
the host reads the buffers once a chunk.  One iteration is captured, not a
graph of ``chunk`` iterations (~1,740 launches each): its capture costs what
a train step's does, whatever the chunk.  The state, the clips, labels and
seeds are its static tensors, donated as the train step's are: the sweep
refills and parks slots by writing into them in place between chunks, and
the graph is never captured again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from .. import ops

WARMUP_STEPS = 2  # eager steps on a side stream before a capture
CAPTURE_SPAN = "step_graph/capture"
SPANS = (CAPTURE_SPAN,)


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
            labels: torch.Tensor, n: int, with_metrics: bool, kind: str = "train"):
        """n replays of the step graph of this batch's key and `kind` from
        `state`: (the new state, holding the static tensors; the last step's
        metrics or None).  `step_fn(delta, mu, nu, step, video, packed,
        labels)` is the engine's step body of that kind, on tensors."""
        key = (tuple(video.shape), video.dtype, packed, tuple(labels.shape), kind)
        self._load(state)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(step_fn, video, packed, labels)
        if video.data_ptr() != entry.video.data_ptr():
            entry.video.copy_(video)
        entry.labels.copy_(labels)
        for _ in range(n):
            entry.graph.replay()
        ops.add_launch_counts(entry.launches, n)
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

        def capture():
            metrics = step()
            layout, offset = [], 0
            for name, t in metrics.items():
                nbytes = t.numel() * t.element_size()
                layout.append((name, offset, nbytes, t.dtype, tuple(t.shape)))
                offset += -(-nbytes // 8) * 8
            packed_metrics = torch.empty(offset, dtype=torch.uint8, device=video.device)
            for (_, off, nbytes, dtype, shape), t in zip(layout, metrics.values()):
                packed_metrics[off:off + nbytes].view(dtype).view(shape).copy_(t)
            return packed_metrics, layout

        graph, (packed_metrics, layout), launches, pool_bytes = _capture(
            step, capture, static, video.device)
        return _Graph(graph, video, labels, packed_metrics, layout, launches, pool_bytes,
                      time.perf_counter() - t0)


def _capture(warm_up: Callable, capture: Callable, static, device: torch.device,
             prepare: Optional[Callable] = None):
    """Run `warm_up` WARMUP_STEPS times on a side stream, put the `static`
    tensors it updates in place back as they were, call `prepare` (outside
    the graph), and capture `capture` into a new graph: (the graph, what
    `capture` returned, the kernel launches a replay makes by wrapper name,
    the pool bytes the capture reserved).  The wrappers' counts are left as
    they were."""
    with record_function(CAPTURE_SPAN):
        saved = [t.clone() for t in static]
        counts = ops.launch_counts()
        try:
            # warm-up on a side stream: cuDNN's plans, the kernels' first-launch
            # set-up (shared-memory limits, occupancy), autograd's threads
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    warm_up()
            torch.cuda.current_stream().wait_stream(side)
            for dst, src in zip(static, saved):
                dst.copy_(src)
            ops.set_launch_counts(counts)
            if prepare is not None:
                prepare()

            graph = torch.cuda.CUDAGraph()
            # torch.cuda.graph empties the allocator's cache as it enters: empty
            # it first, so that the growth of the reserved memory is the graph's
            # pool
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            # thread_local: a runner's producer thread pins and copies the next
            # batch meanwhile, on the default stream
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = capture()
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
            launches = {name: n - counts[name] for name, n in ops.launch_counts().items()}
        finally:
            ops.set_launch_counts(counts)
    return graph, out, launches, pool_bytes


class SlotGraph:
    """The vectorized sweep's slot loop as one captured iteration.

    ``iterate(*static)`` is one iteration on the static tensors (the state
    and the inputs, which it updates in place), returning its outputs ({name:
    [N, ...] tensor}).  It is captured when the graph is made, with output
    buffers of ``chunk`` rows; :meth:`run` copies a given tensor that is not
    the static one into it, and replays."""

    def __init__(self, iterate: Callable, static: Tuple[torch.Tensor, ...], chunk: int):
        t0 = time.perf_counter()
        self.static, self.chunk = tuple(static), chunk
        device = static[0].device
        self.row = torch.zeros(1, dtype=torch.int64, device=device)
        self.out: Dict[str, torch.Tensor] = {}
        kinds = {}

        def warm_up():
            kinds.update((name, (tuple(v.shape), v.dtype))
                         for name, v in iterate(*self.static).items())

        # the output buffers lie outside the graph's pool: a block the
        # capture frees (an iteration's temporaries) is written again by
        # every replay, which would overwrite the rows before it
        def allocate():
            self.out = {name: torch.empty((chunk,) + shape, dtype=dtype, device=device)
                        for name, (shape, dtype) in kinds.items()}

        def capture():
            for name, v in iterate(*self.static).items():
                self.out[name].index_copy_(0, self.row, v.unsqueeze(0))
            self.row.add_(1)

        self.graph, _, self.launches, self.pool_bytes = _capture(
            warm_up, capture, self.static + (self.row,), device, allocate)
        self.capture_s = time.perf_counter() - t0

    def run(self, given: Tuple[torch.Tensor, ...], n: int) -> Dict[str, torch.Tensor]:
        """n replays from the state and inputs `given` (copied into the static
        tensors where they are others): the outputs' first n rows (views of
        the graph's buffers, which the next run overwrites)."""
        if n > self.chunk:
            raise ValueError(f"a run of {n} iterations exceeds the graph's {self.chunk} rows")
        for static, t in zip(self.static, given):
            if t is not static:
                static.copy_(t)
        self.row.zero_()
        for _ in range(n):
            self.graph.replay()
        ops.add_launch_counts(self.launches, n)
        return {name: buf[:n] for name, buf in self.out.items()}

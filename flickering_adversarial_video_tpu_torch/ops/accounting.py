"""Analytic FLOP/byte accounting of the port's kernel launches.

The port's own copy of the JAX package's ``ops/accounting.py``: ``Tally``,
``record`` and ``recording``.  Every kernel wrapper of the port
(``ops.kernel_wrappers``) calls ``record(tag, flops, bytes)`` once for each
launch it makes on a CUDA tensor, and once for each launch it stands in for
when it runs its plain version on a CPU tensor, so a tally reads the same
work whatever computes it.  The tags are the kernel table's names: "B1",
"B2", "B3", "B4", "B5", "B6", "B7", "B7c" (B7 with a dl a clip), "B8f",
"B8b", "B8cf", "B8cb" (B8 with a delta a clip), "B9f", "B9b", "B12f",
"B12b" (the video ResNets' batch-norm epilogue).

* Bytes are the port's own definition, the one PERF.md's bound column uses:
  each input read once, each output written once.  The JAX tally counts the
  TPU's block fetches (halos included) instead, so the two packages' byte
  counts are not compared.
* FLOPs: B1 counts 2*M*N*K of its product, M the outputs, N the 64 output
  channels and K the input taps that land inside the clip (24 channels a
  tap; a tap on the zero padding adds nothing), per launch (a column
  segment's halo columns included).  The pools, the combine and the
  elementwise kernels record 0: their compares, maxes and adds are VPU-class
  work that the bound column counts by bytes.

Recording happens when Python calls the wrapper: an eager step and a CUDA
graph's capture record, a graph's replay does not (the counterpart of JAX's
trace time; the wrappers' launch counts are added a replay by the graph
runner instead).
"""

from __future__ import annotations

from contextlib import contextmanager

_active: list["Tally"] = []


class Tally:
    """Accumulated analytic cost of every kernel launch recorded while active."""

    def __init__(self):
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.calls: list[tuple[str, float, float]] = []

    def add(self, tag: str, flops: float, hbm_bytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += hbm_bytes
        self.calls.append((tag, flops, hbm_bytes))

    def counts(self) -> dict:
        """Calls by tag."""
        out: dict = {}
        for tag, _, _ in self.calls:
            out[tag] = out.get(tag, 0) + 1
        return out


def record(tag: str, flops: float = 0.0, hbm_bytes: float = 0.0) -> None:
    """Called by kernel wrappers (a no-op unless a `recording()` context is
    active, so the hot path never pays)."""
    for t in _active:
        t.add(tag, float(flops), float(hbm_bytes))


@contextmanager
def recording():
    """Collect `record()` calls made under this context."""
    t = Tally()
    _active.append(t)
    try:
        yield t
    finally:
        _active.remove(t)


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)

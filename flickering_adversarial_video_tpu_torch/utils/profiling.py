"""Profiling hooks (SURVEY.md section 5.1: the reference's only profiler is a
commented-out ProfilerHook; here tracing is first-class).

The port's own copy of the JAX package's ``utils/profiling.py`` trace, on
``torch.profiler``; the port names its sections with ``record_function``
spans (``engine/loops.py``, ``engine/vector_sweep.py``,
``engine/step_graph.py``), which the trace shows, and has no section timer.
Usage:

    with trace_steps("/tmp/trace"):
        for _ in range(20):
            state, m = engine.train_step(...)
    # then: tensorboard --logdir /tmp/trace  (profile plugin), or open the
    # chrome trace (trace.json) in chrome://tracing / Perfetto
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


@contextlib.contextmanager
def trace_steps(log_dir: str, device=None) -> Iterator[None]:
    """torch.profiler trace around a block of device work, written to
    ``<log_dir>/trace.json`` (a chrome trace).  Traces the card (CPU and CUDA
    activities) unless ``device="cpu"`` is given (CPU activity only);
    without CUDA it raises, as the entry points do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

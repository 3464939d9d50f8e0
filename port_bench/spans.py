"""The device's idle time inside the program's spans, and a traced run of a
cell that prints it.

    python3 -m port_bench.spans --workload <cell> --seed <n> [--seconds <s>]

runs the cell as ``python3 -m port_bench.run ... --trace 1`` does, and
prints one more JSON line after the result line.  It holds ``spans`` (see
:func:`read`), the program's sweep counts over the traced window
(``vector_sweep.sweep_counts``), and the window's idle time split into
what falls inside each ``vector_sweep/call`` and what falls outside it (the
harness's own work around the call).  :func:`read` is what the record of
``trace.read`` would hold as its ``spans``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

from . import run, trace

CALL = "vector_sweep/call"
# the idle time of gaps shorter than this (microseconds) is also given apart:
# the bubbles between the kernels of a graph replay, which no host work fits
BUBBLE_US = 10.0


def program_spans() -> Tuple[str, ...]:
    """The names of the program's span tuples (none in a program that has
    none)."""
    from flickering_adversarial_video_tpu_torch.engine import step_graph, vector_sweep

    return tuple(getattr(vector_sweep, "SPANS", ())) + tuple(getattr(step_graph, "SPANS", ()))


def _window_gaps(prof):
    """(the profile's events, the window span, the window's gaps between the
    device's busy intervals (kernels and copies), as ``trace.read`` takes
    them, in microseconds)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    window = [e for e in events if e.device_type == DeviceType.CPU and e.name == trace.WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    busy = trace._merge([
        (max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.name not in cpu_names and e.time_range.end > w0 and e.time_range.start < w1])
    gaps, last = [], w0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if last < w1:
        gaps.append((last, w1))
    return events, window[0], gaps


def _idle_in(gaps: List[Tuple[float, float]], ends: List[float], a: float,
             b: float) -> Tuple[float, float]:
    """The part of [a, b] that the sorted, disjoint `gaps` cover (`ends`
    their ends), and the part of it in gaps shorter than BUBBLE_US."""
    total = bubbles = 0.0
    for g0, g1 in gaps[bisect.bisect_right(ends, a):]:
        if g0 >= b:
            break
        part = min(b, g1) - max(a, g0)
        total += part
        if g1 - g0 < BUBBLE_US:
            bubbles += part
    return total, bubbles


def read(prof, names: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """For each of `names` (the program's span names by default) that the
    window's thread shows: {"n": its spans, "host_s": their seconds, clipped
    to the window, "idle_s": the device's idle seconds inside them,
    "bubble_s": the part of idle_s in gaps shorter than BUBBLE_US}.  A span
    nested in another is counted in both."""
    from torch.autograd import DeviceType

    names = set(program_spans() if names is None else names)
    events, window, gaps = _window_gaps(prof)
    w0, w1 = window.time_range.start, window.time_range.end
    ends = [g1 for _, g1 in gaps]
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.device_type != DeviceType.CPU or e.thread != window.thread or e.name not in names:
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        s = out.setdefault(e.name, {"n": 0, "host_s": 0.0, "idle_s": 0.0, "bubble_s": 0.0})
        idle, bubbles = _idle_in(gaps, ends, a, b)
        s["n"] += 1
        s["host_s"] += (b - a) / 1e6
        s["idle_s"] += idle / 1e6
        s["bubble_s"] += bubbles / 1e6
    return out


def gap_lengths(prof, edges=(2, 5, BUBBLE_US, 50, 100, 1000)) -> List[List[float]]:
    """The window's idle gaps by length: [upper edge in us (None: the rest),
    how many, their ms]."""
    _, _, gaps = _window_gaps(prof)
    bins = [[e, 0, 0.0] for e in edges] + [[None, 0, 0.0]]
    for g0, g1 in gaps:
        b = next(b for b in bins if b[0] is None or g1 - g0 < b[0])
        b[1] += 1
        b[2] += (g1 - g0) / 1e3
    return bins


def summary(rec: Dict, spans: Dict[str, Dict[str, float]], counts: Dict[str, int]) -> Dict:
    """The split of a traced sweep window's idle time by span: per call (the
    clean checks, the fills, the capture, the results), per chunk (the read
    and the history), during the replays (the chunks less the capture),
    inside the call but in no child span, and outside the call; each in ms."""
    idle = {name: s["idle_s"] * 1e3 for name, s in spans.items()}

    def of(*names):
        return sum(idle.get("vector_sweep/" + n, 0.0) for n in names)

    call = idle.get(CALL, 0.0)
    children = of("candidate", "refill", "chunk", "read", "history", "result")
    chunks = counts.get("chunks") or 0
    return {
        "window_idle_ms": (rec["window_s"] - rec["busy_s"]) * 1e3,
        "call_idle_ms": call,
        "outside_call_idle_ms": (rec["window_s"] - rec["busy_s"]) * 1e3 - call,
        "children_share_of_call_idle": children / call if call else None,
        "per_call_idle_ms": of("candidate", "refill", "result") + idle.get("step_graph/capture", 0.0),
        "per_chunk_idle_ms": of("read", "history") / chunks if chunks else None,
        "replays_idle_ms": of("chunk") - idle.get("step_graph/capture", 0.0),
        "in_call_outside_children_ms": call - children,
    }


def main(argv=None, **run_kw) -> int:
    """One traced run of a cell with the spans line; `run_kw` go to
    ``run.main`` (the harness's CPU tests' device, root and overrides)."""
    from flickering_adversarial_video_tpu_torch.engine import vector_sweep

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args(argv)
    counts = getattr(vector_sweep, "sweep_counts", dict)
    traced, read_record = trace.traced, trace.read
    seen: Dict = {}

    def counted(window, *a, **kw):
        def window_counted():
            before = counts()
            out = window()
            seen["counts"] = {k: v - before[k] for k, v in counts().items()}
            return out

        return traced(window_counted, *a, **kw)

    def read_with_spans(prof, *a, **kw):
        rec = read_record(prof, *a, **kw)
        seen["spans"], seen["rec"], seen["gaps"] = read(prof), rec, gap_lengths(prof)
        return rec

    with mock.patch.object(trace, "traced", counted), \
            mock.patch.object(trace, "read", read_with_spans):
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                       str(args.seconds), "--trace", "1"], **run_kw)
    if "rec" in seen:
        counts_seen = seen.get("counts", {})
        print(json.dumps({"workload": args.workload, "seed": args.seed, "spans": seen["spans"],
                          "counts": counts_seen, "gap_lengths": seen["gaps"],
                          "idle": summary(seen["rec"], seen["spans"], counts_seen)}))
    return rc


if __name__ == "__main__":
    sys.exit(main())

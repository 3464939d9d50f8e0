"""The traced window: torch.profiler over it, read into one record.

The record holds what the per-layer metrics read: the window's length, the
union of the device's busy intervals (kernels and copies), kernel time by
group (the port's kernels by tag, cuDNN/cuBLAS, everything else), the
host-to-device copies, the longest device operations, and the longest idle
gaps named by what the host was doing.  A kernel is the port's when its name
holds a symbol of a tag file ``port_bench/kernels/<tag>.json``; a port
kernel (a name of ``ops.kernels.KERNEL_SYMBOLS``) that no tag file claims
fails the run.

The profiler drops a kernel event now and then.  A graph replay's kernels
share the correlation id of its ``cudaGraphLaunch``, so every replay of one
graph shows the same number of kernels; a replay that shows fewer, or a port
tag whose traced launches fall short of the wrappers' host counts, marks the
trace as dropped, and :func:`traced` traces the window again.
"""

from __future__ import annotations

import json
import re
import sys
from collections import Counter, defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

HERE = Path(__file__).resolve().parent
LIBRARY_MARKS = ("cudnn", "cublas", "xmma", "gemm", "cutlass", "sm90_", "sm80_", "dgrad",
                 "wgrad", "implicit_convolve", "conv2d", "conv3d")
WINDOW_SPAN = "port_bench/window"
TOP = 10


def tag_symbols() -> Dict[str, Tuple[str, ...]]:
    """Each kernel tag's trace symbols, from ``kernels/<tag>.json``."""
    return {p.stem: tuple(json.loads(p.read_text())["symbols"])
            for p in sorted((HERE / "kernels").glob("*.json"))}


def _matcher(symbols):
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, symbols)) + r")(?![A-Za-z0-9_])")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Dropped(Exception):
    """The profiler lost events of the window."""


def read(prof, program_symbols: Dict[str, tuple], host_launches: Dict[str, int]) -> Dict:
    """The record of one profiled window (times in seconds)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    window = [e for e in cpu if e.name == WINDOW_SPAN]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    main_thread = window[0].thread
    cpu_names = {e.name for e in cpu}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in cpu_names
              and e.time_range.end > w0 and e.time_range.start < w1]

    tags = tag_symbols()
    by_symbol = {s: tag for tag, syms in tags.items() for s in syms}
    claimed = _matcher(by_symbol)
    port_all = _matcher([s for syms in program_symbols.values() for s in syms])
    library = re.compile("|".join(map(re.escape, LIBRARY_MARKS)), re.IGNORECASE)

    group_s: Dict[str, float] = defaultdict(float)
    tag_s: Dict[str, float] = defaultdict(float)
    tag_kernels: Counter = Counter()
    op_s: Dict[str, float] = defaultdict(float)
    unclaimed = set()
    h2d_s = 0.0
    intervals = []
    for e in device:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        dur = (b - a) / 1e6
        intervals.append((a, b))
        op_s[e.name] += dur
        if e.name.startswith(("Memcpy", "Memset")):
            if e.name.startswith("Memcpy HtoD"):
                h2d_s += dur
            continue
        m = claimed.search(e.name)
        if m:
            tag = by_symbol[m.group(1)]
            group_s["port"] += dur
            tag_s[tag] += dur
            tag_kernels[m.group(1)] += 1
        elif port_all.search(e.name):
            unclaimed.add(port_all.search(e.name).group(1))
        elif library.search(e.name):
            group_s["library"] += dur
        else:
            group_s["aten"] += dur
    if unclaimed:
        raise RuntimeError(f"port kernels that no kernels/<tag>.json claims: {sorted(unclaimed)}")

    _check_dropped(cpu, device, tags, tag_kernels, host_launches)

    busy = _merge(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, last = [], w0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if last < w1:
        gaps.append((last, w1))
    instantiated = [e.time_range.end for e in cpu if "GraphInstantiate" in e.name]
    after = max(instantiated) if instantiated else w0
    idle_after_s = sum(min(b, w1) - max(a, after) for a, b in gaps if b > after) / 1e6
    main = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if e.thread == main_thread and e.name != WINDOW_SPAN)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "idle_after_capture_s": idle_after_s,
        "group_s": dict(group_s),
        "tag_s": dict(tag_s),
        "h2d_s": h2d_s,
        "device_ops": sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [[_host_at(main, a), (b - a) / 1e6] for a, b in longest],
    }


def _host_at(main, t: float) -> str:
    """The innermost host span of the main thread running at time t."""
    best = None
    for a, b, name in main:
        if a > t:
            break
        if b >= t:
            best = name
    return best or "host, outside any traced op"


def _check_dropped(cpu, device, tags, tag_kernels: Counter, host_launches: Dict[str, int]):
    launches = {e.id for e in cpu if "GraphLaunch" in e.name}
    per_launch = Counter(e.id for e in device if e.id in launches)
    if launches and per_launch:
        want = max(per_launch.values())
        short = [i for i in launches if per_launch.get(i, 0) < want]
        if short:
            raise Dropped(f"{len(short)} of {len(launches)} graph replays show fewer than "
                          f"{want} device events")
    elif launches:
        print("[trace] graph replays carry no correlated kernels: replay check skipped",
              file=sys.stderr)
    for tag, syms in tags.items():
        # a launch starts one of a tag's kernels, or each of them in turn
        traced = sum(tag_kernels[s] for s in syms)
        if traced < host_launches.get(tag, 0):
            raise Dropped(f"{tag}: {traced} kernels traced against {host_launches[tag]} launched")


def traced(window: Callable[[], Dict], program_symbols: Dict[str, tuple],
           launch_counts: Callable[[], Dict[str, int]], attempts: int = 3):
    """Run `window` under the profiler until a trace comes back whole:
    (window's result, the record)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for attempt in range(attempts):
        before = launch_counts()
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                out = window()
                if cuda:
                    torch.cuda.synchronize()
        after = launch_counts()
        host = {k: after[k] - before.get(k, 0) for k in after}
        try:
            return out, read(prof, program_symbols, host)
        except Dropped as e:
            print(f"[trace] attempt {attempt + 1}: {e}", file=sys.stderr)
    raise RuntimeError(f"the profiler dropped events in {attempts} traces of the window")

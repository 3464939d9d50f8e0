"""Cells at a tiny size, run through the harness on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CLIPS = {
    "i3d_k400": {"universal": {"frames": 8, "size": 64, "dtype": "uint8"},
                 "sweep": {"frames": 8, "size": 64, "dtype": "float32"}},
    "r2plus1d_18_k400": {"universal": {"frames": 4, "size": 32, "dtype": "uint8"},
                         "sweep": {"frames": 4, "size": 32, "dtype": "uint8"}},
}
TRAFFIC = {"batch": 2, "pool_batches": 3, "epoch_batches": 4, "slots": 2, "chunk": 8,
           "chunk_seconds": 1000.0, "trace_steps": 2, "trace_chunks": 1}


def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def overrides(cell: str):
    return {"clips": CLIPS[cell.split(".")[0]], **TRAFFIC}


def run(cell: str, seed: int = 2147483659, seconds: float = 0.5):
    """(exit code, the result line as a dict or None) of a tiny CPU run."""
    import torch

    from port_bench import run as bench_run

    torch.manual_seed(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", "0"], device="cpu", root=ROOT, overrides=overrides(cell))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)

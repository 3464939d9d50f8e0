"""Each cell, briefly, on the card: a run of a few seconds exits 0 with
``correct`` true and the per-layer metrics of a traced run.  Marked
``cuda``; without a card each test skips."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from port_bench.tests import bench_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", bench_tiny.cells())
def test_a_short_run_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed", "2147483701",
         "--seconds", "2", "--trace", str(trace)],
        cwd=bench_tiny.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "mfu_pct" in line["metrics"] and len(line["breakdown"]["device_ops"]) <= 10

"""Nothing the benchmark's command loads is JAX or the JAX package, and the
plain reference loads nothing of the port either.  Top-level module names
are compared whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "flickering_adversarial_video_tpu"}
PORT = "flickering_adversarial_video_tpu_torch"


def _loaded(code: str):
    """The top-level names of the modules a fresh interpreter holds after
    running `code`."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_tiny_run_loads_no_jax():
    code = ("from port_bench.tests import bench_tiny\n"
            "rc, line = bench_tiny.run(bench_tiny.cells()[0])\n"
            "assert rc == 0 and line is not None\n")
    loaded = _loaded(code)
    assert PORT in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import port_bench.reference.attack, port_bench.reference.i3d, "
                     "port_bench.reference.video_resnet, port_bench.reference.precision")
    assert not loaded & (FORBIDDEN | {PORT})


def test_no_source_names_jax():
    for path in (ROOT / "port_bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
                if path.parent.name == "reference":
                    assert name.split(".")[0] != PORT, (path, name)

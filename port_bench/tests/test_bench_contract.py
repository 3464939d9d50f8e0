"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix and metric resolved to the files of its own."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
RAW = (ROOT / "BENCHMARK.json").read_text()
BENCH = json.loads(RAW)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                   r"experts_per_tok|width|channels|planes)")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(RAW.encode()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
            assert key in body["assumed"]


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_metrics():
    names = [m["name"] for m in _metrics()]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:  # every cell reports set-up, another end-to-end metric and a per-layer one
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_resolves_to_its_files(cell):
    from port_bench.run import load_cell

    _, w, cfg, traffic = load_cell(ROOT, cell)
    importlib.import_module(f"port_bench.mixes.{traffic['mix']}").run
    importlib.import_module(f"port_bench.reference.{cfg['reference']}").logits
    work = importlib.import_module(f"port_bench.work.{cfg['model']}")
    assert work.clip_step_flops and work.step_launches
    assert cfg["clips"][traffic["mix"]]
    limits = json.loads((ROOT / "port_bench" / "limits" / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert callable(importlib.import_module(f"port_bench.metrics.{m['name']}").read)


def test_kernel_tags_name_the_ports_kernels():
    from flickering_adversarial_video_tpu_torch.ops import kernels

    from port_bench import trace

    program = {s for syms in kernels.KERNEL_SYMBOLS.values() for s in syms}
    claimed = [s for syms in trace.tag_symbols().values() for s in syms]
    assert len(set(claimed)) == len(claimed) and set(claimed) == program

"""The control of ``correct`` and the gradient-only half batch, at a tiny
size on every cell: the plain reference put in the program's place at fp8,
the precision below the configuration's bfloat16, reads incorrect, and so
does the f32 reference whose gradient comes from half of each batch (half of
the slots) while its forward stays whole, in the cells that compare a
gradient number (on the card both are read at each cell's own size by
``python -m port_bench.control``)."""

from __future__ import annotations

import pytest

from port_bench import check, control
from port_bench.run import Context, load_cell
from port_bench.tests import bench_tiny


@pytest.mark.parametrize("cell", bench_tiny.cells())
def test_the_fp8_control_reads_incorrect(cell):
    _, w, cfg, traffic = load_cell(bench_tiny.ROOT, cell)
    over = bench_tiny.overrides(cell)
    cfg["clips"] = over.pop("clips")
    traffic.update(over)
    limits = check.limits(cell)
    for seed in (3, 4):
        ctx = Context(w, cfg, traffic, seed, 0, False, "cpu")
        weights, labelled = control.inputs(ctx)
        nums = control.numbers(ctx, weights, labelled, ["fp8", "bf16", "half_batch"])
        compared = {k: v for k, v in limits.items() if k in nums["fp8"]}
        assert compared
        assert not check.judge(nums["fp8"], compared)
        if any(k.startswith(("clip_weight_err", "first_step_err")) for k in compared):
            assert not check.judge(nums["half_batch"], compared)
        # the same precision as the program's reads far closer
        logit = next(k for k in compared if "logit" in k)
        assert nums["bf16"][logit] < nums["fp8"][logit] / 3

"""The frozen work counts of ``port_bench/work`` against the port.

The kernel work: ``work.<model>.step_launches`` at each cell's shapes
against ``ops.accounting``'s tally of one eager step of the port at the
same shapes, launch by launch and tag by tag.  The model FLOPs:
``work.<model>.forward_macs`` against the multiply-adds of every conv and
linear layer the port's victim runs, counted from its modules' weights and
outputs.  Both run on meta tensors, so the cells' full shapes cost no
memory; the port's plain versions stand in for its kernels.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from port_bench.work import i3d as work_i3d
from port_bench.work import r2plus1d_18 as work_r21d

ROOT = Path(__file__).resolve().parents[2]


def _cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in bench["configs"]}
    for w in bench["workloads"]:
        traffic = json.loads((ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        yield w["name"], configs[w["config"]], traffic


CELLS = sorted(_cells(), key=lambda c: c[0])


def _tally(cfg, traffic):
    """The tally of one eager step of the cell's engine on meta tensors."""
    from flickering_adversarial_video_tpu_torch.attack import FlickerSpec, TorchStyleFlickerSpec
    from flickering_adversarial_video_tpu_torch.engine import (
        AttackConfig, AttackEngine, AttackState, RuntimeFlags)
    from flickering_adversarial_video_tpu_torch.models.registry import create_model
    from flickering_adversarial_video_tpu_torch.ops import accounting

    geo = cfg["clips"][traffic["mix"]]
    t, s = geo["frames"], geo["size"]
    n = traffic["batch"] if traffic["mix"] == "universal" else traffic["slots"]
    model, _ = create_model(cfg["model"], cfg["num_classes"], torch.bfloat16, device="meta")
    if cfg["world"] == "tanh":
        spec, config = FlickerSpec(t), AttackConfig()
    else:
        spec = TorchStyleFlickerSpec(t)
        config = AttackConfig(norm_world="meanstd", reg_weighting="torch")
    engine = AttackEngine(model, spec, config, track_probs=True)
    dtype = torch.uint8 if geo["dtype"] == "uint8" else torch.float32
    video = torch.empty((n, t, s, s, 3), dtype=dtype, device="meta")
    labels = torch.zeros(n, dtype=torch.long, device="meta")
    zeros = torch.zeros(spec.shape, device="meta")
    with accounting.recording() as tally:
        if traffic["mix"] == "universal":
            engine._train_step(AttackState(zeros, zeros, zeros, 0),
                               *engine.prepare_batch({"video": video, "labels": labels}),
                               RuntimeFlags())
        else:
            d = torch.zeros((n,) + tuple(spec.shape), device="meta")
            clips, packed, _ = engine.prepare_batch({"video": video, "labels": labels})
            engine._slot_step(d, d, d, torch.zeros(n, dtype=torch.int32, device="meta"), clips,
                              packed, labels, engine._step_scalars(RuntimeFlags()),
                              torch.ones(n, device="meta"),
                              torch.zeros(n, dtype=torch.int64, device="meta"),
                              torch.ones(n, dtype=torch.bool, device="meta"))
    return tally


@pytest.mark.parametrize("name,cfg,traffic", CELLS, ids=[c[0] for c in CELLS])
def test_kernel_work_matches_the_ports_tally(name, cfg, traffic):
    work = work_i3d if cfg["model"] == "i3d" else work_r21d
    geo = cfg["clips"][traffic["mix"]]
    n = traffic["batch"] if traffic["mix"] == "universal" else traffic["slots"]
    head = "float" if geo["dtype"] == "float32" else "packed_u8"
    frozen = work.step_launches(n, geo["frames"], geo["size"], geo["size"], head)
    tally = _tally(cfg, traffic)
    # B7 with a delta a clip (B7c) is B7's kernel; the frozen counts name it B7
    got = [("B7" if tag == "B7c" else tag, f, b) for tag, f, b in tally.calls]
    assert sorted(t for t, _, _ in frozen) == sorted(t for t, _, _ in got)
    want_sum, got_sum = defaultdict(lambda: [0.0, 0.0]), defaultdict(lambda: [0.0, 0.0])
    for tag, f, b in frozen:
        want_sum[tag][0] += f
        want_sum[tag][1] += b
    for tag, f, b in got:
        got_sum[tag][0] += f
        got_sum[tag][1] += b
    for tag in want_sum:
        for w, g in zip(want_sum[tag], got_sum[tag]):
            assert math.isclose(w, g, rel_tol=1e-3), (tag, w, g)


def _counted_macs(cfg, geo):
    """Multiply-adds of the port's victim forward at the clip's shape: each
    conv or linear module's output elements times its weight's fan-in."""
    from flickering_adversarial_video_tpu_torch.models import i3d as port_i3d
    from flickering_adversarial_video_tpu_torch.models.registry import create_model

    t, s = geo["frames"], geo["size"]
    model, _ = create_model(cfg["model"], cfg["num_classes"], torch.bfloat16, device="meta")
    total = [0]

    def conv_hook(module, _, out):
        total[0] += out.numel() * math.prod(module.weight.shape[1:])

    for mod in model.modules():
        kind = type(mod).__name__
        if kind in ("Conv3d", "StemConv", "Unit3D", "Linear"):
            if kind == "Unit3D":
                mod.register_forward_hook(
                    lambda m, _, out: total.__setitem__(
                        0, total[0] + out.numel() * math.prod(m.conv_3d.weight.shape[1:])))
            elif kind != "Linear":
                mod.register_forward_hook(conv_hook)
    x = torch.empty((1, t, s, s, 3), device="meta")
    if cfg["model"] == "i3d":
        stem = model.Conv3d_1a_7x7.conv_3d.weight
        original = port_i3d.stem_bn_relu

        def counted(*args, **kw):
            y = original(*args, **kw)
            total[0] += y.numel() * math.prod(stem.shape[1:])
            return y

        port_i3d.stem_bn_relu = counted
        try:
            out = model(x)[0]
        finally:
            port_i3d.stem_bn_relu = original
        head = model.Logits["Conv3d_0c_1x1"].conv_3d.weight
        total[0] += (-(-t // 8) - 1) * math.prod(head.shape)
    else:
        out = model(x)
        total[0] += math.prod(model.fc.weight.shape)
    assert out.shape == (1, cfg["num_classes"])
    return total[0]


@pytest.mark.parametrize("name,cfg,traffic", CELLS, ids=[c[0] for c in CELLS])
def test_model_flops_match_the_ports_layers(name, cfg, traffic):
    work = work_i3d if cfg["model"] == "i3d" else work_r21d
    geo = cfg["clips"][traffic["mix"]]
    frozen = work.forward_macs(geo["frames"], geo["size"], geo["size"], cfg["num_classes"])
    assert frozen == _counted_macs(cfg, geo)
    assert work.clip_step_flops(geo["frames"], geo["size"], geo["size"]) == 4.0 * frozen


def test_published_sizes():
    # torchvision lists r2plus1d_18 at 40.52 G multiply-adds a 16x112x112 clip
    assert round(work_r21d.forward_macs(16, 112, 112) / 1e9, 2) == 40.52
    # the kernel table's bound column: 2.43 ms of port kernels a B=8 I3D step
    from port_bench.work.kernels import bound_s

    step = work_i3d.step_launches(8, 64, 224, 224, "packed_u8")
    assert math.isclose(sum(bound_s(f, b) for _, f, b in step), 2.429e-3, rel_tol=1e-3)

"""The control of ``correct`` and a planted fault, read at a cell's size.

    python -m port_bench.control --workload <cell> --seeds 1,2,3 [--variants fp8,bf16,half_batch]

For each seed it makes the cell's inputs with the cell's own ``inputs``
(``mixes/<mix>.py``: the seeded weights, the batches or the slots' clips,
labelled by the program's victim as a run labels them, the initial delta),
runs the f32 reference's checked steps, and reads the numbers of
``check.py`` for each variant put in the program's place:

* ``fp8`` / ``bf16``: the reference with its convolutions rounded to that
  precision (``reference/precision.py``); fp8 is the control, the nearest
  precision below the configuration's bfloat16;
* ``half_batch``: the f32 reference whose gradient comes from the first
  half of each batch alone, the mean taken over it (twice that half's
  hinge), while every clip's logits, loss and probabilities stay whole; in
  a sweep, the second half of the slots takes no gradient from its hinge.

One JSON line a seed and variant, and the largest reading of each number
over the seeds.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
from pathlib import Path
from typing import Dict, List

import torch

from . import check, program
from .reference import attack as ref_attack
from .run import Context, load_cell


def inputs(ctx: Context):
    """(f32 weights, the reference's checked runs) of the cell: its mix's
    own ``inputs``, labelled by the program's victim, then freed."""
    mix = importlib.import_module(f"port_bench.mixes.{ctx.traffic['mix']}")
    geo = ctx.cfg["clips"][ctx.traffic["mix"]]
    model, sd = program.victim(ctx.cfg, ctx.device, ctx.seed)
    engine = program.engine(ctx.cfg, ctx.traffic["attack"], model, geo["frames"])
    made = mix.inputs(ctx, engine, program.flags(ctx.traffic["attack"]))
    del engine, model
    ctx.free()
    return {k: v.float() for k, v in sd.items()}, mix.checked(ctx, made)


def numbers(ctx: Context, weights, labelled, variants: List[str]) -> Dict[str, Dict[str, float]]:
    cfg, traffic = ctx.cfg, ctx.traffic
    attack, world = traffic["attack"], cfg["world"]
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    block = traffic.get("ref_block", 1)
    rows: Dict[str, List] = {v: [] for v in variants}
    joint = {v: {"program": [], "reference": [], "clean_program": [], "clean_reference": []}
             for v in variants}
    for slot, (batches, d0) in enumerate(labelled):
        base = ref_attack.follow(lambda x: ref.logits(weights, x), world, batches, d0, attack, block)
        for v in variants:
            if v == "half_batch":
                n = len(batches[0][0])
                keep = n // 2 if traffic["mix"] == "universal" else (
                    0 if slot >= len(labelled) // 2 else None)
                got = ref_attack.follow(lambda x: ref.logits(weights, x), world, batches, d0,
                                        attack, block, grad_clips=keep)
            else:
                got = ref_attack.follow(lambda x, p=v: ref.logits(weights, x, p), world, batches, d0,
                                        attack, block)
            probs = [torch.softmax(z.double(), -1) for z in got["logits"]]
            grads = bases = None
            if traffic["mix"] == "universal":
                grads, f32 = got["grad"], (lambda x: ref.logits(weights, x))
                bases = [ref_attack.clip_basis(f32, world, video, labels, delta, attack,
                                               *ref_attack.hinge_branch(p, labels, attack["margin"]))
                         for (video, labels), delta, p in zip(batches, [d0] + got["delta"][:-1],
                                                                probs)]
            first = None
            if traffic["mix"] == "sweep":
                (video, labels), f32 = batches[0], (lambda x: ref.logits(weights, x))
                reg, (share,) = ref_attack.clip_basis(
                    f32, world, video, labels, d0, attack,
                    *ref_attack.hinge_branch(probs[0], labels, attack["margin"]))
                first = reg + share
            rows[v].append(check.steps_numbers(
                got["loss"], got["delta"][-1], d0, base, grads=grads, bases=bases,
                probs=list(zip(got["p_label"], got["p_other"])), step_probs=probs,
                delta_first=got["delta"][0], first_grad_ref=first))
            if traffic["mix"] == "sweep":
                video, _ = batches[0]
                j = joint[v]
                j["program"].append([p.cpu() for p in probs])
                j["reference"].append(base["logits"])
                with torch.no_grad():
                    clean = ref_attack.adversarial_clip(world, video, torch.zeros_like(d0),
                                                        attack.get("max_norm", 1.0))
                    j["clean_program"].append(
                        torch.softmax(ref.logits(weights, clean, v if v != "half_batch" else
                                                 "f32").double(), -1).cpu())
                    j["clean_reference"].append(ref.logits(weights, clean))
    if traffic["mix"] == "sweep":
        return {v: {**check.slots_numbers(r), **check.joint_logit_gaps(joint[v])}
                for v, r in rows.items()}
    return {v: check.worst(r) for v, r in rows.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="fp8,bf16")
    args = p.parse_args(argv)
    _, cell, cfg, traffic = load_cell(Path.cwd(), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    variants = args.variants.split(",")
    most: Dict[str, Dict[str, float]] = {}
    for seed in map(int, args.seeds.split(",")):
        ctx = Context(cell, cfg, traffic, seed, 0, False, device)
        weights, labelled = inputs(ctx)
        for v, nums in numbers(ctx, weights, labelled, variants).items():
            print(json.dumps({"workload": cell["name"], "seed": seed, "variant": v, **nums}),
                  flush=True)
            most[v] = {k: max(x, most.get(v, {}).get(k, 0.0)) for k, x in nums.items()}
    print(json.dumps({"workload": cell["name"], "largest": most}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's benchmark: one run of one cell.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration (``configs/<config>.json``: the model,
its input world, its clips and its seeded weights) and a traffic mix
(``traffic/<traffic>.json``: the mix driver ``mixes/<mix>.py`` and its
parameters).  The run builds the system under test from the seed, warms up
the cell's shapes (set-up), runs the window, and checks what the window's
path produced against the plain reference (``reference/``).  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py`` from
the traced window's record.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

A run needs as many CUDA cards as the cell asks for and exits 2 without
them.  It exits 3, with no result, when JAX or the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "flickering_adversarial_video_tpu")
NO_CARD, FORBIDDEN_LOADED = 2, 3


def process_age() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_cell(root: Path, workload: str):
    """(cell, configuration, traffic) of `workload` in root/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


class Context:
    """What a mix driver gets: the cell's data, the device and the
    harness's services (timing, tracing, the reference)."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device):
        import torch

        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.work = importlib.import_module(f"port_bench.work.{cfg['model']}")
        self.setup_s: Optional[float] = None
        self._phase_at = 0.0
        self.phase("interpreter, torch")

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase(self, name: str):
        """A part of set-up ends here: its seconds to standard error."""
        self.sync()
        now = process_age()
        print(f"[setup] {name} {now - self._phase_at:.2f} s", file=sys.stderr)
        self._phase_at = now

    def victim(self):
        """The victim with the seeded weights, after the port's kernels are
        built where the configuration runs them."""
        from . import program

        if self.device.type == "cuda" and self.work.step_launches(1, 2, 32, 32, "float"):
            program.build_kernels()
            self.phase("kernel build")
        out = program.victim(self.cfg, self.device, self.seed)
        self.phase("weights")
        return out

    def mark_setup(self):
        """Set-up ends here: the window starts."""
        self.phase("warm-up")
        self.setup_s = process_age()

    def traced(self, window):
        from . import program, trace

        return trace.traced(window, program.kernel_symbols(), program.launch_counts)

    def port_bounds(self, b: int, t: int, s: int, head: str, steps: int) -> Dict[str, float]:
        """Seconds of the port kernels' bounds over `steps` steps, by tag."""
        from .work.kernels import bound_s

        out: Dict[str, float] = {}
        for tag, flops, nbytes in self.work.step_launches(b, t, s, s, head):
            out[tag] = out.get(tag, 0.0) + steps * bound_s(flops, nbytes)
        return out

    @staticmethod
    def percentile(values, q: float) -> float:
        """The nearest-rank percentile."""
        v = sorted(values)
        return v[max(0, math.ceil(q / 100 * len(v)) - 1)]

    def peak_bytes(self) -> int:
        import torch

        self.sync()
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def free(self):
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def initial_delta(self, shape, attack, slot: Optional[int] = None):
        """The runner's initial delta: zeros in the tanh world; in the
        mean/std world U(-init_scale, init_scale) from a CPU generator seeded
        with the run's seed (the epoch fit) or with the slot's video index
        (the per-video sweep)."""
        import torch

        if self.cfg["world"] == "tanh":
            return torch.zeros(shape)
        g = torch.Generator().manual_seed(self.seed if slot is None else slot)
        return (torch.rand(shape, generator=g) * 2.0 - 1.0) * attack["init_scale"]

    def _reference(self, sd):
        """The plain reference's logits on `sd`, in f32 with TF32 off."""
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = importlib.import_module(f"port_bench.reference.{self.cfg['reference']}")
        weights = {k: v.float() for k, v in sd.items()}
        return lambda x: ref.logits(weights, x)

    def reference_steps(self, sd, batches, delta0, attack, block: int):
        """The plain reference's steps from delta0 over `batches`."""
        from .reference import attack as ref_attack

        return ref_attack.follow(self._reference(sd), self.cfg["world"], batches, delta0, attack,
                                 block)

    def reference_bases(self, sd, batches, deltas, step_probs, attack):
        """The reference's share of the gradient of each clip at each checked
        step (``reference.attack.clip_basis``): at the program's delta
        before the step, on the hinge branch of the program's probabilities
        there."""
        from .reference import attack as ref_attack

        logits_fn = self._reference(sd)
        out = []
        for (video, labels), delta, probs in zip(batches, deltas, step_probs):
            slope, rival = ref_attack.hinge_branch(probs, labels, attack["margin"])
            out.append(ref_attack.clip_basis(logits_fn, self.cfg["world"], video, labels,
                                             delta.to(video.device), attack, slope, rival))
        return out

    def reference_logits(self, sd, video, delta, attack):
        """The plain reference's logits of `video` perturbed by `delta`."""
        import torch

        from .reference import attack as ref_attack

        with torch.no_grad():
            adv = ref_attack.adversarial_clip(self.cfg["world"], video, delta.to(video.device),
                                              attack.get("max_norm", 1.0))
            return self._reference(sd)(adv)


def device_info(torch, device, count: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None, device: Optional[str] = None, root: Optional[Path] = None,
         overrides: Optional[Dict] = None) -> int:
    """One run.  `device`, `root` and `overrides` (configuration and
    traffic values by key) are for the harness's CPU tests; the command line
    runs on the card from the current directory."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd() if root is None else root
    bench, cell, cfg, traffic = load_cell(root, args.workload)
    for key, value in (overrides or {}).items():
        (cfg if key in cfg else traffic)[key] = value

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"the cell needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return NO_CARD
        device = "cuda:0"
    ctx = Context(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), device)
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    mix = importlib.import_module(f"port_bench.mixes.{traffic['mix']}")
    out = mix.run(ctx)

    if ctx.device.type == "cuda":
        print(f"[bench] {power_limit()}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return FORBIDDEN_LOADED

    from . import check

    lim = check.limits(cell["name"])
    correct = check.judge(out["numbers"], lim)
    report = check.report(out["numbers"], lim)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    dev = device_info(torch, ctx.device, cell["chips"])
    dev["memory_peak_bytes"] = out["peak_bytes"]
    if args.trace:
        rec = out["record"]
        rec["peak_bytes"] = out["peak_bytes"]
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = importlib.import_module(f"port_bench.metrics.{m['name']}").read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = {"device_ops": [list(kv) for kv in rec["device_ops"]],
                               "idle_gaps": rec["idle_gaps"]}
    else:
        values = dict(out["metrics"], setup_s=ctx.setup_s)
        metrics = {}
        for m in bench["end_to_end"]:
            if ("workloads" in m and cell["name"] not in m["workloads"]) or m["name"] not in values:
                continue
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=dev, check=report)
    print(f"[check] every number: {out['numbers']}", file=sys.stderr)
    for name, r in report.items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

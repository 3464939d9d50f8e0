"""The port's data parallelism over ranks (``parallel/mesh.py``) on the CPU:
two ranks in a real gloo group, held against the JAX package's 2-device
mesh (``AttackEngine(mesh=make_mesh(n_devices=2))``, the conftest's CPU
devices) and against the port in one process.

One module fixture spawns the group once (``torch.multiprocessing``, spawn,
a ``file://`` store under the test's temporary directory, one thread a rank)
and runs every case of it there; each rank saves what it measured, and the
tests read it.  The group is joined under its own time limit, so that a
hang fails the tests instead of eating the suite's clock.  This module's top
level imports no JAX: the spawned ranks import it; the tests import JAX
inside their bodies.

The engine cases (f32, the linear victim of the JAX package's
tests/test_engine.py: logits = the clip's mean colour times a [3, K]
matrix; B=8, 4 a rank, T=6, 8x8; each from a drawn delta, so that the
regularizers' gradient is of the adversarial one's size, but the sparse
delta from its spec's start, as the JAX package's mesh test: from a drawn
one, a component whose gradient nearly cancels moves 2.4e-6 apart between
the packages in one process already, under f32 reassociation; labels the
clean prediction, or the targets): the tanh hinge, CE untargeted and targeted,
the mean/std world with a one-cycle learning rate and max_norm escalating
between steps, the L1,2 sparse delta, and a tiny I3D (T=8, 16x16, 7
classes, B=4) on the packed head (the plain versions of B7 and B1-B6 under
the split).  Tolerances, the JAX package's own mesh tests'
(tests/test_engine.py:175-288): delta within 1e-6 absolute, total_loss
within 1e-5 relative; delta bit-equal across the ranks.  Also: the eval
counts summed over the ranks; the universal runner on three shards that
split unevenly over the ranks, against one process fed the ranks' batches
in rank order, and the same run over three ranks, whose batch of 4 splits
over two (the mesh shrinks as the JAX runners' does: rank 2 idle);
``--slots 4 --mesh`` of the per-video and single-video runners against one
process; the per-host shard split against the JAX reader's; the shrink to
one rank; the refusals.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import time
import traceback
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as multiprocessing

from flickering_adversarial_video_tpu_torch.attack import (
    FlickerSpec, SparseSpec, TorchStyleFlickerSpec)
from flickering_adversarial_video_tpu_torch.attack import perturbation as tpert
from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
from flickering_adversarial_video_tpu_torch.data import TFRecordWriter, make_uint8_example
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.data import video_dataset as tvd
from flickering_adversarial_video_tpu_torch.engine import (
    AttackConfig, AttackEngine, AttackState, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.engine import checkpoint as tckpt
from flickering_adversarial_video_tpu_torch.engine import loops as tloops
from flickering_adversarial_video_tpu_torch.engine.epoch_fit import one_cycle_lr
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.parallel import mesh as mesh_lib
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import single_video as tsingle
from flickering_adversarial_video_tpu_torch.runners import torch_per_video as tper_video
from flickering_adversarial_video_tpu_torch.runners import torch_universal as tuniversal_fit
from flickering_adversarial_video_tpu_torch.runners import universal as tuniversal
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils.labels import kinetics400_labels

W = 2                      # ranks
JOIN_S = 150               # the group's own time limit
B, T, S, K = 8, 6, 8, 5    # the linear cases' global batch
I3D_K, I3D_T, I3D_S, I3D_B = 7, 8, 16, 4
W_LIN = (np.random.default_rng(3).standard_normal((3, K)) * 2.0).astype(np.float32)
DELTA_TOL, LOSS_REL = 1e-6, 1e-5
METRICS = ("total_loss", "adv_loss", "prob_to_min", "prob_to_max", "is_adversarial")
# name -> (spec, AttackConfig keywords, RuntimeFlags keywords of each step)
MEANSTD_FLAGS = tuple(dict(learning_rate=one_cycle_lr(1e-3, i + 1, 4), max_norm=0.2 * 1.3 ** (i // 2))
                      for i in range(4))
CASES = {
    "hinge": ("flicker", {}, ({},) * 3),
    "ce": ("flicker", dict(improve_loss=False), ({},) * 3),
    "ce_targeted": ("flicker", dict(improve_loss=False, targeted=True), ({},) * 3),
    "meanstd": ("meanstd", dict(norm_world="meanstd", reg_weighting="torch"), MEANSTD_FLAGS),
    "sparse": ("sparse", dict(attack_kind="sparse"), (dict(beta1=0.5),) * 3),
    "i3d": ("i3d", {}, ({},) * 3),
}
# the runner: 3 shards of 4, 4 and 2 clips; rank 0 reads shards 0 and 2 (3
# batches of 2), rank 1 shard 1 (2 batches): an epoch is 2 steps
SHARD_SIZES, RUNNER_B, RUNNER_STEPS = (4, 4, 2), 4, 5
LABELS_400 = kinetics400_labels()
W400 = (np.random.default_rng(5).standard_normal((3, 400)) * 4.0).astype(np.float32)
SV_FRAMES, SV_SIZE, SV_CLIPS = 4, 16, 5
PV_VIDEOS, PV_ITER = 5, 6
PV_LABELS = [f"class {i}" for i in range(K)]


class LinearVictim(torch.nn.Module):
    """logits = mean over (T, H, W) of the normalized clip @ w."""

    def __init__(self, w=W_LIN):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.asarray(w)))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w


def _linear_labels(video_u8, w=W_LIN, meanstd=False):
    """The linear victim's clean prediction of uint8 clips [B,T,H,W,3]."""
    x = video_u8.astype(np.float32)
    if meanstd:
        x = (x / 255.0 - np.float32(tvd.DEFAULT_MEAN)) / np.float32(tvd.DEFAULT_STD)
    else:
        x = x / 128.0 - 1.0
    return (x.mean(axis=(1, 2, 3)) @ w).argmax(-1).astype(np.int64)


def make_inputs():
    """Every case's global batch and initial delta (numpy, seeded)."""
    rng = np.random.default_rng(13)
    out = {}
    for name, (spec, config, _) in CASES.items():
        if spec == "i3d":
            video = rng.integers(0, 256, (I3D_B, I3D_T, I3D_S, I3D_S, 3), dtype=np.uint8)
            model = i3d_model()
            with torch.no_grad():
                x = torch.from_numpy(video).float() / 128.0 - 1.0
                labels = model(x)[0].argmax(-1).numpy()
            delta = rng.uniform(-0.05, 0.05, (I3D_T, 1, 1, 3))
        else:
            video = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
            labels = (rng.integers(0, K, (B,)) if config.get("targeted")
                      else _linear_labels(video, meanstd=spec == "meanstd"))
            if spec == "sparse":  # the spec's own start, as the JAX package's mesh test
                delta = tpert.init_delta(SparseSpec(T, S, S)).numpy()
            else:
                delta = rng.uniform(-0.3, 0.3, (T, 1, 1, 3)) * (0.2 if spec == "meanstd" else 1)
        out[name] = {"video": video, "labels": labels.astype(np.int64),
                     "delta": delta.astype(np.float32)}
    return out


def i3d_model():
    model = InceptionI3D(I3D_K, torch.float32, device="cpu")
    model.load_state_dict(init_i3d_state(2, num_classes=I3D_K))
    return model


def port_engine(name, mesh=None, **kw):
    spec, config, _ = CASES[name]
    if spec == "i3d":
        return AttackEngine(i3d_model(), FlickerSpec(I3D_T), AttackConfig(**config), mesh=mesh,
                            **kw)
    specs = {"flicker": FlickerSpec(T), "sparse": SparseSpec(T, S, S),
             "meanstd": TorchStyleFlickerSpec(T, max_norm=0.2)}
    return AttackEngine(LinearVictim(), specs[spec], AttackConfig(**config), mesh=mesh, **kw)


def run_port_case(name, inputs, mesh=None):
    """The case's steps on the port: (final delta, each step's METRICS),
    a mesh's rank stepping on its shard of the global batch."""
    engine = port_engine(name, mesh)
    case = inputs[name]
    batch = engine.shard({"video": case["video"], "labels": case["labels"]})
    d0 = torch.from_numpy(case["delta"])
    state = AttackState(d0, torch.zeros_like(d0), torch.zeros_like(d0), 0)
    history = []
    for flags in CASES[name][2]:
        state, m = engine.train_step(state, batch, RuntimeFlags(**flags))
        history.append({k: float(m[k]) for k in METRICS})
    return state.delta.numpy().copy(), history


# ---------------- what each rank runs ----------------

def _rank_main(rank, tmp):
    """One rank of the W=2 gloo group: every case, its results saved to
    rank<r>.pt (a traceback to rank<r>.err on failure)."""
    try:
        torch.set_num_threads(1)
        mesh_lib.initialize_distributed("gloo", f"file://{tmp}/store", rank, W)
        _rank_cases(rank, tmp)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _rank_cases(rank, tmp):
    mesh = mesh_lib.make_mesh("cpu")
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = {"mesh": (mesh.rank, mesh.world, mesh.backend)}
    for name in CASES:
        out[name] = run_port_case(name, inputs, mesh)

    # the eval counts: the hinge case's final delta over the rank's shard of
    # the batch (labels its clean prediction), summed over the ranks
    engine = port_engine("hinge", mesh)
    case = inputs["hinge"]
    shard = engine.shard({"video": case["video"], "labels": case["labels"]})
    out["eval"] = tloops.evaluate_fooling(engine, torch.from_numpy(out["hinge"][0]), [shard],
                                          RuntimeFlags())
    # train_eval_step: the global probabilities and fooling counters
    d0 = torch.from_numpy(case["delta"])
    state = AttackState(d0, torch.zeros_like(d0), torch.zeros_like(d0), 0)
    _, m = engine.train_eval_step(state, shard, RuntimeFlags())
    out["train_eval"] = {k: m[k].numpy().copy() for k in ("probs", "miss", "valid", "total_loss")}

    # world 1 with its collective (a group of this rank alone) against no mesh
    singles = [dist.new_group([r], backend="gloo") for r in range(W)]
    own = mesh_lib.Mesh(singles[rank], singles[rank], 0, 1, torch.device("cpu"))
    out["world1"] = [run_port_case("hinge", inputs, m) for m in (own, None)]

    out["runner"] = _rank_runner(rank, tmp)
    with mock.patch.object(tcommon, "build_victim", _victim_400):
        cfg = _sv_cfg(os.path.join(tmp, "npy"), os.path.join(tmp, "sv_mesh"))
        with contextlib.redirect_stdout(io.StringIO()):
            out["single_video"] = tsingle.run(cfg, frames=SV_FRAMES, device="cpu", slots=4,
                                              use_mesh=True)
    with _per_video_patches():
        out["per_video"] = tper_video.run(
            "r2plus1d_18", model_dir=os.path.join(tmp, "pv_mesh"), slots=4, use_mesh=True,
            **_pv_kwargs(tmp))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _rank_runner(rank, tmp, out_dir="universal"):
    """The universal runner on the uneven shards: its output (None on an
    idle rank), how many files this rank saved through the checkpointer,
    and what it printed."""
    saved = []
    real_save = torch.save

    def spy(obj, path, *a, **kw):
        saved.append(os.path.basename(str(path)))
        return real_save(obj, path, *a, **kw)

    log = io.StringIO()
    with mock.patch.object(tcommon, "build_victim", lambda *a, device=None, **kw: LinearVictim()), \
            mock.patch.object(tckpt.torch, "save", spy), contextlib.redirect_stdout(log):
        out = tuniversal.run(_runner_cfg(tmp, out_dir), frames=T, size=S, device="cpu")
    if out is None:
        return {"out": None, "saved": saved, "log": log.getvalue()}
    return {"history": out["history"], "final_eval": out["final_eval"], "steps": out["steps"],
            "delta": out["state"].delta.numpy().copy(), "saved": saved, "log": log.getvalue()}


def _shrunk_main(rank, tmp):
    """One rank of a gloo group of W + 1 = 3: the universal runner, whose
    batch of RUNNER_B = 4 splits over ranks 0 and 1 (shrunk<r>.pt)."""
    try:
        torch.set_num_threads(1)
        mesh_lib.initialize_distributed("gloo", f"file://{tmp}/store3", rank, W + 1)
        torch.save(_rank_runner(rank, tmp, "universal3"), os.path.join(tmp, f"shrunk{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"shrunk{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _runner_cfg(tmp, out_dir="universal"):
    cfg = tconfig.default_config()
    ac = cfg.UNIVERSAL_ATTACK
    shards = os.path.join(tmp, "shards")
    ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shards]
    ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = len(SHARD_SIZES)
    ac.BATCH_SIZE, ac.MAX_NUM_STEP, ac.COMPUTE_DTYPE = RUNNER_B, RUNNER_STEPS, "float32"
    ac.PKL_RESULT_PATH = os.path.join(tmp, out_dir)
    return cfg


def _victim_400(*a, device=None, **kw):
    return LinearVictim(W400)


def _sv_cfg(npy_dir, out_dir):
    cfg = tconfig.default_config()
    ac = cfg.SINGLE_VIDEO_ATTACK
    ac.NPY_PATH, ac.PKL_RESULT_PATH = npy_dir, out_dir
    ac.COMPUTE_DTYPE, ac.MAX_NUM_STEP = "float32", 5
    return cfg


def _decoded(path):
    return np.random.default_rng(sum(map(ord, os.path.basename(path)))).integers(
        0, 256, (7, 20, 30, 3), dtype=np.uint8)


@contextlib.contextmanager
def _per_video_patches():
    with mock.patch.object(tper_video, "build_victim", lambda *a, device=None, **kw: LinearVictim()), \
            mock.patch.object(tvd.VideoDataset, "_decode", lambda self, p: _decoded(p)), \
            contextlib.redirect_stdout(io.StringIO()):
        yield


def _pv_kwargs(tmp):
    records = torch.load(os.path.join(tmp, "records.pt"), weights_only=False)
    return dict(records=records, label_names=PV_LABELS, n_iter=PV_ITER, sample_length=T,
                input_size=S, device="cpu")


# ---------------- the parent: inputs, the spawn, one process's runs ----------------

def _write_assets(tmp, inputs):
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    # shards labelled with the linear victim's clean prediction (all valid)
    os.makedirs(os.path.join(tmp, "shards"))
    rng = np.random.default_rng(7)
    for i, n in enumerate(SHARD_SIZES):
        clips = rng.integers(0, 256, (n, T, S, S, 3), dtype=np.uint8)
        with TFRecordWriter(os.path.join(tmp, "shards", f"s{i}.tfrecords")) as w:
            for clip, label in zip(clips, _linear_labels(clips)):
                w.write(make_uint8_example(clip, int(label)))
    # npy clips named with the 400-class victim's prediction (the last misnamed)
    os.makedirs(os.path.join(tmp, "npy"))
    for i in range(SV_CLIPS):
        x = rng.integers(0, 255, (SV_FRAMES, SV_SIZE, SV_SIZE, 3), dtype=np.uint8).astype(
            np.float32) / 128.0 - 1.0
        cls = int((x.mean(axis=(0, 1, 2)) @ W400).argmax())
        cls = cls if i < SV_CLIPS - 1 else (cls + 1) % 400
        np.save(os.path.join(tmp, "npy", f"rgb_vid{i}@{LABELS_400[cls].replace(' ', '_')}.npy"),
                x[None])
    # the per-video sweep's records, labelled with the victim's prediction (one not)
    records = []
    for i in range(PV_VIDEOS):
        ds = tvd.VideoDataset([tvd.VideoRecord(f"vid{i}.mp4", 0)], sample_length=T,
                              input_size=S, random_offset=False, random_crop=False,
                              random_flip=False)
        with mock.patch.object(tvd.VideoDataset, "_decode", lambda self, p: _decoded(p)):
            clip = ds.load_clip(ds.records[0])
        label = int(_linear_labels(clip[None], meanstd=True)[0])
        records.append(tvd.VideoRecord(f"vid{i}.mp4", label if i != 2 else (label + 1) % K))
    torch.save(records, os.path.join(tmp, "records.pt"))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Spawn the W=2 group, and beside it the shrunk group of 3, once;
    every rank's saved results, the inputs and the temporary directory."""
    tmp = str(tmp_path_factory.mktemp("w2"))
    inputs = make_inputs()
    _write_assets(tmp, inputs)
    ctx = multiprocessing.get_context("spawn")
    runs = [("rank", _rank_main, W), ("shrunk", _shrunk_main, W + 1)]
    procs = [ctx.Process(target=main, args=(r, tmp)) for _, main, n in runs for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = ""
    for tag, _, n in runs:
        for r in range(n):
            err = os.path.join(tmp, f"{tag}{r}.err")
            if os.path.exists(err):
                errors += open(err).read()
    assert not hung, f"the groups did not finish within {JOIN_S} s\n{errors}"
    assert all(p.exitcode == 0 for p in procs), errors
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(W)]
    shrunk = [torch.load(os.path.join(tmp, f"shrunk{r}.pt"), weights_only=False)
              for r in range(W + 1)]
    return {"tmp": tmp, "inputs": inputs, "ranks": ranks, "shrunk": shrunk}


@pytest.fixture(scope="module")
def jax_cases(group):
    """The JAX package's 2-device mesh on every engine case, from the same
    initial deltas: (final delta, each step's METRICS, eval (miss, valid))."""
    import jax
    import jax.numpy as jnp
    from flickering_adversarial_video_tpu.attack import FlickerSpec as JFlicker
    from flickering_adversarial_video_tpu.attack import SparseSpec as JSparse
    from flickering_adversarial_video_tpu.attack import TorchStyleFlickerSpec as JMeanstd
    from flickering_adversarial_video_tpu.engine import AttackConfig as JConfig
    from flickering_adversarial_video_tpu.engine import AttackEngine as JEngine
    from flickering_adversarial_video_tpu.engine import RuntimeFlags as JFlags
    from flickering_adversarial_video_tpu.models.i3d import InceptionI3D as JaxI3D
    from flickering_adversarial_video_tpu.parallel import mesh as jmesh
    from flickering_adversarial_video_tpu_torch.convert import to_flax_variables

    mesh = jmesh.make_mesh(n_devices=W)
    out = {}
    for name, (spec, config, steps) in CASES.items():
        if spec == "i3d":
            variables = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(
                init_i3d_state(2, num_classes=I3D_K)))
            m = JaxI3D(num_classes=I3D_K, compute_dtype=jnp.float32)
            pm = JaxI3D(num_classes=I3D_K, compute_dtype=jnp.float32, prepacked_stem_input=True)
            eng = JEngine(lambda v, x: m.apply(v, x)[0], variables, JFlicker(frames=I3D_T),
                          JConfig(**config), mesh=mesh,
                          apply_packed_fn=lambda v, xp: pm.apply(v, xp)[0])
        else:
            jspec = {"flicker": JFlicker(frames=T), "sparse": JSparse(frames=T, height=S, width=S),
                     "meanstd": JMeanstd(frames=T, max_norm=0.2)}[spec]
            eng = JEngine(lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"],
                          {"w": jnp.asarray(W_LIN)}, jspec, JConfig(**config), mesh=mesh)
        case = group["inputs"][name]
        state = eng.init_state()
        state = jmesh.put_replicated(mesh, state.replace(delta=jnp.asarray(case["delta"])))
        batch = eng.shard({"video": case["video"], "labels": case["labels"]})
        history = []
        for i, flags in enumerate(steps):
            state, m_ = eng.train_step(state, batch, JFlags(**flags), jax.random.key(i))
            history.append({k: float(m_[k]) for k in METRICS})
        ev = None
        if name == "hinge":
            e = eng.eval_step(state.delta, batch, JFlags(), jax.random.key(0))
            ev = (int(e["miss"]), int(e["valid"]))
        out[name] = (np.asarray(state.delta), history, ev)
    return out


# ---------------- the engine against the JAX package's mesh ----------------

@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_the_jax_mesh(group, jax_cases, name):
    """W=2 ranks against the JAX package's 2-device mesh: delta within 1e-6,
    total_loss within 1e-5 relative at every step, and the other global
    metrics (adv_loss, prob_to_*, is_adversarial) likewise."""
    want_delta, want_hist, _ = jax_cases[name]
    for rank in group["ranks"]:
        delta, hist = rank[name]
        assert np.abs(delta - group["inputs"][name]["delta"]).max() > 1e-4  # delta moved
        np.testing.assert_allclose(delta, want_delta, atol=DELTA_TOL, rtol=0)
        for got, want in zip(hist, want_hist):
            for k in METRICS:
                assert got[k] == pytest.approx(want[k], rel=LOSS_REL, abs=1e-9), k


@pytest.mark.parametrize("name", list(CASES))
def test_delta_bit_equal_across_ranks(group, name):
    r0, r1 = group["ranks"]
    assert r0["mesh"] == (0, W, "gloo") and r1["mesh"] == (1, W, "gloo")
    np.testing.assert_array_equal(r0[name][0], r1[name][0])
    assert r0[name][1] == r1[name][1]


def test_eval_counts_summed_over_ranks(group, jax_cases):
    want_miss, want_valid = jax_cases["hinge"][2]
    for rank in group["ranks"]:
        ev = rank["eval"]
        assert ev["total_valid_videos"] == want_valid == B and ev["batches"] == W
        assert ev["miss_rate"] == pytest.approx(want_miss / want_valid)


def test_train_eval_step_is_the_global_batch(group):
    """train_eval_step at W=2 against one process on the global batch: the
    gathered probabilities, the summed fooling counters, the total loss."""
    engine = port_engine("hinge")
    case = group["inputs"]["hinge"]
    d0 = torch.from_numpy(case["delta"])
    _, want = engine.train_eval_step(AttackState(d0, torch.zeros_like(d0), torch.zeros_like(d0),
                                                 0), {"video": case["video"],
                                                      "labels": case["labels"]}, RuntimeFlags())
    for rank in group["ranks"]:
        got = rank["train_eval"]
        np.testing.assert_allclose(got["probs"], want["probs"].numpy(), rtol=1e-6, atol=1e-7)
        assert (int(got["miss"]), int(got["valid"])) == (int(want["miss"]), int(want["valid"]))
        assert float(got["total_loss"]) == pytest.approx(float(want["total_loss"]), rel=LOSS_REL)


def test_world_one_with_its_collective_is_the_unmeshed_step(group):
    """A group of one rank runs the collective and is the no-mesh step bit
    for bit (delta and every metric)."""
    for rank in group["ranks"]:
        (d1, h1), (d0, h0) = rank["world1"]
        np.testing.assert_array_equal(d1, d0)
        assert h1 == h0


# ---------------- the runners over ranks ----------------

def test_universal_runner_on_uneven_shards(group):
    """Three shards split 2:1 over the ranks: the run ends (epochs of 2
    steps, the rank with a third batch stops with the other), rank 0 alone
    saves the checkpoint and writes the scalars, every val clip counts, and
    the trajectory is one process's fed the ranks' batches in rank order."""
    tmp = group["tmp"]
    r0, r1 = (rank["runner"] for rank in group["ranks"])
    assert r0["steps"] == r1["steps"] == RUNNER_STEPS
    assert r0["saved"] and not r1["saved"]
    np.testing.assert_array_equal(r0["delta"], r1["delta"])
    h0, h1 = r0["history"], r1["history"]
    assert {k: v for k, v in h0.items() if k != "perturbation"} == {
        k: v for k, v in h1.items() if k != "perturbation"}
    assert all(np.array_equal(a, b) for a, b in zip(h0["perturbation"], h1["perturbation"]))
    for r in (r0, r1):
        assert r["final_eval"]["total_valid_videos"] == sum(SHARD_SIZES)
        assert r["final_eval"]["batches"] == sum(SHARD_SIZES) // (RUNNER_B // W)
    model_dir = tuniversal.model_dir_name(_runner_cfg(tmp).UNIVERSAL_ATTACK)
    assert tckpt.AttackCheckpointer(os.path.join(model_dir, "ckpt")).steps() == [RUNNER_STEPS]
    assert len(os.listdir(os.path.join(model_dir, "train"))) == 1
    with open(os.path.join(model_dir, "res.pkl"), "rb") as f:
        assert pickle.load(f)["history"]["fool_rate_steps"] == r0["history"]["fool_rate_steps"]

    # one process, fed each step the ranks' batches in rank order
    shards = ttfr.list_shards(os.path.join(tmp, "shards"))
    per_rank = [list(ttfr.tfrecord_batches(shards, RUNNER_B // W, frames=T, height=S, width=S,
                                           host_id=r, num_hosts=W)) for r in range(W)]
    epoch = [{k: np.concatenate([np.asarray(b[k]) for b in batches]) for k in ("video", "labels")}
             for batches in zip(*per_rank)]
    engine = port_engine("hinge")
    state = engine.init_state()
    flags = tloops.flags_from_config(_runner_cfg(tmp).UNIVERSAL_ATTACK)
    losses = []
    for step in range(RUNNER_STEPS):
        state, m = engine.train_step(state, epoch[step % len(epoch)], flags)
        losses.append(float(m["total_loss"]))
    np.testing.assert_allclose(r0["delta"], state.delta.numpy(), atol=DELTA_TOL, rtol=0)
    assert r0["history"]["total_loss"][0] == pytest.approx(losses[0], rel=LOSS_REL)


def test_universal_runner_shrinks_to_the_ranks_that_divide_the_batch(group):
    """Three ranks, BATCH_SIZE 4: the mesh is ranks 0 and 1 (the JAX
    runners' largest divisor), each prints the shrink, rank 2 is idle and
    saves nothing, and ranks 0-1 run the W=2 run bit for bit: delta, the
    history, the final eval and the files written."""
    tmp = group["tmp"]
    r0, r1, r2 = group["shrunk"]
    two = group["ranks"][0]["runner"]
    for r in (r0, r1, r2):
        assert "BATCH_SIZE 4 splits over 2 of the 3 ranks; idle: 2" in r["log"]
    assert r2 == {"out": None, "saved": [], "log": r2["log"]}
    assert "train shards" not in r2["log"] and "data parallel: rank" not in r2["log"]
    assert "data parallel: rank 0 of 2 (gloo)" in r0["log"]
    assert len(r0["saved"]) == len(two["saved"]) > 0 and not r1["saved"]
    for r in (r0, r1):
        np.testing.assert_array_equal(r["delta"], two["delta"])
        assert r["steps"] == two["steps"] and r["final_eval"] == two["final_eval"]
        assert {k: v for k, v in r["history"].items() if k != "perturbation"} == {
            k: v for k, v in two["history"].items() if k != "perturbation"}
        assert all(np.array_equal(a, b) for a, b in zip(r["history"]["perturbation"],
                                                          two["history"]["perturbation"]))
    dirs = [tuniversal.model_dir_name(_runner_cfg(tmp, out).UNIVERSAL_ATTACK)
            for out in ("universal3", "universal")]
    assert [sorted(os.listdir(d)) for d in dirs] == [["ckpt", "res.pkl", "train"]] * 2
    assert [sorted(os.listdir(os.path.join(d, "ckpt"))) for d in dirs][0] == sorted(
        os.listdir(os.path.join(dirs[1], "ckpt")))
    assert [len(os.listdir(os.path.join(d, "train"))) for d in dirs] == [1, 1]


def test_per_video_slots_over_ranks_equal_one_process(group, tmp_path):
    """torch_per_video --slots 4 --mesh at W=2: the counts, files, verdicts
    and histories of one process's --slots 4, and a rerun skips what any
    rank finished."""
    mesh_out = group["ranks"][0]["per_video"]
    assert group["ranks"][1]["per_video"] == mesh_out
    kw = _pv_kwargs(group["tmp"])
    with _per_video_patches():
        one = tper_video.run("r2plus1d_18", model_dir=str(tmp_path / "one"), slots=4, **kw)
    assert {k: v for k, v in mesh_out.items() if k != "results"} == {
        k: v for k, v in one.items() if k != "results"}
    assert mesh_out["attacked"] == PV_VIDEOS - 1
    mesh_dir = os.path.join(group["tmp"], "pv_mesh")
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(tmp_path / "one"))
    assert sorted((os.path.basename(p), f) for p, f in mesh_out["results"]) == sorted(
        (os.path.basename(p), f) for p, f in one["results"])
    for name in os.listdir(tmp_path / "one"):
        got = np.load(os.path.join(mesh_dir, name), allow_pickle=True).tolist()
        want = np.load(tmp_path / "one" / name, allow_pickle=True).tolist()
        if want is None:
            assert got is None
            continue
        assert len(got["loss/total"]) == len(want["loss/total"])
        assert got["escalations"] == want["escalations"]
        assert list(got["is_adversarial"]) == list(want["is_adversarial"])
        np.testing.assert_allclose(got["loss/total"], want["loss/total"], atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(got["perturbation"]),
                                   np.asarray(want["perturbation"]), atol=1e-4)
    with _per_video_patches():
        again = tper_video.run("r2plus1d_18", model_dir=mesh_dir, slots=4, **kw)
    assert again["skipped_existing"] == sum(f for _, f in mesh_out["results"])


def test_single_video_slots_over_ranks_equal_one_process(group, tmp_path):
    """single_video --slots 4 --mesh at W=2: the pkls of one process's
    --slots 4 (names, steps, verdicts, histories), every rank's paths."""
    tmp = group["tmp"]
    paths = group["ranks"][0]["single_video"]
    assert group["ranks"][1]["single_video"] == paths and len(paths) == SV_CLIPS - 1
    with mock.patch.object(tcommon, "build_victim", _victim_400), \
            contextlib.redirect_stdout(io.StringIO()):
        one = tsingle.run(_sv_cfg(os.path.join(tmp, "npy"), str(tmp_path / "one")),
                          frames=SV_FRAMES, device="cpu", slots=4)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in one]
    for p, q in zip(paths, one):
        with open(p, "rb") as f, open(q, "rb") as g:
            got, want = pickle.load(f), pickle.load(g)
        assert (got["total_steps"], got["is_adversarial"]) == (want["total_steps"],
                                                              want["is_adversarial"])
        np.testing.assert_allclose(got["total_loss_l"], want["total_loss_l"], atol=2e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(got["final_delta"], want["final_delta"], atol=1e-4)


# ---------------- one process ----------------

def test_shard_split_as_the_jax_reader(tmp_path):
    """tfrecord_batches(host_id, num_hosts) reads shards[host_id::num_hosts],
    batch for batch as the JAX package's reader, on both readers."""
    from flickering_adversarial_video_tpu.data import tfrecord as jtfr

    rng = np.random.default_rng(1)
    for i in range(5):
        with TFRecordWriter(str(tmp_path / f"s{i}.tfrecords")) as w:
            for _ in range(i + 1):
                w.write(make_uint8_example(rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8),
                                           int(rng.integers(0, 9))))
    shards = ttfr.list_shards(str(tmp_path))
    kw = dict(frames=4, height=8, width=8, drop_remainder=False)
    for host, hosts in ((0, 2), (1, 2), (2, 3), (0, 1)):
        want = list(jtfr.tfrecord_batches(shards, 2, host_id=host, num_hosts=hosts,
                                          use_native=False, **kw))
        for native in (True, False):
            got = list(ttfr.tfrecord_batches(shards, 2, host_id=host, num_hosts=hosts,
                                              use_native=native, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g["video"]), w["video"])
                np.testing.assert_array_equal(g["labels"], w["labels"])


def test_mesh_without_a_group_is_world_one():
    mesh = mesh_lib.make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world, mesh.device) == (None, 0, 1, torch.device("cpu"))
    engine = port_engine("hinge", mesh)
    assert engine.mesh is None
    batch = {"video": np.zeros((4, T, S, S, 3), np.uint8), "labels": np.zeros(4, np.int64)}
    assert engine.shard(batch) is batch
    assert mesh_lib.all_ranks(mesh, False) is False and mesh_lib.gather_objects(mesh, 3) == [3]


def test_shard_batch_takes_the_rank_rows():
    batch = {"video": np.arange(8 * 2).reshape(8, 2), "labels": np.arange(8)}
    for rank in range(W):
        mesh = mesh_lib.Mesh(None, None, rank, W, torch.device("cpu"))
        got = mesh_lib.shard_batch(mesh, batch)
        np.testing.assert_array_equal(got["labels"], np.arange(8)[rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(got["video"], batch["video"][rank * 4:(rank + 1) * 4])
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.shard_batch(mesh_lib.Mesh(None, None, 0, 3, torch.device("cpu")), batch)


def test_device_follows_local_rank(monkeypatch):
    from flickering_adversarial_video_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device(None) == torch.device("cuda")


@pytest.mark.parametrize("bs", [3, 5])
def test_batch_that_does_not_split_raises(monkeypatch, bs):
    """A BATCH_SIZE that the 2 ranks do not divide still raises where it is
    split over them (``shard_batch``), but ``build_engine`` no longer
    splits it so: the mesh shrinks to 1 rank, as the JAX runners' does
    (batch 1 or no divisor: unmeshed).  Rank 0 runs without a mesh, rank 1
    is idle (no engine, no victim built), and both print the shrink."""
    asked = []

    def make_mesh(device=None, size=None):
        asked.append(size)
        return mesh_lib.Mesh(None, None, rank, size, torch.device("cpu"))

    built = []
    monkeypatch.setattr(mesh_lib, "launched", lambda: True)
    monkeypatch.setattr(mesh_lib, "world_size", lambda: 2)
    monkeypatch.setattr(mesh_lib, "make_mesh", make_mesh)
    monkeypatch.setattr(tcommon, "build_victim",
                        lambda *a, device=None, **kw: built.append(1) or LinearVictim())
    ac = tconfig.default_config().UNIVERSAL_ATTACK
    ac.BATCH_SIZE, ac.COMPUTE_DTYPE = bs, "float32"
    with pytest.raises(ValueError, match=f"a batch of {bs} does not split over 2 ranks"):
        mesh_lib.shard_batch(mesh_lib.Mesh(None, None, 0, 2, torch.device("cpu")),
                             {"labels": np.arange(bs)})
    for rank in (0, 1):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            engine, labels = tcommon.build_engine(ac, tconfig.default_config().MODEL, frames=T,
                                                  size=S, device="cpu")
        assert f"BATCH_SIZE {bs} splits over 1 of the 2 ranks; idle: 1" in log.getvalue()
        if rank == 0:
            assert engine.mesh is None and len(labels) == 400 and built == [1]
            batch = {"labels": np.arange(bs)}
            assert engine.shard(batch) is batch
        else:
            assert (engine, labels) == (None, []) and built == [1]
    assert asked == [1, 1]


@pytest.mark.parametrize("bs,world,want", [(8, 2, 2), (3, 2, 1), (5, 2, 1), (4, 3, 2),
                                           (6, 4, 3), (1, 4, 1), (12, 8, 6), (7, 8, 7)])
def test_mesh_size_is_the_jax_runners_count(bs, world, want):
    """The largest count, no more than min(world, batch), that divides the
    batch (JAX ``runners/common.py:249-254``)."""
    assert mesh_lib.mesh_size(bs, world) == want


def test_fused_rule_takes_the_global_batch():
    """B8's clip rule is the JAX call's on the GLOBAL batch (the JAX step is
    jitted over the mesh's shardings): a rank's [2,2,16,16,3] of a world of
    2 is a global B*T of 8, the kernel's strict rule; alone it is 4,
    jnp.clip's.  A delta a slot takes one clip's, whatever the mesh."""
    video = torch.zeros(2, 2, 16, 16, 3, dtype=torch.uint8)
    config = AttackConfig(use_pallas_fused=True)
    alone = AttackEngine(LinearVictim(), FlickerSpec(2), config)
    meshed = AttackEngine(LinearVictim(), FlickerSpec(2), config,
                          mesh=mesh_lib.Mesh(object(), None, 0, W, torch.device("cpu")))
    flat, slotted = torch.zeros(2, 1, 1, 3), torch.zeros(2, 2, 1, 1, 3)
    assert meshed._fused_strict(video, flat) and not alone._fused_strict(video, flat)
    assert not meshed._fused_strict(video, slotted) and not alone._fused_strict(video, slotted)


def test_paths_without_a_split_refuse_several_ranks(monkeypatch, tmp_path):
    """At W > 1 the sequential sweeps, slots without --mesh and the epoch fit
    refuse, naming the split; slots that W does not divide raise as in JAX."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = _sv_cfg(str(tmp_path), str(tmp_path / "o"))
    with pytest.raises(ValueError, match="--slots .* --mesh"):
        tsingle.run(cfg, frames=SV_FRAMES, device="cpu")
    with pytest.raises(ValueError, match="--slots .* --mesh"):
        tper_video.run(records=[], label_names=[], device="cpu", slots=4)
    with pytest.raises(ValueError, match="one process"):
        tuniversal_fit.run(train_records=[], valid_records=[], device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tsingle.run(cfg, frames=SV_FRAMES, device="cpu", slots=3, use_mesh=True)


def test_gloo_on_the_card_is_refused_without_eager_steps():
    """A gloo group cannot be captured in the step's CUDA graph: on the card
    the engine refuses it unless asked for eager steps (a victim that only
    says it lies on the card: none here)."""
    class OnCard(torch.nn.Module):
        def state_dict(self, *a, **kw):
            return {"w": SimpleNamespace(device=torch.device("cuda"))}

    mesh = mesh_lib.Mesh(object(), None, 0, W, torch.device("cuda"))
    with mock.patch.object(mesh_lib.Mesh, "backend", "gloo"), \
            pytest.raises(ValueError, match="cannot be captured"):
        AttackEngine(OnCard(), FlickerSpec(T), mesh=mesh)

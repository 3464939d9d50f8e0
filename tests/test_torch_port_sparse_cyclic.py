"""The L1,2 sparse attack and the cyclic rolls in the PyTorch port, held
against the JAX package in f32 on the CPU.

Sparse: ``SparseSpec`` (a full [T,H,W,3] delta, 1e-8 initially, no value
clip), its metrics, the L1,2 regularized step on a small real I3D (8x16x16,
7 classes), and the universal runner with ``FLICKERING_ATTACK: False``.
Cyclic: ``apply_perturbation``'s rolls of the input and of delta, each blended
with its flag, and their gradients; the cyclic engine, ``InferenceModel`` and
the single-video runner with both flags.  The port draws its shifts on the
device from (seed, counter) (``perturbation.roll_shifts``), a stream that
cannot equal threefry's, so the parity tests hand the port the shifts the
JAX key draws: ``split(key)`` then ``randint`` from ``key(seed)`` in an eval
or forward, from ``fold_in(key(seed), step)`` in a train step.

Tolerances: elementwise ops bit-equal (the same f32 operations in the same
order); reductions (metrics, regularizers, gradients summed over the batch
and frame) 1e-6 relative; the attack steps the 1e-5 relative loss terms and
1e-6 absolute delta of test_torch_port_engine.py; the runners the histories
of test_torch_port_single_video.py (1e-5 relative, 1e-7 absolute)."""

import contextlib
import io
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import metrics as jmetrics
from flickering_adversarial_video_tpu.attack import perturbation as jpert
from flickering_adversarial_video_tpu.attack import regularizers as jreg
from flickering_adversarial_video_tpu.data import tfrecord as jtfr
from flickering_adversarial_video_tpu.engine import AttackConfig as JaxConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JaxEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JaxFlags
from flickering_adversarial_video_tpu.engine.inference import InferenceModel as JaxInferenceModel
from flickering_adversarial_video_tpu.models.i3d import InceptionI3D as JaxI3D
from flickering_adversarial_video_tpu.runners import common as jcommon
from flickering_adversarial_video_tpu.runners import single_video as jsingle
from flickering_adversarial_video_tpu.runners import universal as juniversal
from flickering_adversarial_video_tpu.utils import config as jconfig
from flickering_adversarial_video_tpu_torch.attack import metrics as tmetrics
from flickering_adversarial_video_tpu_torch.attack import perturbation as tpert
from flickering_adversarial_video_tpu_torch.attack import regularizers as treg
from flickering_adversarial_video_tpu_torch.convert import (
    from_flax_variables, init_i3d_state, to_flax_variables)
from flickering_adversarial_video_tpu_torch.data import npy as tnpy
from flickering_adversarial_video_tpu_torch.data import tfrecord as ttfr
from flickering_adversarial_video_tpu_torch.engine import (
    AttackConfig, AttackEngine, AttackState, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
from flickering_adversarial_video_tpu_torch.engine.inference import InferenceModel
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import single_video as tsingle
from flickering_adversarial_video_tpu_torch.runners import universal as tuniversal
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils.labels import kinetics400_labels
from flickering_adversarial_video_tpu_torch.viz import results as tresults

K, FRAMES, SIZE, STEPS = 7, 8, 16, 3
TERMS = ("total_loss", "adv_loss", "reg_loss", "weighted_reg", "l12", "norm_reg",
         "diff_norm_reg", "laplacian_norm_reg", "prob_to_min", "prob_to_max", "thickness",
         "roughness", "delta_max", "delta_min")


def jax_shifts(seed, counter, frames, delta_frames):
    """The shifts the JAX package draws: from key(seed) (counter 0: an eval
    or forward) or fold_in(key(seed), counter - 1) (the train step of that
    step count), split, randint."""
    key = jax.random.key(int(seed))
    if int(counter):
        key = jax.random.fold_in(key, int(counter) - 1)
    k1, k2 = jax.random.split(key)
    return (torch.tensor(int(jax.random.randint(k1, (), 0, frames))),
            torch.tensor(int(jax.random.randint(k2, (), 0, delta_frames))))


@pytest.fixture
def jax_stream(monkeypatch):
    """The port's engine draws the JAX package's shifts."""
    monkeypatch.setattr(tpert, "roll_shifts", jax_shifts)


@pytest.fixture(scope="module")
def flax_vars():
    """Seeded random weights as the JAX I3D's Flax tree (the JAX package's
    own init_i3d_params takes 15 s to trace)."""
    return to_flax_variables(init_i3d_state(6, K))


@pytest.fixture(scope="module")
def model(flax_vars):
    m = InceptionI3D(K, torch.float32, device="cpu")
    m.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, flax_vars)))
    return m


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    return {"video": rng.integers(0, 256, (2, FRAMES, SIZE, SIZE, 3), dtype=np.uint8),
            "labels": rng.integers(0, K, (2,))}


def _run_both(flax_vars, model, batch, jspec, tspec, jcfg, tcfg, flags_kw, seed=0):
    """3 train steps of each package's engine from init_state, the JAX steps
    keyed fold_in(key(seed), step) as its loops key them; then an eval step
    keyed key(seed).  (metrics, final delta, eval probs) of each."""
    jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
    jeng = JaxEngine(lambda v, x: jm.apply(v, x)[0], flax_vars, jspec, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(seed)
    state, jmetrics_ = jeng.init_state(), []
    for step in range(STEPS):
        state, mt = jeng.train_step(state, jbatch, JaxFlags(**flags_kw),
                                    jax.random.fold_in(key, step))
        jmetrics_.append({k: float(mt[k]) for k in TERMS})
    jev = jeng.eval_step(state.delta, jbatch, JaxFlags(**flags_kw), key)
    teng = AttackEngine(model, tspec, tcfg)
    tstate, tmetrics_ = teng.init_state(), []
    for _ in range(STEPS):
        tstate, mt = teng.train_step(tstate, batch, RuntimeFlags(**flags_kw), seed)
        tmetrics_.append({k: float(mt[k]) for k in TERMS})
    tev = teng.eval_step(tstate.delta, batch, RuntimeFlags(**flags_kw), seed)
    return ((jmetrics_, np.asarray(state.delta), np.asarray(jev["adv_probs"])),
            (tmetrics_, tstate.delta.numpy(), tev["adv_probs"].numpy()), teng)


def _assert_runs_match(jrun, trun):
    for s in range(STEPS):
        for k in TERMS:
            assert trun[0][s][k] == pytest.approx(jrun[0][s][k], rel=1e-5, abs=1e-9), (s, k)
    np.testing.assert_allclose(trun[1], jrun[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(trun[2], jrun[2], atol=1e-6, rtol=1e-5)


# ---------------- the L1,2 sparse attack ----------------

class TestSparseSpec:
    def test_init_and_clip(self):
        spec, jspec = tpert.SparseSpec(FRAMES, 6, 5), jpert.SparseSpec(FRAMES, 6, 5)
        assert spec.shape == jspec.shape == (FRAMES, 6, 5, 3)
        d = tpert.init_delta(spec)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jpert.init_delta(jspec)))
        assert d.dtype == torch.float32 and float(d[0, 0, 0, 0]) == np.float32(1e-8)
        big = torch.full(spec.shape, 3.0)
        assert torch.equal(tpert.clip_delta(spec, big), big)  # no value clip

    @pytest.mark.parametrize("adv_flag", [1.0, 0.5, 0.0])
    def test_apply_matches_jax(self, adv_flag):
        rng = np.random.default_rng(1)
        spec, jspec = tpert.SparseSpec(FRAMES, 6, 5), jpert.SparseSpec(FRAMES, 6, 5)
        clean = rng.uniform(-1, 1, (2, FRAMES, 6, 5, 3)).astype(np.float32)
        delta = rng.uniform(-1.5, 1.5, spec.shape).astype(np.float32)
        mask = np.asarray(jpert.frame_mask(FRAMES, 2, 5))
        want = jpert.apply_perturbation(jnp.asarray(clean), jnp.asarray(delta), jspec,
                                        adv_flag=adv_flag, mask=jnp.asarray(mask))
        got = tpert.apply_perturbation(torch.from_numpy(clean), torch.from_numpy(delta), spec,
                                       adv_flag=adv_flag, mask=torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_metrics_and_regularizers_on_a_full_delta(self):
        d = np.random.default_rng(2).normal(size=(FRAMES, 6, 5, 3)).astype(np.float32)
        pairs = [(tmetrics.thickness, jmetrics.thickness), (tmetrics.roughness, jmetrics.roughness),
                 (treg.l12_regularizer, jreg.l12_regularizer),
                 (treg.thinness_reg, jreg.thinness_reg),
                 (treg.first_order_diff_reg, jreg.first_order_diff_reg),
                 (treg.second_order_diff_reg, jreg.second_order_diff_reg)]
        for t, j in pairs:
            assert float(t(torch.from_numpy(d))) == pytest.approx(float(j(jnp.asarray(d))),
                                                                 rel=1e-6), t.__name__


class TestSparseEngine:
    @pytest.fixture(scope="class")
    def runs(self, flax_vars, model, batch):
        return _run_both(flax_vars, model, batch, jpert.SparseSpec(FRAMES, SIZE, SIZE),
                         tpert.SparseSpec(FRAMES, SIZE, SIZE), JaxConfig(attack_kind="sparse"),
                         AttackConfig(attack_kind="sparse"), dict(beta1=0.7))

    def test_l12_loss_and_delta_trajectory_match_jax(self, runs):
        jrun, trun, _ = runs
        _assert_runs_match(jrun, trun)
        # the regularizer is beta1 * L1,2
        for m in trun[0]:
            assert m["reg_loss"] == pytest.approx(0.7 * m["l12"], rel=1e-6)
        assert trun[1].shape == (FRAMES, SIZE, SIZE, 3) and np.abs(trun[1]).max() > 1e-4

    def test_generic_input_path(self, runs, batch):
        """No packed head for a full delta (the JAX engine's
        _packed_supported); a host-packed batch is refused."""
        eng = runs[2]
        assert not eng._packed_supported()
        assert eng.prepare_batch(batch)[1] is False
        with pytest.raises(ValueError, match="flickering delta"):
            eng.prepare_batch({"video_packed": np.zeros((2, 4, 8, 8, 24), np.uint8),
                               "labels": batch["labels"]})

    def test_fused_kernel_mode_is_refused(self, model):
        with pytest.raises(ValueError, match="flickering delta"):
            AttackEngine(model, tpert.SparseSpec(FRAMES, SIZE, SIZE),
                         AttackConfig(attack_kind="sparse", use_pallas_fused=True))

    def test_unknown_kind_is_refused(self, model):
        with pytest.raises(ValueError, match="attack_kind"):
            AttackEngine(model, tpert.FlickerSpec(FRAMES), AttackConfig(attack_kind="dense"))


# ---------------- the universal runner, FLICKERING_ATTACK: False ----------------

W_LINEAR = (np.random.default_rng(5).standard_normal((3, 400)) * 4.0).astype(np.float32)
RFRAMES, RSIZE, RBATCH = 4, 12, 2


class LinearVictim(torch.nn.Module):
    def __init__(self, device):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(W_LINEAR).to(device))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w


def _patch_victims(mp, size):
    mp.setattr(jcommon, "build_victim", lambda *a, **kw: (
        (lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"]), {"w": jnp.asarray(W_LINEAR)}))
    mp.setattr(tcommon, "build_victim",
               lambda *a, device=None, **kw: LinearVictim(torch.device(device)))
    mp.setattr(juniversal, "tfrecord_batches",
               lambda shards, bs, frames=None, **kw: jtfr.tfrecord_batches(
                   shards, bs, frames=frames,
                   **{**kw, "height": size, "width": size, "use_native": False}))
    mp.setitem(sys.modules, "tensorboardX", None)  # the JSONL scalar writers
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)


def _shards(shard_dir, frames, size):
    """Clips labelled with the linear victim's clean prediction."""
    rng = np.random.default_rng(13)
    os.makedirs(shard_dir, exist_ok=True)
    for s in range(2):
        with ttfr.TFRecordWriter(os.path.join(shard_dir, f"shard{s}.tfrecords")) as w:
            for _ in range(4):
                c = rng.integers(0, 255, (frames, size, size, 3), dtype=np.uint8)
                x = c.astype(np.float32) / 128.0 - 1.0
                w.write(ttfr.make_uint8_example(c, int((x.mean(axis=(0, 1, 2)) @ W_LINEAR).argmax())))
    return str(shard_dir)


def _universal_cfg(module, shard_dir, out_dir, **over):
    cfg = module.default_config()
    ac = cfg.UNIVERSAL_ATTACK
    ac.TF_RECORDS_TRAIN_PATH = ac.TF_RECORDS_VAL_PATH = [shard_dir]
    ac.NUM_OF_TRAIN_TF_RECORDS = ac.NUM_OF_VAL_TF_RECORDS = 2
    ac.BATCH_SIZE, ac.PKL_RESULT_PATH, ac.COMPUTE_DTYPE = RBATCH, str(out_dir), "float32"
    ac.MAX_NUM_STEP, ac.EVAL_EVERY_STEPS = 4, 2
    for k, v in over.items():
        ac[k] = v
    return cfg


@pytest.fixture(scope="module")
def sparse_runs(tmp_path_factory):
    """Both universal runners with FLICKERING_ATTACK False: 4 steps, then the
    port's resume to 6."""
    root = tmp_path_factory.mktemp("sparse")
    shard_dir = _shards(root / "shards", RFRAMES, RSIZE)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_victims(mp, RSIZE)
        jc = _universal_cfg(jconfig, shard_dir, root / "jax", FLICKERING_ATTACK=False)
        tc = _universal_cfg(tconfig, shard_dir, root / "torch", FLICKERING_ATTACK=False)
        with contextlib.redirect_stdout(io.StringIO()):
            out["jax"] = juniversal.run(jc, frames=RFRAMES, size=RSIZE)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out["torch"] = tuniversal.run(tc, frames=RFRAMES, size=RSIZE, device="cpu")
        out["stdout"] = text.getvalue()
        out["dir"] = tuniversal.model_dir_name(tc.UNIVERSAL_ATTACK)
        tc.UNIVERSAL_ATTACK.MAX_NUM_STEP = 6
        with contextlib.redirect_stdout(io.StringIO()):
            out["resumed"] = tuniversal.run(tc, frames=RFRAMES, size=RSIZE, device="cpu")
    return out


class TestSparseUniversalRunner:
    def test_history_delta_and_fooling_match_jax(self, sparse_runs):
        got, want = sparse_runs["torch"], sparse_runs["jax"]
        assert got["steps"] == want["steps"] == 4
        for k in ("total_loss", "adv_loss", "reg_loss", "norm_reg", "thickness", "roughness"):
            np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert got["history"]["fool_rate_steps"] == want["history"]["fool_rate_steps"]
        assert got["history"]["fool_rate"] == pytest.approx(want["history"]["fool_rate"])
        assert got["final_eval"] == want["final_eval"]
        delta = got["state"].delta.numpy()
        assert delta.shape == (RFRAMES, RSIZE, RSIZE, 3)
        np.testing.assert_allclose(delta, np.asarray(want["state"].delta), atol=1e-6, rtol=0)

    def test_results_under_sup_attack(self, sparse_runs):
        assert os.sep + "SUP_ATTACK" + os.sep in sparse_runs["dir"]
        assert "host-prepacked" not in sparse_runs["stdout"]  # no prepack for a full delta
        with open(os.path.join(sparse_runs["dir"], "res.pkl"), "rb") as f:
            res = pickle.load(f)  # the resumed run's: steps 5 and 6, an eval at 6
        assert set(res) == {"history", "final_eval"}
        assert [p.shape for p in res["history"]["perturbation"]] == [(RFRAMES, RSIZE, RSIZE, 3)]
        np.testing.assert_array_equal(res["history"]["perturbation"][-1],
                                      sparse_runs["resumed"]["state"].delta.numpy())
        assert [p.shape for p in sparse_runs["torch"]["history"]["perturbation"]] == [
            (RFRAMES, RSIZE, RSIZE, 3)] * 2

    def test_checkpoint_holds_the_full_delta_and_resumes(self, sparse_runs):
        ck = AttackCheckpointer(os.path.join(sparse_runs["dir"], "ckpt"))
        assert ck.steps() == [4, 6]
        template = AttackState(*(torch.zeros(RFRAMES, RSIZE, RSIZE, 3) for _ in range(3)), 0)
        restored = ck.restore(template)
        assert restored.step == 6 and restored.mu.abs().max() > 0
        assert torch.equal(restored.delta, sparse_runs["resumed"]["state"].delta)


# ---------------- the cyclic rolls ----------------

class TestRolls:
    @pytest.mark.parametrize("shift", [0, 1, 5, 7, 8, 13, -3])
    def test_roll_time_is_jnp_roll(self, shift):
        x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
        got = tpert.roll_time(torch.from_numpy(x), torch.tensor(shift), axis=1)
        np.testing.assert_array_equal(got.numpy(), np.roll(x, shift, axis=1))

    @pytest.mark.parametrize("spec_kind", ["flicker", "sparse"])
    @pytest.mark.parametrize("flags", [(1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.5), (0.0, 0.0),
                                       (0.5, 1.0)])
    def test_apply_matches_jax_with_its_key(self, spec_kind, flags):
        """Each roll alone, both, half-blended and neither: the port given
        the shifts the JAX key draws equals JAX apply_perturbation(key=...)."""
        rng = np.random.default_rng(3)
        t = 10
        if spec_kind == "flicker":
            spec, jspec = tpert.FlickerSpec(t), jpert.FlickerSpec(t)
        else:
            spec, jspec = tpert.SparseSpec(t, 4, 5), jpert.SparseSpec(t, 4, 5)
        clean = rng.uniform(-1, 1, (2, t, 4, 5, 3)).astype(np.float32)
        delta = rng.uniform(-0.6, 0.6, spec.shape).astype(np.float32)
        mask = np.asarray(jpert.frame_mask(t, 1, 6))
        key = jax.random.key(11)
        cf, cpf = flags
        want = jpert.apply_perturbation(jnp.asarray(clean), jnp.asarray(delta), jspec,
                                        adv_flag=0.8, cyclic_flag=cf, cyclic_pert_flag=cpf,
                                        mask=jnp.asarray(mask), key=key)
        k1, k2 = jax.random.split(key)
        shifts = (torch.tensor(int(jax.random.randint(k1, (), 0, t))),
                  torch.tensor(int(jax.random.randint(k2, (), 0, t))))
        assert int(shifts[0]) or int(shifts[1])  # the key rolls something
        got = tpert.apply_perturbation(torch.from_numpy(clean), torch.from_numpy(delta), spec,
                                       adv_flag=torch.tensor(0.8), cyclic_flag=torch.tensor(cf),
                                       cyclic_pert_flag=torch.tensor(cpf),
                                       mask=torch.from_numpy(mask), shifts=shifts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("flags", [(1.0, 1.0), (0.5, 0.5), (0.0, 1.0)])
    def test_gradients_through_the_gather(self, flags):
        rng = np.random.default_rng(4)
        t = 9
        clean = rng.uniform(-1, 1, (2, t, 3, 3, 3)).astype(np.float32)
        delta = rng.uniform(-0.3, 0.3, (t, 1, 1, 3)).astype(np.float32)
        w = rng.normal(size=clean.shape).astype(np.float32)
        key = jax.random.key(5)
        cf, cpf = flags

        def f(c, d):
            adv = jpert.apply_perturbation(c, d, jpert.FlickerSpec(t), cyclic_flag=cf,
                                           cyclic_pert_flag=cpf, key=key)
            return jnp.sum(adv * w)

        jdc, jdd = jax.grad(f, argnums=(0, 1))(jnp.asarray(clean), jnp.asarray(delta))
        k1, k2 = jax.random.split(key)
        shifts = (torch.tensor(int(jax.random.randint(k1, (), 0, t))),
                  torch.tensor(int(jax.random.randint(k2, (), 0, t))))
        c = torch.from_numpy(clean).requires_grad_(True)
        d = torch.from_numpy(delta).requires_grad_(True)
        adv = tpert.apply_perturbation(c, d, tpert.FlickerSpec(t), cyclic_flag=cf,
                                       cyclic_pert_flag=cpf, shifts=shifts)
        (adv * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(jdc), rtol=1e-6, atol=0)
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jdd), rtol=1e-5, atol=1e-6)

    def test_device_shift_stream(self):
        """roll_shifts: in range, a function of (seed, counter) alone, and
        spread over [0, T) (every shift drawn within 2,000 draws)."""
        seed = torch.tensor(3)
        draws = [tuple(int(v) for v in tpert.roll_shifts(seed, torch.tensor(c, dtype=torch.int32),
                                                         90, 64)) for c in range(2000)]
        assert all(0 <= a < 90 and 0 <= b < 64 for a, b in draws)
        assert {a for a, _ in draws} == set(range(90)) and {b for _, b in draws} == set(range(64))
        again = tpert.roll_shifts(torch.tensor(3, dtype=torch.int64), torch.tensor(7), 90, 64)
        assert tuple(int(v) for v in again) == draws[7]
        other = [tuple(int(v) for v in tpert.roll_shifts(torch.tensor(4), torch.tensor(c), 90, 64))
                 for c in range(50)]
        assert other != draws[:50]


class TestCyclicEngine:
    @pytest.fixture(scope="class")
    def runs(self, flax_vars, model, batch):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpert, "roll_shifts", jax_shifts)
            return _run_both(flax_vars, model, batch, jpert.FlickerSpec(FRAMES),
                             tpert.FlickerSpec(FRAMES), JaxConfig(enable_cyclic=True),
                             AttackConfig(enable_cyclic=True),
                             dict(cyclic_flag=1.0, cyclic_pert_flag=0.5), seed=3)

    def test_steps_and_eval_match_jax_with_its_shifts(self, runs):
        jrun, trun, eng = runs
        _assert_runs_match(jrun, trun)
        assert not eng._packed_supported()

    def test_train_steps_equals_train_step_calls(self, model, batch):
        """n steps in one call draw each step's shifts from its own count,
        as n train_step calls do (on the card: n replays of one graph)."""
        eng = AttackEngine(model, tpert.FlickerSpec(FRAMES), AttackConfig(enable_cyclic=True))
        flags = RuntimeFlags(cyclic_flag=1.0, cyclic_pert_flag=1.0)
        chained = eng.train_steps(eng.init_state(), batch, flags, STEPS, seed=9)
        state = eng.init_state()
        for _ in range(STEPS):
            state, _ = eng.train_step(state, batch, flags, 9)
        assert chained.step == state.step == STEPS
        torch.testing.assert_close(chained.delta, state.delta, rtol=0, atol=0)
        other = eng.train_steps(eng.init_state(), batch, flags, STEPS, seed=10)
        assert not torch.equal(other.delta, state.delta)  # another seed, other rolls

    def test_rolls_compiled_out_without_enable_cyclic(self, model, batch):
        eng = AttackEngine(model, tpert.FlickerSpec(FRAMES))
        state = eng.init_state()
        a = eng.train_step(state, batch, RuntimeFlags(cyclic_flag=1.0, cyclic_pert_flag=1.0))[0]
        b = eng.train_step(state, batch, RuntimeFlags())[0]
        assert torch.equal(a.delta, b.delta)

    def test_inference_model_with_the_flags(self, flax_vars, model, jax_stream):
        """InferenceModel's cyclic flags on a cyclic engine: each call keyed
        by its call number, as the JAX wrapper's key(step)."""
        jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
        jeng = JaxEngine(lambda v, x: jm.apply(v, x)[0], flax_vars, jpert.FlickerSpec(FRAMES),
                         JaxConfig(enable_cyclic=True))
        teng = AttackEngine(model, tpert.FlickerSpec(FRAMES), AttackConfig(enable_cyclic=True))
        delta = np.random.default_rng(8).uniform(-0.4, 0.4, (FRAMES, 1, 1, 3)).astype(np.float32)
        clips = np.random.default_rng(9).uniform(-1, 1, (2, FRAMES, SIZE, SIZE, 3))
        clips = clips.astype(np.float32)
        jinf, tinf = JaxInferenceModel(jeng, delta), InferenceModel(teng, delta)
        for kw in (dict(adv_flag=1.0, cyclic_input_flag=1.0), dict(adv_flag=1.0, cyclic_eps_flag=1.0),
                   dict(adv_flag=1.0, cyclic_input_flag=0.5, cyclic_eps_flag=1.0), dict()):
            np.testing.assert_allclose(tinf(clips, **kw), jinf(clips, **kw), atol=1e-6, rtol=1e-5)


# ---------------- the single-video runner with both cyclic flags ----------------

def _linear_clips(tmp_dir, n, frames, size):
    rng = np.random.default_rng(29)
    os.makedirs(tmp_dir, exist_ok=True)
    names = kinetics400_labels()
    for i in range(n):
        c = rng.integers(0, 255, (frames, size, size, 3), dtype=np.uint8)
        x = (c.astype(np.float32) / 128.0 - 1.0)[None]
        label = names[int((x[0].mean(axis=(0, 1, 2)) @ W_LINEAR).argmax())]
        tnpy.save_npy_clip(os.path.join(tmp_dir, f"rgb_{i}@{label.replace(' ', '_')}.npy"), x)
    return str(tmp_dir)


def _sv_cfg(module, npy_dir, out_dir, **over):
    cfg = module.default_config()
    ac = cfg.SINGLE_VIDEO_ATTACK
    ac.NPY_PATH, ac.PKL_RESULT_PATH, ac.COMPUTE_DTYPE = npy_dir, str(out_dir), "float32"
    ac.MAX_NUM_STEP = 3
    for k, v in over.items():
        ac[k] = v
    return cfg


def test_single_video_runner_with_both_cyclic_flags_matches_jax(tmp_path, monkeypatch, jax_stream):
    """Two clips (seeds 0 and 1, the clip's index), both rolls on: each
    clip's history, delta and adversarial clip as the JAX runner's."""
    _patch_victims(monkeypatch, SIZE)
    npy = _linear_clips(tmp_path / "npy", 2, 6, SIZE)
    over = dict(CYCLIC_ATTACK=True, CYCLIC_PERTURBATION_ATTACK=True)
    with contextlib.redirect_stdout(io.StringIO()):
        jpaths = jsingle.run(_sv_cfg(jconfig, npy, tmp_path / "j", **over), frames=6, size=SIZE)
        tpaths = tsingle.run(_sv_cfg(tconfig, npy, tmp_path / "t", **over), frames=6, size=SIZE,
                             device="cpu")
    assert len(tpaths) == len(jpaths) == 2
    for tp, jp in zip(sorted(tpaths), sorted(jpaths)):
        got, want = tresults.load_result(tp), tresults.load_result(jp)
        assert got["total_steps"] == want["total_steps"]
        for k in ("total_loss_l", "adv_loss_l", "reg_loss_l", "fatness", "smoothness"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got["final_delta"], want["final_delta"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["adv_video"], want["adv_video"], atol=1e-6, rtol=0)


# ---------------- odd, not-multiple-of-8 and wide sizes through the runners ----------------

@pytest.mark.parametrize("frames,size", [(5, 13), (6, 20)])
def test_universal_runner_at_odd_sizes_matches_jax(tmp_path, monkeypatch, frames, size):
    """--frames / --size odd or not a multiple of 8: no host prepack, the
    generic input path, the JAX runner's history and delta."""
    _patch_victims(monkeypatch, size)
    shard_dir = _shards(tmp_path / "shards", frames, size)
    with contextlib.redirect_stdout(io.StringIO()):
        want = juniversal.run(_universal_cfg(jconfig, shard_dir, tmp_path / "j"), frames=frames,
                              size=size)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        got = tuniversal.run(_universal_cfg(tconfig, shard_dir, tmp_path / "t"), frames=frames,
                             size=size, device="cpu")
    assert "host-prepacked" not in text.getvalue()
    for k in ("total_loss", "adv_loss", "reg_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["state"].delta.numpy(), np.asarray(want["state"].delta),
                               atol=1e-6, rtol=0)


def test_single_video_runner_on_the_real_i3d_at_an_odd_size(tmp_path):
    """The real I3D through the single-video runner at an odd clip (the
    unpacked stem, the generic pools from 2a on); one step."""
    frames, size = 9, 17
    rng = np.random.default_rng(3)
    clip = rng.uniform(-1, 1, (1, frames, size, size, 3)).astype(np.float32)
    cfg = _sv_cfg(tconfig, str(tmp_path / "npy"), tmp_path / "out", MAX_NUM_STEP=0)
    with contextlib.redirect_stdout(io.StringIO()):
        eng, labels = tcommon.build_engine(cfg.SINGLE_VIDEO_ATTACK, cfg.MODEL, frames=frames,
                                           size=size, device="cpu")
    top = int(InferenceModel(eng)(clip).argmax())
    os.makedirs(tmp_path / "npy")
    tnpy.save_npy_clip(str(tmp_path / "npy" / f"rgb_v@{labels[top].replace(' ', '_')}.npy"), clip)
    with contextlib.redirect_stdout(io.StringIO()):
        (path,) = tsingle.run(cfg, frames=frames, size=size, device="cpu")
    res = tresults.load_result(path)
    assert res["total_steps"] == 0 and np.isfinite(res["total_loss_l"]).all()
    assert res["final_delta"].shape == (frames, 1, 1, 3)
    assert res["adv_video"].shape == (1, frames, size, size, 3)


def test_wide_clips_stem_and_logits_as_in_jax(flax_vars, model):
    """A clip wider than 256 (W' = 129 at the packed stem, B1's segments on
    the card): the net up to MaxPool3d_2a, values and input gradient, as the
    JAX model's.  Above 224 the Logits head's 7x7 average pool leaves a map
    wider than 1, which neither package squeezes: both refuse it."""
    clip = np.random.default_rng(4).uniform(-1, 1, (1, 4, 16, 258, 3)).astype(np.float32)
    jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32, final_endpoint="MaxPool3d_2a_3x3")
    g = np.random.default_rng(5).normal(size=(1, 2, 4, 65, 64)).astype(np.float32)

    @jax.jit
    def value_and_dx(x, g):
        want, vjp = jax.vjp(lambda q: jm.apply(flax_vars, q)[0], x)
        return want, vjp(g)[0]

    want, want_dx = value_and_dx(jnp.asarray(clip), jnp.asarray(g))
    x = torch.from_numpy(clip).requires_grad_(True)
    got = model(x, final_endpoint="MaxPool3d_2a_3x3")[0]
    got.backward(torch.from_numpy(g))
    assert got.shape == want.shape == (1, 2, 4, 65, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    err = np.abs(x.grad.numpy() - np.asarray(want_dx)) / np.abs(np.asarray(want_dx)).max()
    assert err.max() < 1e-3 and (err < 1e-5).mean() > 0.999
    wide = np.zeros((1, 2, 232, 232, 3), np.float32)
    with pytest.raises(ValueError, match="squeez"):  # raised while tracing: no compute
        jax.eval_shape(lambda x: JaxI3D(num_classes=K, compute_dtype=jnp.float32).apply(
            flax_vars, x), jax.ShapeDtypeStruct(wide.shape, jnp.float32))
    with torch.no_grad(), pytest.raises(ValueError, match="squeezable"):
        model(torch.from_numpy(wide))

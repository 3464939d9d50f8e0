"""The port's vectorized per-video sweep (``engine/vector_sweep.py``) on the
CPU: held against the JAX package's ``engine/vector_sweep.py`` and against
the port's own sequential sweeps (``engine/sweep.fit_many_videos``,
``engine/loops.single_video_attack``), with its pieces: the per-slot
regularizers, metrics, losses and perturbations, kernel B7's and kernel B8's
per-clip plain forms, the slotted packed head, the slot step (also through
B8's per-clip form), the two runners' slots, and the sweep's spans and counts
with the benchmark's readers of them (``port_bench/spans.py``,
``port_bench/metrics/slot_useful_pct.py``).

The sweeps run on linear victims (the clip's mean colour times a fixed [3,
40] matrix), as the JAX package's tests/test_vector_sweep.py builds them, in
both packages; one tiny I3D (T=8, 16x16, f32) holds the packed head's slot
step.  The torch world's initial delta is drawn by threefry in the JAX
package and by a torch generator in the port, so a comparison with the JAX
sweep hands the port the JAX draw.  Tolerances, as the JAX file's: losses
atol 2e-5 / rtol 1e-4, delta histories 1e-4 absolute (the batched forward's
f32 reassociation); step counts, is_adversarial, escalations, ledgers and
result schemas exactly; the vmapped reductions against their per-clip forms
and the JAX vmap to 1e-6 relative, the engine's slot terms and the
elementwise functions bit for bit; B7's plain form bit for bit; B8's per-clip
plain form against the vmapped JAX kernel as tests/test_torch_port_fused_apply.py
holds the shared form (forward 1e-6 absolute, d(delta) 1e-5 absolute plus
1e-6 relative).
"""

import contextlib
import dataclasses
import io
import os
from collections import Counter
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import FlickerSpec as JFlickerSpec
from flickering_adversarial_video_tpu.attack import TorchStyleFlickerSpec as JSpec
from flickering_adversarial_video_tpu.attack import metrics as jmetrics
from flickering_adversarial_video_tpu.attack import regularizers as jreg
from flickering_adversarial_video_tpu.engine import AttackConfig as JConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JFlags
from flickering_adversarial_video_tpu.engine import vector_sweep as jvs
from flickering_adversarial_video_tpu.ops import stem_tmajor as jst
from flickering_adversarial_video_tpu.ops.fused_apply import _supported as jfused_supported
from flickering_adversarial_video_tpu.ops.fused_apply import fused_normalize_perturb as jfused
from flickering_adversarial_video_tpu_torch.attack import FlickerSpec, SparseSpec
from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
from flickering_adversarial_video_tpu_torch.attack import metrics as tmetrics
from flickering_adversarial_video_tpu_torch.attack import perturbation as tpert
from flickering_adversarial_video_tpu_torch.attack import regularizers as treg
from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
from flickering_adversarial_video_tpu_torch.data import video_dataset as tvd
from flickering_adversarial_video_tpu_torch.engine import (
    AttackConfig, AttackEngine, AttackState, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.engine import attack_step as tattack_step
from flickering_adversarial_video_tpu_torch.engine import loops as tloops
from flickering_adversarial_video_tpu_torch.engine import sweep as tsweep
from flickering_adversarial_video_tpu_torch.engine import vector_sweep as tvs
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.ops import fused_apply, packed_apply
from flickering_adversarial_video_tpu_torch.parallel.mesh import Mesh
from flickering_adversarial_video_tpu_torch.runners import common as tcommon
from flickering_adversarial_video_tpu_torch.runners import single_video as tsingle
from flickering_adversarial_video_tpu_torch.runners import torch_per_video as tper_video
from flickering_adversarial_video_tpu_torch.utils import config as tconfig
from flickering_adversarial_video_tpu_torch.utils.labels import kinetics400_labels
from flickering_adversarial_video_tpu_torch.viz.results import load_result
from port_bench import spans as bench_spans
from port_bench import trace as bench_trace
from port_bench.metrics import slot_useful_pct

FRAMES, SIZE, K = 4, 8, 40
N_ITER = 6
LABEL_NAMES = [f"class {i}" for i in range(K)]
MEANSTD = dict(norm_world="meanstd", reg_weighting="torch")
W = (np.random.default_rng(11).standard_normal((3, K)) * 3.0).astype(np.float32)
LOSS_TOL = dict(atol=2e-5, rtol=1e-4)


class LinearVictim(torch.nn.Module):
    """logits = mean over (T, H, W) of the normalized clip @ w."""

    def __init__(self, w=W):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(np.asarray(w)))

    def forward(self, x):
        return x.mean(dim=(1, 2, 3)) @ self.w


def meanstd_engines(max_norm=0.2, w=W):
    """(JAX engine, port engine) of the mean/std world on the linear victim."""
    je = JEngine(lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"], {"w": jnp.asarray(w)},
                 JSpec(frames=FRAMES, max_norm=max_norm), JConfig(**MEANSTD), track_probs=False)
    te = AttackEngine(LinearVictim(w), TorchStyleFlickerSpec(FRAMES, max_norm=max_norm),
                      AttackConfig(**MEANSTD), track_probs=False)
    return je, te


def tanh_engines(**config):
    """(JAX engine, port engine) of the tanh world on the linear victim."""
    je = JEngine(lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"], {"w": jnp.asarray(W)},
                 JFlickerSpec(frames=FRAMES), JConfig(), track_probs=True)
    te = AttackEngine(LinearVictim(), FlickerSpec(FRAMES), AttackConfig(**config),
                      track_probs=True)
    return je, te


def self_labelled(n, seed=17):
    """`n` batches of one uint8 clip labelled with the linear victim's clean
    prediction (numpy, as both engines normalize)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        video = rng.integers(0, 255, (1, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
        x = (video.astype(np.float32) / 255.0 - np.float32(tvd.DEFAULT_MEAN)) / np.float32(
            tvd.DEFAULT_STD)
        labels = (x.mean(axis=(1, 2, 3)) @ W).argmax(-1)
        out.append({"video": video, "labels": labels.astype(np.int64), "paths": [f"v{i}.mp4"]})
    return out


def tanh_clips(n, seed=23):
    """`n` float clips [T,H,W,3] in [-1, 1] and their clean classes."""
    rng = np.random.default_rng(seed)
    clips = [rng.uniform(-1, 1, (FRAMES, SIZE, SIZE, 3)).astype(np.float32) for _ in range(n)]
    return clips, [int((c.mean(axis=(0, 1, 2)) @ W).argmax()) for c in clips]


@pytest.fixture
def jax_draw(monkeypatch):
    """The port's per-video re-init draws what the JAX sweep draws."""
    def draw(shape, seed, init_scale):
        key = jax.random.fold_in(jax.random.key(seed), 1)
        u = jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)
        return torch.from_numpy(np.array(u * init_scale))

    monkeypatch.setattr(tsweep, "draw_init_delta", draw)


def _load(model_dir, batch):
    name = LABEL_NAMES[int(batch["labels"][0])]
    return np.load(tsweep.result_path_for(model_dir, batch["paths"][0], name),
                   allow_pickle=True).tolist()


def _sweep_results_match(got, want):
    """Two per-video results of the torch world: schema, counters exactly;
    histories at the vector sweep's tolerances."""
    assert set(got) == set(want)
    assert len(got["loss/total"]) == len(want["loss/total"])
    assert list(got["is_adversarial"]) == list(want["is_adversarial"])
    assert got["escalations"] == want["escalations"]
    np.testing.assert_allclose(got["final_max_norm"], want["final_max_norm"], rtol=1e-6)
    for k in tsweep.HISTORY:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(np.asarray(got["perturbation"]),
                               np.asarray(want["perturbation"]), atol=1e-4)
    np.testing.assert_array_equal(got["label"], want["label"])


def _single_results_match(got, want):
    """Two single-video results: schema and counters exactly, histories at
    the vector sweep's tolerances."""
    assert got is not None and want is not None and set(got) == set(want)
    assert got["total_steps"] == want["total_steps"]
    assert got["is_adversarial"] == want["is_adversarial"]
    assert len(got["total_loss_l"]) == len(want["total_loss_l"])
    for k in ("total_loss_l", "adv_loss_l", "reg_loss_l", "norm_reg_loss_l",
              "diff_norm_reg_loss_l", "fatness", "smoothness"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)
    for k in ("perturbation", "softmax", "adv_video", "final_delta"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=1e-4,
                                   err_msg=k)


# ---------------- the per-slot functions ----------------

SLOT_FORMS = [
    (treg.thinness_reg, jreg.thinness_reg),
    (treg.first_order_diff_reg, jreg.first_order_diff_reg),
    (treg.second_order_diff_reg, jreg.second_order_diff_reg),
    (treg.l12_regularizer, jreg.l12_regularizer),
    (tmetrics.thickness, jmetrics.thickness),
    (tmetrics.roughness, jmetrics.roughness),
]


class TestSlotFunctions:
    @pytest.mark.parametrize("clip_fn,jax_fn", SLOT_FORMS, ids=[f[0].__name__ for f in SLOT_FORMS])
    @pytest.mark.parametrize("shape", [(FRAMES, 1, 1, 3), (FRAMES, 2, 3, 3)])
    def test_each_slot_reduces_its_own_delta(self, clip_fn, jax_fn, shape):
        """The slot step's form (the function vmapped over the slots): slot
        i's value is the function of delta[i], and the JAX function vmapped
        over the slots."""
        d = np.random.default_rng(5).normal(size=(3,) + shape).astype(np.float32) * 0.1
        got = torch.func.vmap(clip_fn)(torch.from_numpy(d)).numpy()
        assert got.shape == (3,)
        want = np.stack([clip_fn(torch.from_numpy(x)).numpy() for x in d])
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jax.vmap(jax_fn)(jnp.asarray(d))), rtol=1e-6)

    @pytest.mark.parametrize("targeted", [False, True])
    @pytest.mark.parametrize("improve,use_logits", [(True, False), (True, True), (False, False)])
    def test_loss_and_verdict_a_slot(self, targeted, improve, use_logits):
        """A slot's terms (``AttackEngine._slot_terms``) are its own clip's
        (a batch of one with its own delta): what ``_terms`` gives that clip
        alone, bit for bit; its verdict that clip's."""
        rng = np.random.default_rng(7)
        logits = torch.from_numpy(rng.normal(size=(4, K)).astype(np.float32))
        labels = torch.tensor([0, 3, 5, 3])
        delta = torch.from_numpy(rng.normal(size=(4, FRAMES, 1, 1, 3)).astype(np.float32) * 0.1)
        engine = AttackEngine(LinearVictim(), FlickerSpec(FRAMES), AttackConfig(
            improve_loss=improve, targeted=targeted, use_logits=use_logits))
        scalars = engine._step_scalars(RuntimeFlags(), 0)
        total, terms = engine._slot_terms(logits, labels, delta, scalars)
        assert total.shape == (4,) and terms["probs"].shape == (4, K)
        for i in range(4):
            one_total, one = engine._terms(logits[i:i + 1], labels[i:i + 1], delta[i], scalars)
            assert float(total[i]) == float(one_total)
            for k, v in one.items():
                assert torch.equal(terms[k][i], v.reshape(terms[k][i].shape)), k
        probs = torch.softmax(logits, -1)
        verdict = torch.func.vmap(lambda p, lb: tmetrics.is_adversarial(
            p, lb, targeted=targeted))(probs[:, None], labels[:, None])
        assert [bool(v) for v in verdict] == [
            bool(tmetrics.is_adversarial(probs[i:i + 1], labels[i:i + 1], targeted=targeted))
            for i in range(4)]

    @pytest.mark.parametrize("cyclic", [False, True])
    def test_tanh_perturbation_a_slot(self, cyclic):
        """apply_perturbation on slotted deltas [N, *spec.shape] with per-slot
        shifts equals each clip perturbed on its own, bit for bit."""
        rng = np.random.default_rng(3)
        spec = FlickerSpec(FRAMES)
        clean = torch.from_numpy(rng.uniform(-1, 1, (3, FRAMES, 2, 2, 3)).astype(np.float32))
        delta = torch.from_numpy(rng.uniform(-0.6, 0.6, (3,) + spec.shape).astype(np.float32))
        mask = tpert.frame_mask(FRAMES, 1, 2)
        shifts = None
        if cyclic:
            shifts = tpert.roll_shifts(torch.tensor([3, 4, 5]), torch.tensor([1, 1, 7]), FRAMES,
                                       FRAMES)
        got = tpert.apply_perturbation(clean, delta, spec, mask=mask, cyclic_flag=0.5,
                                       cyclic_pert_flag=1.0, shifts=shifts)
        for i in range(3):
            one = None if shifts is None else (shifts[0][i], shifts[1][i])
            want = tpert.apply_perturbation(clean[i:i + 1], delta[i], spec, mask=mask,
                                            cyclic_flag=0.5, cyclic_pert_flag=1.0, shifts=one)
            assert torch.equal(got[i:i + 1], want)

    @pytest.mark.parametrize("cyclic", [False, True])
    def test_meanstd_perturbation_a_slot(self, cyclic):
        """apply_perturbation_torch_style with a per-slot max_norm [N]: each
        clip clamped to its own bound, bit for bit."""
        rng = np.random.default_rng(4)
        spec = TorchStyleFlickerSpec(FRAMES)
        clean = torch.from_numpy(rng.normal(size=(3, FRAMES, 2, 2, 3)).astype(np.float32))
        delta = torch.from_numpy(rng.uniform(-0.3, 0.3, (3,) + spec.shape).astype(np.float32))
        max_norm = torch.tensor([0.05, 0.2, 0.1])
        shift = torch.tensor([1, 0, 3]) if cyclic else None
        got = tpert.apply_perturbation_torch_style(clean, delta, spec, max_norm=max_norm,
                                                   cyclic_pert_flag=1.0, shift=shift)
        for i in range(3):
            want = tpert.apply_perturbation_torch_style(
                clean[i:i + 1], delta[i], spec, max_norm=max_norm[i], cyclic_pert_flag=1.0,
                shift=None if shift is None else shift[i])
            assert torch.equal(got[i:i + 1], want)

    def test_roll_shifts_a_slot(self):
        seeds, counters = torch.tensor([0, 7, 7, 123]), torch.tensor([1, 1, 2, 40])
        inp, pert = tpert.roll_shifts(seeds, counters, 90, 45)
        for i in range(4):
            one = tpert.roll_shifts(seeds[i], counters[i], 90, 45)
            assert (int(inp[i]), int(pert[i])) == (int(one[0]), int(one[1]))
        with pytest.raises(ValueError, match="axis 1"):
            tpert.roll_time(torch.zeros(2, 3, 4), torch.tensor([1, 2]), axis=2)


# ---------------- kernel B7's per-clip form and the slotted packed head ----------------

class TestEmitB7PerClip:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_plain_form_bit_equal_with_pallas_interpret(self, dtype):
        """The per-clip plain form against emit_tmajor in interpret mode fed
        each clip's own dl in its lanes (lane t'*B + b), with a bound hit:
        u8 0 under dl 0 is exactly lo, mask 1."""
        rng = np.random.default_rng(11)
        b, t, h, w, c = 3, 4, 6, 8, 24
        u8 = rng.integers(0, 256, (b, t, h, w, c), dtype=np.uint8)
        u8[1, 0, 0, 0, 0] = 0
        dl = rng.uniform(-0.3, 0.3, (b, t, c)).astype(np.float32)
        dl[1, :, 0] = 0.0
        lanes = np.ascontiguousarray(dl.transpose(2, 1, 0)).reshape(c, t * b)
        want_adv, want_mask = jst.emit_tmajor(jnp.asarray(u8), jnp.asarray(lanes), -1.0, 1.0,
                                              dtype, interpret=True)
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        adv, mask = packed_apply.emit_adv_mask(torch.from_numpy(u8), torch.from_numpy(dl),
                                               -1.0, 1.0, tdt)
        assert packed_apply.emit_adv_mask.clip_launches == 0  # CPU: the plain version

        def view(x):
            hh, ww, cc, tb = x.shape
            return np.asarray(x).reshape(hh, ww, cc, tb // b, b).transpose(4, 3, 0, 1, 2)

        np.testing.assert_array_equal(adv.float().numpy(), view(np.asarray(want_adv, np.float32)))
        np.testing.assert_array_equal(mask.numpy(), view(want_mask))
        assert (mask.numpy()[1] == 1).any()

    def test_equals_the_shared_form_when_every_clip_has_one_delta(self):
        rng = np.random.default_rng(12)
        u8 = torch.from_numpy(rng.integers(0, 256, (3, 2, 4, 4, 24), dtype=np.uint8))
        dl = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 24)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            shared = packed_apply.emit_adv_mask(u8, dl, -1.0, 1.0, dtype)
            clips = packed_apply.emit_adv_mask(u8, dl.expand(3, 2, 24), -1.0, 1.0, dtype)
            assert torch.equal(shared[0], clips[0]) and torch.equal(shared[1], clips[1])

    def test_operand_checks(self):
        u8 = torch.zeros(2, 2, 2, 2, 24, dtype=torch.uint8)
        with pytest.raises(ValueError, match="dl"):
            packed_apply.emit_adv_mask(u8, torch.zeros(3, 2, 24), -1.0, 1.0, torch.float32)
        with pytest.raises(TypeError):
            packed_apply.emit_adv_mask(u8.float(), torch.zeros(2, 2, 24), -1.0, 1.0,
                                       torch.float32)

    def test_slotted_head_gradient_equals_per_clip_runs(self):
        """flicker_stem with a delta a clip [N,T,1,1,C]: its output, d(delta)
        and d(flag) equal each clip run alone with its own delta (d(flag)
        summed), in f32."""
        rng = np.random.default_rng(13)
        n, t = 3, 4
        u8 = torch.from_numpy(rng.integers(0, 256, (n, t // 2, 4, 4, 24), dtype=np.uint8))
        u8[0, 0, 0, 0, 0] = 0  # a clip-bound hit: the half gradient
        pk = torch.from_numpy(rng.normal(size=(4, 4, 4, 24, 64)).astype(np.float32) * 0.1)
        mean = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        var = torch.from_numpy(rng.uniform(0.5, 2.0, 64).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        delta = torch.from_numpy(rng.uniform(-0.4, 0.4, (n, t, 1, 1, 3)).astype(np.float32))
        delta[0, :, :, :, 0] = 0.0
        g = torch.from_numpy(rng.normal(size=(n, t // 2, 4, 4, 64)).astype(np.float32))

        def run(u, d, g):
            d = d.clone().requires_grad_(True)
            flag = torch.ones((), requires_grad=True)
            y = packed_apply.flicker_stem(u, d, flag, pk, mean, var, bias,
                                          out_dtype=torch.float32)
            dd, df = torch.autograd.grad((y * g).sum(), (d, flag))
            return y.detach(), dd, df

        y, dd, df = run(u8, delta, g)
        assert dd.shape == (n, t, 1, 1, 3)
        flags = 0.0
        for i in range(n):
            yi, ddi, dfi = run(u8[i:i + 1], delta[i], g[i:i + 1])
            np.testing.assert_allclose(y[i:i + 1].numpy(), yi.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(dd[i].numpy(), ddi.numpy(), rtol=1e-5, atol=1e-6)
            flags += float(dfi)
        np.testing.assert_allclose(float(df), flags, rtol=1e-5)


class TestFusedB8PerClip:
    """B8c: kernel B8 with a delta a clip ([S,T,1,1,C]), the JAX sweep's
    ``jax.vmap`` of ``fused_normalize_perturb`` over the slots (a clip a
    call, the flag shared), held where the JAX call takes its Pallas kernel
    (B = 1: T % 8 == 0, H*W*C % 128 == 0), in interpret mode off the TPU,
    and where it runs ``_jnp_reference`` (T = 6), whose gradient is
    jnp.clip's half at an exact bound."""

    S, T, H, W, C = 3, 8, 16, 16, 3

    def _data(self, seed=31):
        rng = np.random.default_rng(seed)
        video = rng.integers(0, 256, (self.S, self.T, self.H, self.W, self.C), dtype=np.uint8)
        delta = (rng.normal(size=(self.S, self.T, 1, 1, self.C)) * 0.5).astype(np.float32)
        video[1, 2, 3, 4, 0], delta[1, 2, 0, 0, 0] = 0, 0.0  # exactly on -1: 0 gradient
        return video, delta

    @staticmethod
    def _jax(flag):
        return jax.vmap(lambda x, d: jfused(x[None], d, jnp.float32(flag))[0])

    @pytest.mark.parametrize("flag", [1.0, 0.0])
    def test_plain_form_against_vmapped_pallas_interpret(self, flag):
        video, delta = self._data()
        assert jfused_supported((1,) + video.shape[1:])
        fn = self._jax(flag)
        want = fn(jnp.asarray(video), jnp.asarray(delta))
        got = fused_apply.fused_normalize_perturb(torch.from_numpy(video),
                                                  torch.from_numpy(delta), torch.tensor(flag))
        assert fused_apply.fused_apply_fwd.clip_launches == 0  # CPU: the plain version
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)

        def loss(d):
            out = fn(jnp.asarray(video), d)
            return jnp.sum(out * jnp.cos(out))

        want_dd = np.asarray(jax.grad(loss)(jnp.asarray(delta)))
        d = torch.from_numpy(delta).requires_grad_(True)
        out = fused_apply.fused_normalize_perturb(torch.from_numpy(video), d, torch.tensor(flag))
        (out * torch.cos(out)).sum().backward()
        assert d.grad.shape == delta.shape
        if flag:
            assert np.abs(want_dd).max() > 1.0
        np.testing.assert_allclose(d.grad.numpy(), want_dd, atol=1e-5, rtol=1e-6)

    def test_plain_form_against_the_vmapped_reference(self):
        """At S=2, T=6, 16x16x3 the JAX per-clip call runs _jnp_reference:
        B8c's d(delta) is jnp.clip's, black pixels under delta 0 counting
        half (exact on the integer sum; within 1e-5 of the largest component
        with a wavy g); strict=True takes the halves away."""
        s, t, h, w, c = 2, 6, 16, 16, 3
        rng = np.random.default_rng(35)
        video = rng.integers(0, 256, (s, t, h, w, c), dtype=np.uint8)
        delta = (rng.normal(size=(s, t, 1, 1, c)) * 0.5).astype(np.float32)
        video[1, 2, 3, 4, 0] = video[1, 2, 5, 6, 0] = 0
        delta[1, 2, 0, 0, 0] = 0.0
        black = int((video[1, 2, :, :, 0] == 0).sum())
        assert black >= 2
        assert not jfused_supported((1, t, h, w, c)) and not fused_apply.strict_rule((1, t, h, w, c))
        fn = self._jax(1.0)
        jv, jd, u8 = jnp.asarray(video), jnp.asarray(delta), torch.from_numpy(video)
        out = fused_apply.fused_normalize_perturb(u8, torch.from_numpy(delta), torch.tensor(1.0))
        np.testing.assert_allclose(out.numpy(), np.asarray(fn(jv, jd)), atol=1e-6, rtol=0)

        def port(loss, **kw):
            d = torch.from_numpy(delta).requires_grad_(True)
            loss(fused_apply.fused_normalize_perturb(u8, d, torch.tensor(1.0), **kw)).backward()
            return d.grad.numpy()

        summed = np.asarray(jax.grad(lambda d: jnp.sum(fn(jv, d)))(jd))
        np.testing.assert_array_equal(port(torch.sum), summed)
        strict = port(torch.sum, strict=True)
        assert strict[1, 2, 0, 0, 0] == summed[1, 2, 0, 0, 0] - 0.5 * black
        wavy = np.asarray(jax.grad(lambda d: jnp.sum(jnp.sin(3 * fn(jv, d))))(jd))
        np.testing.assert_allclose(port(lambda o: torch.sin(3 * o).sum()), wavy,
                                   atol=1e-5 * np.abs(wavy).max(), rtol=0)

    def test_fused_slot_step_against_the_jax_sweep(self):
        """The slot step with use_pallas_fused at T=6, 16x16 (the JAX per-clip
        call runs _jnp_reference) from delta 0, the reference stop rule's
        start, with 9 black pixels a clip exactly on -1: Adam's first moment
        (0.1 d(delta)), second moment and the new delta against the JAX
        sweep's vmapped per-clip step (1e-4 relative, the file's loss
        tolerance: the two packages' f32 losses round apart by ~1e-5; 2e-4
        for the square); the kernel's strict rule in its place misses the
        half by 1.8%."""
        t, size = 6, 16
        je = JEngine(lambda v, x: jnp.mean(x, axis=(1, 2, 3)) @ v["w"], {"w": jnp.asarray(W)},
                     JFlickerSpec(frames=t), JConfig(use_pallas_fused=True), track_probs=True)
        jvse = jvs.VectorSweepEngine(je, 2, stop="reference")
        slots = jvse.init_slots([0, 1])
        rng = np.random.default_rng(36)
        videos = rng.integers(1, 256, (2, t, size, size, 3), dtype=np.uint8)
        videos[:, 1, :3, :3, 2] = 0
        labels = LinearVictim()(torch.from_numpy(videos).float() / 128.0 - 1.0).argmax(-1)
        step = jax.vmap(jvse._per_clip_step, in_axes=(0, 0, 0, 0, 0, 0, 0, None))
        jd, jopt, _ = step(slots.delta, slots.opt_state, jnp.asarray(videos),
                           jnp.asarray(labels.numpy()), jax.random.split(jax.random.key(0), 2),
                           jnp.ones(2), jnp.ones(2, bool), JFlags())
        adam = jopt.inner_state[0]

        te = AttackEngine(LinearVictim(), FlickerSpec(t), AttackConfig(use_pallas_fused=True),
                          track_probs=True)

        def port_step():
            zeros = torch.zeros((2,) + tuple(te.spec.shape))
            video, packed, lab = te.prepare_batch({"video": torch.from_numpy(videos),
                                                   "labels": labels})
            return te._slot_step(zeros, zeros, zeros, torch.zeros(2, dtype=torch.int32), video,
                                 packed, lab, te._step_scalars(RuntimeFlags(), 0).clone(),
                                 torch.ones(2), torch.arange(2), torch.ones(2, dtype=torch.bool))[0]

        nd, nmu, nnu, _ = port_step()
        mu = np.asarray(adam.mu)
        assert np.abs(mu[:, 1, 0, 0, 2]).min() > 1e-3 * np.abs(mu).max()
        np.testing.assert_allclose(nmu.numpy(), mu, rtol=1e-4, atol=0)
        np.testing.assert_allclose(nnu.numpy(), np.asarray(adam.nu), rtol=2e-4, atol=0)
        np.testing.assert_allclose(nd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-9)
        with mock.patch.object(tattack_step, "strict_rule", lambda shape: True):
            strict_mu = port_step()[1].numpy()
        off = np.abs(strict_mu - mu)[:, 1, 0, 0, 2] / np.abs(mu[:, 1, 0, 0, 2])
        assert off.min() > 1e-2  # 4.5 of 256 pixels

    def test_each_clip_is_the_shared_form_on_that_clip(self):
        """A clip's forward and d(delta) are the shared-delta B8's on that
        clip alone, bit for bit; one delta for every clip gives the shared
        form's forward."""
        video, delta = self._data(32)
        u8, dl = torch.from_numpy(video), torch.from_numpy(delta)
        flag = torch.tensor(0.7)
        g = torch.from_numpy(np.random.default_rng(33).normal(size=video.shape).astype(np.float32))
        fwd = fused_apply.fused_apply_fwd(u8, dl, flag)
        dd = fused_apply.fused_apply_bwd(u8, dl, flag, g)
        for i in range(self.S):
            assert torch.equal(fwd[i:i + 1], fused_apply.fused_apply_fwd(u8[i:i + 1], dl[i], flag))
            assert torch.equal(dd[i], fused_apply.fused_apply_bwd(u8[i:i + 1], dl[i], flag,
                                                                   g[i:i + 1]))
        one = dl[:1].expand_as(dl)
        assert torch.equal(fused_apply.fused_apply_fwd(u8, one, flag),
                           fused_apply.fused_apply_fwd(u8, dl[0], flag))

    def test_operand_checks(self):
        u8 = torch.zeros(2, 4, 2, 2, 3, dtype=torch.uint8)
        with pytest.raises(ValueError, match="delta"):
            fused_apply.fused_apply_fwd(u8, torch.zeros(3, 4, 1, 1, 3), torch.tensor(1.0))
        with pytest.raises(ValueError, match="delta"):
            fused_apply.fused_apply_bwd(u8, torch.zeros(2, 4, 1, 2, 3), torch.tensor(1.0),
                                        torch.zeros(2, 4, 2, 2, 3))
        with pytest.raises(TypeError):
            fused_apply.fused_apply_fwd(u8.float(), torch.zeros(2, 4, 1, 1, 3), torch.tensor(1.0))
        with pytest.raises(ValueError, match="g "):
            fused_apply.fused_apply_bwd(u8, torch.zeros(2, 4, 1, 1, 3), torch.tensor(1.0),
                                        torch.zeros(1, 4, 2, 2, 3))

    def test_fused_slot_step_is_each_clips_step(self):
        """use_pallas_fused on uint8 clips: each slot's new delta, moments and
        losses are its clip's own fused step's (B8 on that clip alone)."""
        te = AttackEngine(LinearVictim(), FlickerSpec(FRAMES), AttackConfig(use_pallas_fused=True),
                          track_probs=True)
        rng = np.random.default_rng(34)
        videos = torch.from_numpy(rng.integers(0, 256, (3, FRAMES, SIZE, SIZE, 3),
                                               dtype=np.uint8))
        labels = LinearVictim()(videos.float() / 128.0 - 1.0).argmax(-1)
        assert not te.prepare_batch({"video": videos, "labels": labels})[1]  # unpacked
        _slot_step_matches_sequential(te, videos, labels, [1.0] * 3, [0, 1, 2],
                                      [True, True, False])


# ---------------- the slot step ----------------

def _slot_state(engine, n, rng, counts):
    shape = (n,) + tuple(engine.spec.shape)
    delta = torch.from_numpy(rng.uniform(-0.01, 0.01, shape).astype(np.float32))
    mu = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 1e-3)
    nu = torch.from_numpy(rng.uniform(0, 1e-6, shape).astype(np.float32))
    return delta, mu, nu, torch.tensor(counts, dtype=torch.int32)


def _slot_step_matches_sequential(engine, videos, labels, max_norms, seeds, active,
                                  flags=RuntimeFlags(), rtol=1e-6, atol=1e-7):
    """engine._slot_step against one _step a slot (each clip a batch of
    one, the slot's max_norm and seed in the flags), inactive slots frozen."""
    n = len(labels)
    delta, mu, nu, count = _slot_state(engine, n, np.random.default_rng(9), [0, 3, 11][:n])
    scalars = engine._step_scalars(flags, 0).clone()
    video, packed, lab = engine.prepare_batch({"video": videos, "labels": labels})
    (nd, nmu, nnu, ncount), m = engine._slot_step(
        delta, mu, nu, count, video, packed, lab, scalars, torch.tensor(max_norms),
        torch.tensor(seeds), torch.tensor(active))
    for i in range(n):
        state = AttackState(delta[i].clone(), mu[i].clone(), nu[i].clone(), int(count[i]))
        new, mi = engine._train_step(state, *engine.prepare_batch(
            {"video": videos[i:i + 1], "labels": labels[i:i + 1]}),
            dataclasses.replace(flags, max_norm=max_norms[i]), seeds[i])
        if not active[i]:
            new = AttackState(delta[i], mu[i], nu[i], int(count[i]))
        for got, want in ((nd[i], new.delta), (nmu[i], new.mu), (nnu[i], new.nu)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol)
        assert int(ncount[i]) == new.step
        for k in ("total_loss", "adv_loss", "reg_loss", "norm_reg", "thickness", "roughness",
                  "prob_to_min"):
            np.testing.assert_allclose(float(m[k][i]), float(mi[k]), rtol=rtol * 10, atol=atol,
                                       err_msg=k)
        assert bool(m["is_adversarial"][i]) == bool(mi["is_adversarial"])


class TestSlotStep:
    @pytest.mark.parametrize("cyclic", [False, True])
    def test_tanh_slot_step_is_each_clips_step(self, cyclic):
        _, te = tanh_engines(enable_cyclic=cyclic)
        clips, labels = tanh_clips(3)
        videos = torch.from_numpy(np.stack(clips))
        flags = RuntimeFlags(cyclic_flag=1.0, cyclic_pert_flag=1.0) if cyclic else RuntimeFlags()
        _slot_step_matches_sequential(te, videos, torch.tensor(labels), [0.2] * 3, [0, 5, 9],
                                      [True, False, True], flags)

    def test_meanstd_slot_step_clips_each_to_its_max_norm(self):
        _, te = meanstd_engines()
        batches = self_labelled(3)
        videos = torch.from_numpy(np.concatenate([b["video"] for b in batches]))
        labels = torch.from_numpy(np.concatenate([b["labels"] for b in batches]))
        _slot_step_matches_sequential(te, videos, labels, [0.002, 0.2, 0.0013], [0, 1, 2],
                                      [True, True, False])

    def test_packed_i3d_slot_step_is_each_clips_step(self):
        """A tiny I3D (T=8, 16x16, f32) on uint8 clips: the packed head with
        B7's per-clip form; each slot's new delta, moments and losses are
        its clip's own step's."""
        k, frames, size = 7, 8, 16
        model = InceptionI3D(k, torch.float32, device="cpu")
        model.load_state_dict(init_i3d_state(2, num_classes=k))
        engine = AttackEngine(model, FlickerSpec(frames), AttackConfig(), track_probs=False)
        rng = np.random.default_rng(3)
        videos = torch.from_numpy(rng.integers(0, 256, (2, frames, size, size, 3),
                                               dtype=np.uint8))
        assert engine.prepare_batch({"video": videos, "labels": torch.zeros(2)})[1]  # packed
        _slot_step_matches_sequential(engine, videos, torch.tensor([1, 4]), [1.0, 1.0], [0, 1],
                                      [True, True], rtol=1e-5, atol=1e-6)


    def test_fused_kernel_with_slots_raises(self):
        """use_pallas_fused on uint8 clips: the slot step takes B8's per-clip
        form (it refused before B8c existed); a chunk gives what the generic
        path gives (no clip sits on a bound here), and a float clip takes
        the generic path, as without slots."""
        fused = AttackEngine(LinearVictim(), FlickerSpec(FRAMES),
                             AttackConfig(use_pallas_fused=True))
        plain = AttackEngine(LinearVictim(), FlickerSpec(FRAMES), AttackConfig())
        clips = np.random.default_rng(2).integers(1, 256, (2, FRAMES, SIZE, SIZE, 3),
                                                  dtype=np.uint8)
        args = (torch.zeros(2, dtype=torch.long), torch.arange(2), RuntimeFlags(), 2)
        runs = []
        for te in (fused, plain):
            vse = tvs.VectorSweepEngine(te, 2, n_iter=2, stop="reference")
            state = vse.init_slots()
            for i in range(2):
                vse.refill_slot(state, i, i, 0.2)
            runs.append(vse.run_chunk(state, torch.from_numpy(clips), *args)[1])
        assert set(runs[0]) == set(runs[1]) and bool(runs[0]["active"].all())
        for k in runs[0]:
            np.testing.assert_allclose(runs[0][k].float().numpy(), runs[1][k].float().numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        vse = tvs.VectorSweepEngine(fused, 2, n_iter=2, stop="reference")
        state = vse.init_slots()
        for i in range(2):
            vse.refill_slot(state, i, i, 0.2)
        floats, _ = tanh_clips(2)
        state, ys = vse.run_chunk(state, torch.from_numpy(np.stack(floats)), *args)
        assert bool(ys["active"].all())


# ---------------- the engine and the two sweeps against the sequential port ----------------

class TestVectorSweepEngine:
    def test_mesh_and_stop_rule_and_slots_raise(self):
        _, te = meanstd_engines()
        two = Mesh(None, None, 1, 2, torch.device("cpu"))
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            tvs.VectorSweepEngine(te, 3, mesh=two)
        assert tvs.VectorSweepEngine(te, 4, mesh=two).slots == 2  # this rank's
        with pytest.raises(ValueError, match="stop rule"):
            tvs.VectorSweepEngine(te, 2, stop="never")
        with pytest.raises(ValueError, match="slots"):
            tvs.VectorSweepEngine(te, 0)

    def test_history_sizes_the_chunk_or_raises(self, monkeypatch):
        te = AttackEngine(LinearVictim(), SparseSpec(FRAMES, SIZE, SIZE), AttackConfig(
            attack_kind="sparse"))
        per_step = 4 * FRAMES * SIZE * SIZE * 3 * 4
        monkeypatch.setattr(tvs, "HISTORY_BYTES", 10 * per_step)
        vse = tvs.VectorSweepEngine(te, 4)
        assert vse.chunk_that_fits(64) == 10 and vse.chunk_that_fits(3) == 3
        monkeypatch.setattr(tvs, "HISTORY_BYTES", per_step - 1)
        assert tvs.VectorSweepEngine(te, 4, record_delta=False).chunk_that_fits(64) == 64
        with pytest.raises(ValueError, match="track_history"):
            vse.chunk_that_fits(64)

    def test_refill_park_and_frozen_slots(self):
        """A parked slot keeps its state through a chunk; a refilled one
        starts from its seed's draw with zero moments and counters, and the
        two counters part at an escalation."""
        w = np.zeros((3, K), np.float32)
        w[:, 0] = 100.0  # class 0 always: never fooled
        _, te = meanstd_engines(max_norm=0.05, w=w)
        vse = tvs.VectorSweepEngine(te, 2, n_iter=2)
        state = vse.init_slots()
        assert bool(state.done.all())
        vse.refill_slot(state, 0, 7, 0.05)
        vse.park_slot(state, 1)
        np.testing.assert_array_equal(state.delta[0].numpy(),
                                      tsweep.draw_init_delta(te.spec.shape, 7, 0.005).numpy())
        before = state.delta[1].clone()
        video = torch.from_numpy(self_labelled(1)[0]["video"]).expand(2, -1, -1, -1, -1)
        state, ys = vse.run_chunk(state, video.contiguous(), torch.zeros(2, dtype=torch.long),
                                  torch.zeros(2, dtype=torch.long), RuntimeFlags(max_norm=0.05), 5)
        assert ys["active"][:, 1].sum() == 0 and torch.equal(state.delta[1], before)
        # never fooled: steps 0, 1, 2, then an escalation resets the step
        # (to 0, then 2 steps) and not the count
        assert ys["active"][:, 0].all()
        assert int(state.chances[0]) == 1 and int(state.step[0]) == 2
        assert int(state.count[0]) == 5
        np.testing.assert_allclose(ys["max_norm"][:, 0].numpy(),
                                   [0.05] * 3 + [0.05 * 1.3] * 2, rtol=1e-15)


class TestAgainstSequentialPort:
    def test_fit_many_videos(self, tmp_path):
        _, te = meanstd_engines()
        batches = self_labelled(3)
        flags = RuntimeFlags(max_norm=0.2)
        seq = tsweep.fit_many_videos(te, batches, flags, model_dir=str(tmp_path / "s"),
                                     label_names=LABEL_NAMES, n_iter=N_ITER)
        vec = tvs.vector_fit_many_videos(te, batches, flags, model_dir=str(tmp_path / "v"),
                                         label_names=LABEL_NAMES, slots=2, chunk=5,
                                         n_iter=N_ITER)
        assert seq["attacked"] == vec["attacked"] == 3
        assert sorted(vec["results"]) == sorted((p.replace(str(tmp_path / "s"),
                                                           str(tmp_path / "v")), f)
                                                for p, f in seq["results"])
        for b in batches:
            _sweep_results_match(_load(str(tmp_path / "v"), b), _load(str(tmp_path / "s"), b))

    def test_escalation_unfoolable(self, tmp_path):
        """A victim that always predicts class 0 is never fooled: every
        chance escalates, as in the sequential sweep."""
        w = np.zeros((3, K), np.float32)
        w[:, 0] = 100.0
        _, te = meanstd_engines(max_norm=0.05, w=w)
        batch = {"video": self_labelled(1)[0]["video"], "labels": np.asarray([0]),
                 "paths": ["u.mp4"]}
        flags = RuntimeFlags(max_norm=0.05)
        tsweep.fit_many_videos(te, [batch], flags, model_dir=str(tmp_path / "s"),
                               label_names=LABEL_NAMES, n_iter=3, max_norm=0.05)
        tvs.vector_fit_many_videos(te, [batch], flags, model_dir=str(tmp_path / "v"),
                                   label_names=LABEL_NAMES, slots=2, chunk=4, n_iter=3,
                                   max_norm=0.05)
        s, v = _load(str(tmp_path / "s"), batch), _load(str(tmp_path / "v"), batch)
        assert s["escalations"] == v["escalations"] == 4
        assert len(v["loss/total"]) == 4 * (3 + 1)
        assert v["final_max_norm"] == s["final_max_norm"]
        np.testing.assert_allclose(v["final_max_norm"], 0.05 * 1.3 ** 4, rtol=1e-12)
        _sweep_results_match(v, s)

    @pytest.mark.parametrize("stop_rule", ["reference", "early"])
    def test_single_video_attacks(self, stop_rule):
        _, te = tanh_engines()
        clips, labels = tanh_clips(3)
        seq = [tloops.single_video_attack(te, c, l, RuntimeFlags(), max_step=5, seed=k,
                                          stop_rule=stop_rule)
               for k, (c, l) in enumerate(zip(clips, labels))]
        vec = tvs.vector_single_video_attacks(te, clips, labels, RuntimeFlags(), slots=2, chunk=4,
                                              max_step=5, stop_rule=stop_rule)
        for s, v in zip(seq, vec):
            _single_results_match(v, s)

    def test_cyclic_single_video_attacks(self):
        """Per-slot seeds draw the rolls the sequential loop draws (the
        clip's seed, its Adam count + 1)."""
        _, te = tanh_engines(enable_cyclic=True)
        flags = RuntimeFlags(cyclic_flag=1.0, cyclic_pert_flag=1.0)
        clips, labels = tanh_clips(2, seed=31)
        seq = [tloops.single_video_attack(te, c, l, flags, max_step=3, seed=s)
               for c, l, s in zip(clips, labels, (4, 9))]
        vec = tvs.vector_single_video_attacks(te, clips, labels, flags, slots=2, chunk=3,
                                              max_step=3, seeds=[4, 9])
        for s, v in zip(seq, vec):
            _single_results_match(v, s)

    def test_hard_cap_and_targeted(self):
        """A targeted attack with a hard cap of 4 steps: the result's steps
        and history are the sequential loop's."""
        _, te = tanh_engines(targeted=True)
        clips, labels = tanh_clips(1)
        target = (labels[0] + 1) % K
        kw = dict(max_step=1, hard_cap=4, target_label=target)
        s = tloops.single_video_attack(te, clips[0], labels[0], RuntimeFlags(), **kw)
        [v] = tvs.vector_single_video_attacks(te, clips, labels, RuntimeFlags(), slots=3,
                                              chunk=2, **kw)
        _single_results_match(v, s)

    def test_misclassified_slot_is_none(self):
        _, te = tanh_engines()
        clips, labels = tanh_clips(1)
        wrong = (labels[0] + 1) % K
        out = tvs.vector_single_video_attacks(te, clips * 2, [wrong, labels[0]], RuntimeFlags(),
                                              slots=2, chunk=3, max_step=2)
        assert out[0] is None and out[1]["correct_cls_id"] == labels[0]
        assert tvs.vector_single_video_attacks(te, clips, [wrong], RuntimeFlags(), slots=2) == [
            None]

    def test_ledger_skip_and_placeholder(self, tmp_path):
        _, te = meanstd_engines()
        batches = self_labelled(2)
        dest0 = tsweep.result_path_for(str(tmp_path), batches[0]["paths"][0],
                                       LABEL_NAMES[int(batches[0]["labels"][0])])
        np.save(dest0, {"is_adversarial": [True]})
        batches[1]["labels"] = (batches[1]["labels"] + 1) % K
        out = tvs.vector_fit_many_videos(te, batches, RuntimeFlags(max_norm=0.2),
                                         model_dir=str(tmp_path), label_names=LABEL_NAMES,
                                         slots=2, chunk=3, n_iter=2)
        assert (out["skipped_existing"], out["skipped_misclassified"], out["attacked"]) == (
            1, 1, 0)
        dest1 = tsweep.result_path_for(str(tmp_path), batches[1]["paths"][0],
                                       LABEL_NAMES[int(batches[1]["labels"][0])])
        assert np.load(dest1, allow_pickle=True).tolist() is None

    @pytest.mark.parametrize("slots,max_videos,attacked", [(2, 2, 2), (4, None, 3)])
    def test_max_videos_and_more_slots_than_videos(self, tmp_path, slots, max_videos, attacked):
        _, te = meanstd_engines()
        out = tvs.vector_fit_many_videos(te, self_labelled(3), RuntimeFlags(max_norm=0.2),
                                         model_dir=str(tmp_path), label_names=LABEL_NAMES,
                                         slots=slots, chunk=4, n_iter=2, max_videos=max_videos)
        assert out["attacked"] == attacked and len(out["results"]) == attacked

    def test_without_history(self, tmp_path):
        _, te = meanstd_engines()
        batches = self_labelled(1)
        flags = RuntimeFlags(max_norm=0.2)
        tsweep.fit_many_videos(te, batches, flags, model_dir=str(tmp_path / "s"),
                               label_names=LABEL_NAMES, n_iter=N_ITER)
        tvs.vector_fit_many_videos(te, batches, flags, model_dir=str(tmp_path / "v"),
                                   label_names=LABEL_NAMES, slots=2, chunk=4, n_iter=N_ITER,
                                   track_history=False)
        s, v = _load(str(tmp_path / "s"), batches[0]), _load(str(tmp_path / "v"), batches[0])
        assert set(v) == set(s) and v["loss/total"] == []
        assert v["is_adversarial"] == [s["is_adversarial"][-1]]
        np.testing.assert_allclose(v["perturbation"][0], s["perturbation"][-1], atol=1e-4)


# ---------------- spans and counts ----------------

def _sweep_call(world, tmp_path, window=contextlib.nullcontext):
    """One call of the world's sweep on the linear victim (3 clips, 2 slots,
    chunks of 3) inside `window()`: (each clip's result, the (slots, chunk)
    of each chunk run, the counts the call added)."""
    chunks = []
    run_chunk = tvs.VectorSweepEngine.run_chunk

    def spy(self, state, videos, labels, seeds, flags, chunk, **kw):
        chunks.append((self.slots, chunk))
        return run_chunk(self, state, videos, labels, seeds, flags, chunk, **kw)

    if world == "tanh":
        _, te = tanh_engines()
        clips, labels = tanh_clips(3)
    else:
        _, te = meanstd_engines()
        batches = self_labelled(3)
    before = tvs.sweep_counts()
    with mock.patch.object(tvs.VectorSweepEngine, "run_chunk", spy), window():
        if world == "tanh":
            res = tvs.vector_single_video_attacks(te, clips, labels, RuntimeFlags(), slots=2,
                                                  chunk=3, max_step=5)
        else:
            tvs.vector_fit_many_videos(te, batches, RuntimeFlags(max_norm=0.2),
                                       model_dir=str(tmp_path), label_names=LABEL_NAMES,
                                       slots=2, chunk=3, n_iter=N_ITER)
    if world != "tanh":
        res = [_load(str(tmp_path), b) for b in batches]
    after = tvs.sweep_counts()
    return res, chunks, {k: after[k] - before[k] for k in after}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


WORLDS = ("tanh", "meanstd")


class TestSpansAndCounts:
    @pytest.mark.parametrize("world", WORLDS)
    def test_a_call_shows_its_spans_one_after_another(self, world, tmp_path):
        prof = _profiled()
        res, chunks, counts = _sweep_call(world, tmp_path, lambda: prof)
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.name in tvs.SPANS)
        n = Counter(name for _, _, name in spans)
        assert n[tvs.CALL_SPAN] == 1
        assert n[tvs.CHUNK_SPAN] == n[tvs.READ_SPAN] == n[tvs.HISTORY_SPAN] == len(chunks) > 1
        assert n[tvs.RESULT_SPAN] == sum(r is not None for r in res) == 3
        # each slot filled at the start and again after each result: the
        # clips' refills and then a park a slot
        assert n[tvs.REFILL_SPAN] == n[tvs.CANDIDATE_SPAN] == 2 + 3
        assert n[tvs.REFILL_SPAN] == counts["refills"] + counts["parks"]
        (c0, c1, _), = [s for s in spans if s[2] == tvs.CALL_SPAN]
        children = [s for s in spans if s[2] != tvs.CALL_SPAN]
        assert c0 <= children[0][0] and children[-1][1] <= c1
        for (_, end, a), (start, _, b) in zip(children, children[1:]):
            assert end <= start, (a, b)

    @pytest.mark.parametrize("world", WORLDS)
    def test_a_call_counts_its_work(self, world, tmp_path):
        res, chunks, counts = _sweep_call(world, tmp_path)
        if world == "tanh":
            steps = [r["total_steps"] + 1 for r in res]
        else:
            steps = [len(r["loss/total"]) for r in res]
        assert counts == {
            "calls": 1, "chunks": len(chunks), "iterations": sum(c for _, c in chunks),
            "slot_iterations": sum(s * c for s, c in chunks), "live_slot_iterations": sum(steps),
            "refills": 3, "parks": 2, "results": 3}
        assert 0 < counts["live_slot_iterations"] < counts["slot_iterations"]

    @pytest.mark.parametrize("world", WORLDS)
    def test_results_are_the_same_under_the_profiler(self, world, tmp_path):
        plain, _, _ = _sweep_call(world, tmp_path / "plain")
        traced, _, _ = _sweep_call(world, tmp_path / "traced", _profiled)
        for p, t in zip(plain, traced):
            # steps_per_sec is the host clock's
            assert set(p) == set(t)
            for key in set(p) - {"steps_per_sec"}:
                np.testing.assert_equal(t[key], p[key], err_msg=key)

    def test_span_reader_on_a_cpu_profile(self, tmp_path):
        """With no device event in the window, the idle time inside a span
        is its time inside the window."""
        prof = _profiled()

        @contextlib.contextmanager
        def window():
            with prof, torch.profiler.record_function(bench_trace.WINDOW_SPAN):
                yield

        _sweep_call("tanh", tmp_path, window)
        got = bench_spans.read(prof)
        events = list(prof.events())
        [w] = [e for e in events if e.name == bench_trace.WINDOW_SPAN]
        want = {}
        for e in events:
            if e.name in tvs.SPANS:
                s = want.setdefault(e.name, {"n": 0, "host_s": 0.0})
                s["n"] += 1
                s["host_s"] += (min(e.time_range.end, w.time_range.end)
                                - max(e.time_range.start, w.time_range.start)) / 1e6
        assert set(got) == set(want) == set(tvs.SPANS)
        for name, s in got.items():
            assert s["n"] == want[name]["n"]
            np.testing.assert_allclose(s["host_s"], want[name]["host_s"], rtol=1e-12)
            np.testing.assert_allclose(s["idle_s"], s["host_s"], rtol=1e-12)
            assert s["bubble_s"] == 0.0  # one gap, the whole window
        assert bench_spans.program_spans() == tvs.SPANS + ("step_graph/capture",)

    def test_slot_useful_pct_reads_the_counts(self, tmp_path, monkeypatch):
        tvs.reset_sweep_counts()
        assert tvs.sweep_counts() == dict.fromkeys(tvs.COUNTS, 0)
        assert slot_useful_pct.read({"mix": "sweep"}) is None  # no sweep ran
        _, _, counts = _sweep_call("meanstd", tmp_path)
        assert slot_useful_pct.read({"mix": "sweep"}) == pytest.approx(
            100.0 * counts["live_slot_iterations"] / counts["slot_iterations"], rel=1e-12)
        assert slot_useful_pct.read({"mix": "universal"}) is None
        monkeypatch.delattr(tvs, "sweep_counts")  # a program without the counts
        assert slot_useful_pct.read({"mix": "sweep"}) is None


# ---------------- against the JAX package's vector sweep ----------------

class TestAgainstJax:
    def test_fit_many_videos(self, tmp_path, jax_draw):
        je, te = meanstd_engines()
        batches = self_labelled(3)
        kw = dict(label_names=LABEL_NAMES, slots=2, chunk=5, n_iter=N_ITER, max_norm=0.2)
        want = jvs.vector_fit_many_videos(je, batches, JFlags(max_norm=0.2),
                                          model_dir=str(tmp_path / "j"), **kw)
        got = tvs.vector_fit_many_videos(te, batches, RuntimeFlags(max_norm=0.2),
                                         model_dir=str(tmp_path / "t"), **kw)
        assert {k: v for k, v in got.items() if k != "results"} == {
            k: v for k, v in want.items() if k != "results"}
        assert sorted((os.path.basename(p), f) for p, f in got["results"]) == sorted(
            (os.path.basename(p), f) for p, f in want["results"])
        for b in batches:
            _sweep_results_match(_load(str(tmp_path / "t"), b), _load(str(tmp_path / "j"), b))

    def test_escalation_unfoolable(self, tmp_path, jax_draw):
        w = np.zeros((3, K), np.float32)
        w[:, 0] = 100.0
        je, te = meanstd_engines(max_norm=0.05, w=w)
        batch = {"video": self_labelled(1)[0]["video"], "labels": np.asarray([0]),
                 "paths": ["u.mp4"]}
        kw = dict(label_names=LABEL_NAMES, slots=2, chunk=4, n_iter=3, max_norm=0.05)
        jvs.vector_fit_many_videos(je, [batch], JFlags(max_norm=0.05),
                                   model_dir=str(tmp_path / "j"), **kw)
        tvs.vector_fit_many_videos(te, [batch], RuntimeFlags(max_norm=0.05),
                                   model_dir=str(tmp_path / "t"), **kw)
        got, want = _load(str(tmp_path / "t"), batch), _load(str(tmp_path / "j"), batch)
        assert got["escalations"] == want["escalations"] == 4
        _sweep_results_match(got, want)

    def test_single_video_attacks(self):
        je, te = tanh_engines()
        clips, labels = tanh_clips(3)
        kw = dict(slots=2, chunk=4, max_step=5)
        want = jvs.vector_single_video_attacks(je, clips, labels, JFlags(), **kw)
        got = tvs.vector_single_video_attacks(te, clips, labels, RuntimeFlags(), **kw)
        for g, w in zip(got, want):
            _single_results_match(g, w)


# ---------------- the runners' slots ----------------

LABELS_400 = kinetics400_labels()
W400 = (np.random.default_rng(5).standard_normal((3, 400)) * 4.0).astype(np.float32)


def _sv_setup(tmp_path, monkeypatch):
    """Three npy clips (the third misnamed) and the runner's victim patched
    with a 400-class linear one."""
    monkeypatch.setattr(tcommon, "build_victim",
                        lambda *a, device=None, **kw: LinearVictim(W400))
    d = tmp_path / "npy"
    d.mkdir()
    rng = np.random.default_rng(29)
    for i in range(3):
        x = rng.integers(0, 255, (FRAMES, 16, 16, 3), dtype=np.uint8).astype(
            np.float32) / 128.0 - 1.0
        cls = int((x.mean(axis=(0, 1, 2)) @ W400).argmax())
        cls = cls if i < 2 else (cls + 1) % 400
        np.save(d / f"rgb_vid{i}@{LABELS_400[cls].replace(' ', '_')}.npy", x[None])
    return str(d)


def _sv_cfg(npy_dir, out_dir, **over):
    cfg = tconfig.default_config()
    ac = cfg.SINGLE_VIDEO_ATTACK
    ac.NPY_PATH, ac.PKL_RESULT_PATH = npy_dir, str(out_dir)
    ac.COMPUTE_DTYPE, ac.MAX_NUM_STEP = "float32", 5
    for k, v in over.items():
        ac[k] = v
    return cfg


class TestRunners:
    @pytest.mark.parametrize("how", ["argument", "yaml"])
    def test_single_video_slots(self, tmp_path, monkeypatch, how):
        """slots=2 (or SLOTS: 2): the sequential run's pkl files and values."""
        npy = _sv_setup(tmp_path, monkeypatch)
        with contextlib.redirect_stdout(io.StringIO()) as said:
            seq = tsingle.run(_sv_cfg(npy, tmp_path / "s"), frames=FRAMES, device="cpu")
            kw, over = (dict(slots=2), {}) if how == "argument" else ({}, {"SLOTS": 2})
            vec = tsingle.run(_sv_cfg(npy, tmp_path / "v", **over), frames=FRAMES, device="cpu",
                              **kw)
        assert len(seq) == len(vec) == 2
        assert [os.path.basename(p) for p in vec] == [os.path.basename(p) for p in seq]
        assert said.getvalue().count("clean model misclassifies") == 2
        for p, q in zip(vec, seq):
            got, want = load_result(p), load_result(q)
            assert got["correct_cls"] == want["correct_cls"]
            _single_results_match(got, want)

    @pytest.mark.parametrize("kw,world,error,match", [
        (dict(use_mesh=True, slots=3), "2", ValueError, "multiple of the mesh size"),
        (dict(dashboard_path="d.png", slots=2), None, None, "[warn] live dashboard")])
    def test_single_video_slots_with_unported_options_raise(self, tmp_path, monkeypatch, kw,
                                                            world, error, match):
        """Under 2 ranks, slots the ranks do not divide raise, as in JAX; the
        dashboard (per clip) warns under slots and the sweep goes on without
        it, as in JAX (error None)."""
        npy = _sv_setup(tmp_path, monkeypatch)
        if world is not None:
            monkeypatch.setenv("WORLD_SIZE", world)
        if error is not None:
            with pytest.raises(error, match=match):
                tsingle.run(_sv_cfg(npy, tmp_path / "o"), frames=FRAMES, device="cpu", **kw)
            return
        with contextlib.redirect_stdout(io.StringIO()) as said:
            got = tsingle.run(_sv_cfg(npy, tmp_path / "o"), frames=FRAMES, device="cpu", **kw)
        assert match in said.getvalue() and len(got) == 2
        assert not (tmp_path / kw["dashboard_path"]).exists()

    def test_single_video_cli_slots(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(tsingle, "run", lambda cfg, **kw: seen.update(kw))
        tsingle.main(["--slots", "4", "--device", "cpu"])
        assert seen["slots"] == 4 and seen["use_mesh"] is False

    def test_torch_per_video_slots(self, tmp_path, monkeypatch):
        """slots=2 against the sequential run: the same counts, files,
        verdicts and histories; a rerun skips what the ledger holds."""
        monkeypatch.setattr(tper_video, "build_victim", lambda *a, device=None, **kw: (
            LinearVictim()))
        monkeypatch.setattr(tvd.VideoDataset, "_decode", lambda self, p: np.random.default_rng(
            sum(map(ord, os.path.basename(p)))).integers(0, 256, (7, 20, 30, 3), dtype=np.uint8))
        records = []
        for i in range(3):
            ds = tvd.VideoDataset([tvd.VideoRecord(f"vid{i}.mp4", 0)], sample_length=FRAMES,
                                  input_size=SIZE, random_offset=False, random_crop=False,
                                  random_flip=False)
            x = (ds.load_clip(ds.records[0]).astype(np.float32) / 255.0 - np.float32(
                tvd.DEFAULT_MEAN)) / np.float32(tvd.DEFAULT_STD)
            label = int((x.mean(axis=(0, 1, 2)) @ W).argmax())
            records.append(tvd.VideoRecord(f"vid{i}.mp4", label if i != 1 else (label + 1) % K))
        kw = dict(records=records, label_names=LABEL_NAMES, n_iter=20, sample_length=FRAMES,
                  input_size=SIZE, device="cpu")
        seq = tper_video.run("r2plus1d_18", model_dir=str(tmp_path / "s"), **kw)
        vec = tper_video.run("r2plus1d_18", model_dir=str(tmp_path / "v"), slots=2, **kw)
        assert {k: v for k, v in vec.items() if k != "results"} == {
            k: v for k, v in seq.items() if k != "results"}
        assert vec["skipped_misclassified"] == 1 and vec["attacked"] == 2
        assert sorted(os.listdir(tmp_path / "v")) == sorted(os.listdir(tmp_path / "s"))
        assert sorted((os.path.basename(p), f) for p, f in vec["results"]) == sorted(
            (os.path.basename(p), f) for p, f in seq["results"])
        for name in os.listdir(tmp_path / "s"):
            got = np.load(tmp_path / "v" / name, allow_pickle=True).tolist()
            want = np.load(tmp_path / "s" / name, allow_pickle=True).tolist()
            if want is None:
                assert got is None
            else:
                _sweep_results_match(got, want)
        again = tper_video.run("r2plus1d_18", model_dir=str(tmp_path / "v"), slots=2, **kw)
        fooled = sum(f for _, f in vec["results"])
        assert again["skipped_existing"] == fooled
        assert again["attacked"] == 2 - fooled

    def test_torch_per_video_mesh_raises(self, monkeypatch):
        """Under 2 ranks, --slots that the ranks do not divide raise (as in
        JAX), and --slots without --mesh is refused."""
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            tper_video.run(records=[], label_names=[], device="cpu", slots=3, use_mesh=True)
        with pytest.raises(ValueError, match="--slots .* --mesh"):
            tper_video.run(records=[], label_names=[], device="cpu", slots=2)

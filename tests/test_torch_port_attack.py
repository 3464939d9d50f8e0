"""The PyTorch port's attack math, packing and entry-point rules, held
against the JAX package on the same numpy inputs (float32, CPU)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu import attack as jattack
from flickering_adversarial_video_tpu.data.packing import pack_video_np as jpack_video_np
from flickering_adversarial_video_tpu.ops import space_to_depth as jsd
from flickering_adversarial_video_tpu.ops.packed_apply import pack_flicker_delta as jpack_delta
from flickering_adversarial_video_tpu.ops.stem_tmajor import _clip_grad_mask2
from flickering_adversarial_video_tpu_torch import attack as tattack
from flickering_adversarial_video_tpu_torch.data.packing import pack_video_np
from flickering_adversarial_video_tpu_torch.ops import space_to_depth as tsd
from flickering_adversarial_video_tpu_torch.ops.packed_apply import (
    clip_grad_mask2,
    pack_flicker_delta,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def rng():
    return np.random.default_rng(5)


class TestLosses:
    @pytest.mark.parametrize(
        "improve,targeted,use_logits",
        [(True, t, u) for t in (False, True) for u in (False, True)]
        + [(False, t, False) for t in (False, True)],
    )
    def test_loss_and_grad_match_jax(self, rng, improve, targeted, use_logits):
        logits = rng.normal(size=(4, 11)).astype(np.float32) * 3
        labels = rng.integers(0, 11, 4)
        kw = dict(improve_loss=improve, targeted=targeted)
        if improve:
            kw.update(margin=0.05, use_logits=use_logits)
        import jax

        jl, jaux = jattack.adversarial_loss(jnp.asarray(logits), jnp.asarray(labels), **kw)
        jg = jax.grad(lambda z: jattack.adversarial_loss(z, jnp.asarray(labels), **kw)[0])(
            jnp.asarray(logits)
        )
        z = _t(logits).requires_grad_(True)
        tl, taux = tattack.adversarial_loss(z, _t(labels), **kw)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
        for key in ("prob_to_min", "prob_to_max", "per_example", "probs"):
            np.testing.assert_allclose(
                taux[key].detach().numpy(), np.asarray(jaux[key]), rtol=1e-5, atol=1e-7
            )

    def test_hinge_hand_value(self):
        # p = softmax([0, 0]) = [.5, .5], label 0: gap = .5 - (.5 - .05) = .05,
        # min(.05^2/.05, .05) = .05
        loss, _ = tattack.improved_hinge_loss(torch.zeros(1, 2), torch.tensor([0]))
        assert float(loss) == pytest.approx(0.05, rel=1e-6)


class TestRegularizersAndMetrics:
    def test_match_jax(self, rng):
        d = rng.normal(size=(8, 1, 1, 3)).astype(np.float32) * 0.2
        for name in (
            "thinness_reg", "first_order_diff_reg", "second_order_diff_reg",
            "l12_regularizer", "thickness", "roughness",
        ):
            want = float(getattr(jattack, name)(jnp.asarray(d)))
            got = float(getattr(tattack, name)(_t(d)))
            assert got == pytest.approx(want, rel=1e-5), name

    @pytest.mark.parametrize("targeted", [False, True])
    @pytest.mark.parametrize("exclude", [True, False])
    def test_fooling_counters(self, rng, targeted, exclude):
        adv = rng.random((16, 5)).astype(np.float32)
        clean = rng.random((16, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 16)
        kw = dict(targeted=targeted, exclude_misclassify=exclude)
        jm, jv = jattack.fooling_counts(jnp.asarray(adv), jnp.asarray(clean), jnp.asarray(labels), **kw)
        tm, tv = tattack.fooling_counts(_t(adv), _t(clean), _t(labels), **kw)
        assert (int(tm), int(tv)) == (int(jm), int(jv))
        ja = jattack.is_adversarial(jnp.asarray(adv), jnp.asarray(labels), targeted=targeted)
        assert bool(tattack.is_adversarial(_t(adv), _t(labels), targeted=targeted)) == bool(ja)


class TestPerturbation:
    def test_apply_and_clip_gradient_ties(self, rng):
        """Values and d(delta) of apply_perturbation, with delta exactly at
        the +-0.4 clip bound and pixels exactly at -1: jnp.clip's 0.5
        gradient at a bound must be reproduced."""
        import jax

        spec_j, spec_t = jattack.FlickerSpec(frames=6), tattack.FlickerSpec(frames=6)
        clean = rng.uniform(-1, 1, (2, 6, 3, 3, 3)).astype(np.float32)
        clean[:, :, 0, 0, :] = -1.0
        delta = rng.uniform(-0.3, 0.3, spec_t.shape).astype(np.float32)
        delta[0, 0, 0, :] = [0.4, -0.4, 0.0]
        w = rng.normal(size=clean.shape).astype(np.float32)
        mask = np.asarray(jattack.frame_mask(6, 1, 4))
        np.testing.assert_array_equal(tattack.frame_mask(6, 1, 4).numpy(), mask)

        def jloss(d):
            adv = jattack.apply_perturbation(jnp.asarray(clean), d, spec_j, mask=jnp.asarray(mask))
            return jnp.sum(adv * w), adv

        (jl, jadv), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(delta))
        d = _t(delta).requires_grad_(True)
        adv = tattack.apply_perturbation(_t(clean), d, spec_t, mask=_t(mask))
        (adv * _t(w)).sum().backward()
        np.testing.assert_allclose(adv.detach().numpy(), np.asarray(jadv), atol=1e-7)
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)

    def test_clip_mask_boundary_is_half(self):
        pre = torch.tensor([-1.5, -1.0, -0.2, 1.0, 1.5])
        assert clip_grad_mask2(pre, -1.0, 1.0).tolist() == [0, 1, 2, 1, 0]
        ref = np.asarray(_clip_grad_mask2(jnp.asarray(pre.numpy()), -1.0, 1.0))
        np.testing.assert_array_equal(clip_grad_mask2(pre, -1.0, 1.0).numpy(), ref)


class TestPacking:
    def test_pack_input_and_video_np(self, rng):
        x = rng.normal(size=(2, 4, 6, 8, 3)).astype(np.float32)
        want = np.asarray(jsd.pack_input(jnp.asarray(x), axes=(1, 2, 3)))
        np.testing.assert_array_equal(tsd.pack_input(_t(x)).numpy(), want)
        u8 = rng.integers(0, 256, (2, 4, 6, 8, 3), dtype=np.uint8)
        np.testing.assert_array_equal(pack_video_np(u8), jpack_video_np(u8))

    def test_pack_stem_kernel(self, rng):
        k = rng.normal(size=(7, 7, 7, 3, 64)).astype(np.float32)
        want, pads = jsd.pack_conv_spatiotemporal(jnp.asarray(k), (2, 2, 2))
        got = tsd.pack_stem_kernel(_t(k.transpose(4, 3, 0, 1, 2)))
        assert pads == ((1, 2), (1, 2), (1, 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_pack_flicker_delta(self, rng):
        d = rng.normal(size=(8, 1, 1, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            pack_flicker_delta(_t(d)).numpy(), np.asarray(jpack_delta(jnp.asarray(d)))
        )


class TestEntryPoints:
    def test_port_imports_no_jax(self):
        """The whole port imports, in a fresh interpreter, without loading
        jax or anything of the JAX package."""
        code = (
            "import sys, pkgutil, importlib\n"
            "import flickering_adversarial_video_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "for name in ('runners.universal', 'runners.common', 'engine.loops',\n"
            "             'engine.checkpoint', 'viz.tensorboard', 'data.tfrecord',\n"
            "             'data.example_proto', 'data.video_dataset', 'utils.config',\n"
            "             'utils.labels', 'models.registry', 'ops.fused_apply',\n"
            "             'runners.single_video', 'runners.class_gen', 'engine.inference',\n"
            "             'data.npy', 'viz.results', 'data.video', 'data.write_tfrecords',\n"
            "             'data.kinetics_download', 'viz.live', 'data.optical_flow',\n"
            "             'data.grain_pipeline', 'ops.accounting', 'utils.system',\n"
            "             'utils.profiling', 'viz.stats_plots', 'viz.aggregate',\n"
            "             'convert.fake_assets'):\n"
            "    assert p.__name__ + '.' + name in sys.modules, name\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'flax' or m.startswith('flickering_adversarial_video_tpu.')\n"
            "       or m == 'flickering_adversarial_video_tpu']\n"
            "print(bad)\n"
            "assert not bad, bad\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
        )
        assert out.returncode == 0, out.stdout + out.stderr

    def test_entry_points_need_cuda_or_cpu(self, monkeypatch):
        from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InceptionI3D(num_classes=7)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InceptionI3D(num_classes=7, device="cuda")
        assert InceptionI3D(num_classes=7, device="cpu").device.type == "cpu"

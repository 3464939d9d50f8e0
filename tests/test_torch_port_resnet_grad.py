"""The attack's d(delta) through the port's video ResNets (r3d_18, mc3_18,
r2plus1d_18, r2plus1d_34) held against the JAX package's engine, in f32 on
the CPU at T=4, 16x16, B=2, on the weights of
tests/test_torch_port_video_resnet.py.

Tolerances: the loss terms to 1e-5 relative; d(delta) of the adversarial
loss pointwise to rtol 1e-3 (the ResNet has no max-pool, so no near-tie
reroutes a gradient), and of the total loss to rtol 1e-3 with an atol of
1e-4 of its largest component: where the adversarial and the regularizer
gradients cancel, a component is a small difference of large terms and
carries their f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import TorchStyleFlickerSpec as JSpec
from flickering_adversarial_video_tpu.engine import AttackConfig as JConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JFlags
from flickering_adversarial_video_tpu.models.video_resnet import VideoResNet as JResNet
from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
from flickering_adversarial_video_tpu_torch.convert import video_resnet_state_dict
from flickering_adversarial_video_tpu_torch.convert.flax_video_resnet import to_flax_variables
from flickering_adversarial_video_tpu_torch.engine import AttackConfig, AttackEngine, RuntimeFlags
from flickering_adversarial_video_tpu_torch.models.video_resnet import VideoResNet

VARIANTS = ("r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34")
K, B, FRAMES, SIZE, MAX_NORM = 7, 2, 4, 16, 0.015


def _state(variant):
    return {n: torch.from_numpy(v) for n, v in video_resnet_state_dict(variant, K, 1).items()}


def _model(variant, state):
    m = VideoResNet(variant, K, torch.float32, device="cpu")
    m.load_state_dict(state)
    return m


def _jax_variables(variant, state):
    return jax.tree_util.tree_map(jnp.asarray, to_flax_variables(state, variant))


class TestInputGradient:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_delta_gradient_matches_jax(self, variant):
        """d(total loss)/d(delta) of the mean/std attack step on a uint8
        batch labelled with the victim's clean prediction (so the hinge is
        active), delta U(-0.02, 0.02) against max_norm 0.015 (so the clamp
        zeroes some components), pointwise to rtol 1e-3; the loss terms to
        1e-5 relative.  The JAX engine's generic path, its gradient taken op
        by op (uncompiled: the four models share the primitives' compiles)."""
        state = _state(variant)
        rng = np.random.default_rng(3)
        video = rng.integers(0, 256, (B, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
        engine = AttackEngine(_model(variant, state), TorchStyleFlickerSpec(FRAMES),
                              AttackConfig(norm_world="meanstd", reg_weighting="torch"))
        flags = RuntimeFlags(max_norm=MAX_NORM)
        labels = engine.forward(None, {"video": video, "labels": np.zeros(B)}, flags,
                                adversarial=False).argmax(-1).numpy()
        delta = rng.uniform(-0.02, 0.02, (FRAMES, 1, 1, 3)).astype(np.float32)

        jeng = JEngine(JResNet(variant, K, jnp.float32).apply, _jax_variables(variant, state),
                       JSpec(frames=FRAMES), JConfig(norm_world="meanstd", reg_weighting="torch"))
        jflags = JFlags(max_norm=MAX_NORM)

        def jloss(d):
            total, terms = jeng._loss_terms(d, jnp.asarray(video), jnp.asarray(labels), jflags, None)
            return jnp.stack([total, terms["adv_loss"]]), terms

        # the total's and the adversarial term's gradients in one backward
        jgrads, jterms = jax.jacrev(jloss, has_aux=True)(jnp.asarray(delta))
        d = torch.from_numpy(delta).requires_grad_(True)
        v, packed, lab = engine.prepare_batch({"video": video, "labels": labels})
        total, terms = engine._loss_terms(d, v, packed, lab, engine._step_scalars(flags),
                                          torch.zeros((), dtype=torch.int32))
        (grad,) = torch.autograd.grad(total, d, retain_graph=True)
        (adv_grad,) = torch.autograd.grad(terms["adv_loss"], d)
        assert float(jterms["adv_loss"]) > 0
        for k in ("adv_loss", "reg_loss", "norm_reg", "diff_norm_reg", "laplacian_norm_reg"):
            np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]), rtol=1e-5,
                                       atol=1e-9)
        jgrad, jadv = np.asarray(jgrads[0]), np.asarray(jgrads[1])
        assert (jgrad == 0).any() and (jgrad != 0).any()  # clamped and free components
        np.testing.assert_allclose(adv_grad.numpy(), jadv, rtol=1e-3, atol=0)
        np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-3, atol=1e-4 * np.abs(jgrad).max())

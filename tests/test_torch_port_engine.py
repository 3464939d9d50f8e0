"""The PyTorch port's AttackEngine held against the JAX package's, in f32 on
the CPU at a small geometry (B=2, T=8, 16x16, 7 classes).

The JAX engine runs its single-device default: the T-major input head
(``build_stem_head(tmajor=True)``), forced with FLICKER_TMAJOR_HEAD=1 because
the test process gives JAX 8 CPU devices.  Tolerances: loss terms 1e-5
relative (f32 reassociation); the delta trajectory after 3 Adam steps 1e-6
absolute against steps of 1e-3 -- Adam divides each gradient component by its
own magnitude, so a component whose gradient is near zero could move by a
whole step on a sign flip; none does on this input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import FlickerSpec as JaxSpec
from flickering_adversarial_video_tpu.data.packing import pack_video_np
from flickering_adversarial_video_tpu.engine import AttackConfig as JaxConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JaxEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JaxFlags
from flickering_adversarial_video_tpu.models.i3d import InceptionI3D as JaxI3D
from flickering_adversarial_video_tpu.models.i3d import build_stem_head, init_i3d_params
from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
from flickering_adversarial_video_tpu_torch.convert import from_flax_variables
from flickering_adversarial_video_tpu_torch.engine import AttackConfig, AttackEngine, RuntimeFlags
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D

K, FRAMES, SIZE, STEPS = 7, 8, 16, 3
TERMS = ("total_loss", "adv_loss", "reg_loss", "weighted_reg", "l12", "norm_reg",
         "diff_norm_reg", "laplacian_norm_reg", "prob_to_min", "prob_to_max",
         "thickness", "roughness", "delta_max", "delta_min")


@pytest.fixture(scope="module")
def setup():
    variables = init_i3d_params(jax.random.key(2), num_classes=K, frames=FRAMES, size=SIZE)
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, (2, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, K, (2,))
    model = InceptionI3D(K, torch.float32, device="cpu")
    model.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)))
    return variables, video, labels, model


@pytest.fixture(scope="module")
def jax_run(setup):
    """Metrics of 3 JAX train steps, the final delta, and eval counters."""
    variables, video, labels, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLICKER_TMAJOR_HEAD", "1")
        m = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
        pm = JaxI3D(num_classes=K, compute_dtype=jnp.float32, prepacked_stem_input=True)
        eng = JaxEngine(
            lambda v, x: m.apply(v, x)[0], variables, JaxSpec(frames=FRAMES), JaxConfig(),
            apply_packed_fn=lambda v, xp: pm.apply(v, xp)[0],
            stem_head=build_stem_head(variables, num_classes=K, compute_dtype=jnp.float32,
                                      tmajor=True),
        )
        batch = {"video_packed": jnp.asarray(pack_video_np(video)), "labels": jnp.asarray(labels)}
        state, key, metrics = eng.init_state(), jax.random.key(0), []
        for _ in range(STEPS):
            state, mt = eng.train_step(state, batch, JaxFlags(), key)
            metrics.append({k: float(mt[k]) for k in TERMS})
        ev = eng.eval_step(state.delta, batch, JaxFlags(), key)
        return metrics, np.asarray(state.delta), (int(ev["miss"]), int(ev["valid"]))


@pytest.fixture(scope="module")
def port_run(setup):
    _, video, labels, model = setup
    eng = AttackEngine(model, FlickerSpec(frames=FRAMES))
    batch = {"video": video, "labels": labels}
    state, metrics = eng.init_state(), []
    for _ in range(STEPS):
        state, mt = eng.train_step(state, batch, RuntimeFlags())
        metrics.append({k: float(mt[k]) for k in TERMS})
    ev = eng.eval_step(state.delta, batch)
    return metrics, state.delta.numpy(), (int(ev["miss"]), int(ev["valid"])), eng


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_terms_match(jax_run, port_run, step):
    for k in TERMS:
        assert port_run[0][step][k] == pytest.approx(jax_run[0][step][k], rel=1e-5, abs=1e-9), k


def test_delta_trajectory_matches(jax_run, port_run):
    want, got = jax_run[1], port_run[1]
    assert np.abs(want).max() > 1e-3  # delta moved by 3 steps of ~lr
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_eval_counters_match(jax_run, port_run):
    assert port_run[2] == jax_run[2]


def test_packed_batch_and_chained_steps_agree(setup, port_run):
    """A host-packed batch gives the same step as the device-packed clip,
    and train_steps(n) equals n train_step calls."""
    _, video, labels, model = setup
    eng = port_run[3]
    chained = eng.train_steps(eng.init_state(), {"video_packed": pack_video_np(video),
                                                 "labels": labels}, RuntimeFlags(), STEPS)
    assert chained.step == STEPS
    np.testing.assert_array_equal(chained.delta.numpy(), port_run[1])


def test_runtime_flags_and_frame_window(setup):
    """adv_flag 0 leaves the logits clean; the learning rate is per step;
    a frame window stops the gradient outside it."""
    _, video, labels, model = setup
    batch = {"video": video, "labels": labels}
    eng = AttackEngine(model, FlickerSpec(frames=FRAMES), AttackConfig(frame_window=(2, 5)))
    delta = torch.full((FRAMES, 1, 1, 3), 0.3)
    clean = eng.forward(None, batch, adversarial=False)
    np.testing.assert_allclose(eng.forward(delta, batch, RuntimeFlags(adv_flag=0.0)).numpy(),
                               clean.numpy(), atol=1e-7)
    state, _ = eng.train_step(eng.init_state(), batch, RuntimeFlags(learning_rate=0.01))
    moved = state.delta.abs().reshape(FRAMES, -1).amax(1).numpy()
    assert np.all(moved[[0, 1, 6, 7]] == 0) and np.all(moved[2:6] > 0)
    assert moved.max() == pytest.approx(0.01, rel=1e-3)

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
from flickering_adversarial_video_tpu_torch.engine import (
    AttackConfig, AttackEngine, AttackState, RuntimeFlags)
from flickering_adversarial_video_tpu_torch.engine.attack_step import SCALARS
from flickering_adversarial_video_tpu_torch.engine.checkpoint import AttackCheckpointer
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D

K, FRAMES, SIZE, STEPS = 7, 8, 16, 3
# Adam along (resume at step, learning_rate, beta0): steps 1 and 2 with the
# learning rate and beta0 changed between them, then the state so far resumed
# as if at step 999, so that the step taken is the 1000th
ADAM_STEPS = ((None, 1e-3, 1.0), (None, 1e-2, 0.7), (999, 1e-3, 1.0))
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
        delta = np.asarray(state.delta)
        # optax's Adam state along ADAM_STEPS (the same compiled step: the
        # flags are traced values)
        adam, state = [], eng.init_state()
        for resume_at, lr, beta0 in ADAM_STEPS:
            if resume_at is not None:  # the state so far, its step counts set to resume_at
                def n():  # a buffer each: the step donates its state
                    return jnp.asarray(resume_at, jnp.int32)

                inner = state.opt_state.inner_state
                opt = state.opt_state._replace(
                    count=n(), inner_state=(inner[0]._replace(count=n()), *inner[1:]))
                state = state.replace(opt_state=opt, step=n())
            state, _ = eng.train_step(state, batch, JaxFlags(learning_rate=lr, beta0=beta0), key)
            inner = state.opt_state.inner_state[0]
            adam.append({"delta": np.asarray(state.delta), "mu": np.asarray(inner.mu),
                         "nu": np.asarray(inner.nu), "step": int(state.step),
                         "count": int(inner.count)})
        return metrics, delta, (int(ev["miss"]), int(ev["valid"])), adam


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


@pytest.fixture(scope="module")
def port_adam_run(setup):
    """The port's Adam state along ADAM_STEPS, and the engine's scalar buffer
    (its address and values) after each step."""
    _, video, labels, model = setup
    eng = AttackEngine(model, FlickerSpec(frames=FRAMES))
    batch = {"video_packed": pack_video_np(video), "labels": labels}
    state, out = eng.init_state(), []
    for resume_at, lr, beta0 in ADAM_STEPS:
        if resume_at is not None:
            state = AttackState(state.delta, state.mu, state.nu, resume_at)
        state, _ = eng.train_step(state, batch, RuntimeFlags(learning_rate=lr, beta0=beta0))
        out.append({"delta": state.delta.numpy(), "mu": state.mu.numpy(), "nu": state.nu.numpy(),
                    "step": state.step, "scalars": (eng._scalars.data_ptr(),
                                                     eng._scalars.tolist())})
    return out


@pytest.mark.parametrize("at", ["step 1", "step 2, new lr and beta0", "resumed step 1000"])
def test_device_scalar_adam_matches_optax(jax_run, port_adam_run, at):
    """delta, mu, nu after each step of ADAM_STEPS against the JAX engine's
    optax state.  The bias corrections are f32 on the device in both (1 ulp
    apart at a few counts).  mu and nu follow the gradients, which agree to
    f32 reassociation (about 1e-5 of the largest component): 1e-4 of the
    largest component; delta 1e-6 absolute against steps of lr (1e-3, then
    1e-2), as the trajectory test holds it.  The learning rate and beta0 of
    step 2 reach the step through the engine's one static scalar buffer,
    whose address does not change."""
    i = ["step 1", "step 2, new lr and beta0", "resumed step 1000"].index(at)
    want, got = jax_run[3][i], port_adam_run[i]
    assert got["step"] == want["step"] == want["count"] == (1, 2, 1000)[i]
    for k in ("mu", "nu"):
        scale = np.abs(want[k]).max()
        assert scale > 0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
    np.testing.assert_allclose(got["delta"], want["delta"], rtol=0, atol=1e-6)
    _, lr, beta0 = ADAM_STEPS[i]
    assert np.abs(want["delta"]).max() >= 0.9 * lr  # it moved by about a step of lr
    flags = dict(RuntimeFlags().__dict__, learning_rate=lr, beta0=beta0)
    assert got["scalars"][1] == pytest.approx([flags[k] for k in SCALARS], rel=1e-7)
    assert got["scalars"][0] == port_adam_run[0]["scalars"][0]


def test_checkpoint_round_trip_keeps_the_step_count(setup, port_adam_run, tmp_path):
    """A checkpoint of the resumed step-1000 state restores delta, mu, nu
    and the step count; the next step from it equals the next step from the
    state itself (bias corrections of count 1001)."""
    _, video, labels, model = setup
    eng = AttackEngine(model, FlickerSpec(frames=FRAMES))
    last = port_adam_run[-1]
    state = AttackState(*(torch.from_numpy(last[k]) for k in ("delta", "mu", "nu")), last["step"])
    ckpt = AttackCheckpointer(str(tmp_path))
    ckpt.save(state)
    assert ckpt.steps() == [1000]
    back = ckpt.restore(eng.init_state())
    assert back.step == 1000 and isinstance(back.step, int)
    for k in ("delta", "mu", "nu"):
        assert torch.equal(getattr(back, k), getattr(state, k))
    batch = {"video_packed": pack_video_np(video), "labels": labels}
    a, ma = eng.train_step(state, batch)
    b, mb = eng.train_step(back, batch)
    assert a.step == b.step == 1001 and ma["step"] == mb["step"] == 1000
    for k in ("delta", "mu", "nu"):
        assert torch.equal(getattr(a, k), getattr(b, k))


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


# ---- the fused-kernel (B8) path: use_pallas_fused on an unpacked uint8 video ----

@pytest.fixture(scope="module")
def jax_fused_run(setup):
    """3 JAX train steps through the Pallas fused kernel (interpreted off the
    TPU; B*T = 16 and H*W*C = 768 are a geometry it takes), then eval."""
    variables, video, labels, _ = setup
    m = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
    eng = JaxEngine(lambda v, x: m.apply(v, x)[0], variables, JaxSpec(frames=FRAMES),
                    JaxConfig(use_pallas_fused=True))
    batch = {"video": jnp.asarray(video), "labels": jnp.asarray(labels)}
    state, key, metrics = eng.init_state(), jax.random.key(0), []
    for _ in range(STEPS):
        state, mt = eng.train_step(state, batch, JaxFlags(), key)
        metrics.append({k: float(mt[k]) for k in TERMS})
    ev = eng.eval_step(state.delta, batch, JaxFlags(), key)
    return (metrics, np.asarray(state.delta), (int(ev["miss"]), int(ev["valid"])),
            np.asarray(ev["adv_probs"]))


@pytest.fixture(scope="module")
def port_fused_run(setup):
    _, video, labels, model = setup
    eng = AttackEngine(model, FlickerSpec(frames=FRAMES), AttackConfig(use_pallas_fused=True))
    batch = {"video": video, "labels": labels}
    state, metrics = eng.init_state(), []
    for _ in range(STEPS):
        state, mt = eng.train_step(state, batch, RuntimeFlags())
        metrics.append({k: float(mt[k]) for k in TERMS})
    ev = eng.eval_step(state.delta, batch)
    return (metrics, state.delta.numpy(), (int(ev["miss"]), int(ev["valid"])),
            ev["adv_probs"].numpy(), eng)


@pytest.mark.parametrize("step", range(STEPS))
def test_fused_path_loss_terms_match(jax_fused_run, port_fused_run, step):
    for k in TERMS:
        assert port_fused_run[0][step][k] == pytest.approx(
            jax_fused_run[0][step][k], rel=1e-5, abs=1e-9), k


def test_fused_path_delta_trajectory_matches(jax_fused_run, port_fused_run):
    want, got = jax_fused_run[1], port_fused_run[1]
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fused_path_eval_takes_the_generic_path_and_matches(jax_fused_run, port_fused_run):
    assert port_fused_run[2] == jax_fused_run[2]
    np.testing.assert_allclose(port_fused_run[3], jax_fused_run[3], atol=1e-4, rtol=0)


def test_fused_path_refuses_packed_batches_and_other_bounds(setup, port_fused_run):
    _, video, labels, model = setup
    eng = port_fused_run[4]
    with pytest.raises(ValueError, match="video_packed"):
        eng.train_step(eng.init_state(), {"video_packed": pack_video_np(video), "labels": labels})
    with pytest.raises(ValueError, match="video_packed"):
        eng.eval_step(eng.init_state().delta, {"video_packed": pack_video_np(video),
                                               "labels": labels})
    with pytest.raises(ValueError, match="fixed bounds"):
        AttackEngine(model, FlickerSpec(frames=FRAMES, input_min=0.0),
                     AttackConfig(use_pallas_fused=True))


def test_fused_and_default_paths_agree_away_from_the_bounds(setup, port_run):
    """No pixel of this clip is 0 in the first step (delta 0), so no value
    sits on a bound and the strict tie rule cannot show: the two paths give
    the same first loss and nearly the same first delta."""
    _, video, labels, model = setup
    clip = np.maximum(video, 1)
    out = {}
    for fused in (False, True):
        eng = AttackEngine(model, FlickerSpec(frames=FRAMES), AttackConfig(use_pallas_fused=fused))
        state, mt = eng.train_step(eng.init_state(), {"video": clip, "labels": labels})
        out[fused] = (float(mt["total_loss"]), state.delta.numpy())
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    np.testing.assert_allclose(out[True][1], out[False][1], atol=1e-6)

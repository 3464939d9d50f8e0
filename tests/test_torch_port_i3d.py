"""The PyTorch port's InceptionI3D held against the JAX package's, in f32 on
the CPU at a small geometry (B=2, T=8, 16x16, 7 classes: the Logits window
clamps), with the weights carried across by convert.from_flax_variables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.models.i3d import InceptionI3D as JaxI3D
from flickering_adversarial_video_tpu.models.i3d import init_i3d_params
from flickering_adversarial_video_tpu_torch.convert import from_flax_variables, init_i3d_state
from flickering_adversarial_video_tpu_torch.models.i3d import I3D_ENDPOINTS, InceptionI3D

K, FRAMES, SIZE = 7, 8, 16


@pytest.fixture(scope="module")
def flax_vars():
    return init_i3d_params(jax.random.key(0), num_classes=K, frames=FRAMES, size=SIZE)


@pytest.fixture(scope="module")
def port_model(flax_vars):
    m = InceptionI3D(K, torch.float32, device="cpu")
    m.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, flax_vars)))
    return m


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(1).normal(size=(2, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_out(flax_vars, clip):
    """(logits, endpoints, d(sum(logits * w))/dx) of the JAX model: one
    jitted program, shared by the tests below."""
    jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
    w = jnp.asarray(_weights())

    def f(x):
        logits, ep = jm.apply(flax_vars, x)
        return jnp.sum(logits * w), (logits, ep)

    (_, (logits, ep)), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(clip))
    return np.asarray(logits), {k: np.asarray(v) for k, v in ep.items()}, np.asarray(grad)


def _weights():
    return np.random.default_rng(2).normal(size=(2, K)).astype(np.float32)


def test_bridge_covers_every_tensor(flax_vars, port_model):
    sd = from_flax_variables(jax.tree_util.tree_map(np.asarray, flax_vars))
    own = port_model.state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(flax_vars))
    assert n_flax == sum(t.numel() for t in sd.values())
    # the Mixed_5b name quirk survives the bridge
    assert "Mixed_5b.Branch_2.Conv3d_0a_3x3.conv_3d.weight" in sd


def test_endpoints_and_logits_match_jax(jax_out, port_model, clip):
    jl, jep, _ = jax_out
    with torch.no_grad():
        tl, tep = port_model(torch.from_numpy(clip))
    assert set(tep) == set(I3D_ENDPOINTS) - {"Predictions"}
    for name in tep:
        np.testing.assert_allclose(
            tep[name].numpy(), np.asarray(jep[name]), atol=1e-4, rtol=1e-4, err_msg=name
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("endpoint", ["MaxPool3d_3a_3x3", "Mixed_4f", "Predictions"])
def test_final_endpoint_truncates(jax_out, port_model, clip, endpoint):
    jl, jep, _ = jax_out
    jout = np.asarray(jax.nn.softmax(jl)) if endpoint == "Predictions" else jep[endpoint]
    with torch.no_grad():
        tout, tep = port_model(torch.from_numpy(clip), final_endpoint=endpoint)
    assert list(tep)[-1] == endpoint
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)


def test_input_gradient_matches_jax(jax_out, port_model, clip):
    """Full-net input gradient.  Near-tied pool argmaxes can reroute O(1)
    cotangent across backends (PARITY.md), so this compares at 1e-3 of the
    largest magnitude on a continuous input where such ties are rare, and
    requires 99.9% of entries within 1e-5 of it."""
    jg, w = jax_out[2], _weights()
    x = torch.from_numpy(clip.copy()).requires_grad_(True)
    (port_model(x)[0] * torch.from_numpy(w)).sum().backward()
    tg = x.grad.numpy()
    scale = np.abs(jg).max()
    err = np.abs(tg - jg) / scale
    assert err.max() < 1e-3
    assert (err < 1e-5).mean() > 0.999


def test_random_state_loads_and_runs():
    m = InceptionI3D(K, torch.float32, device="cpu")
    m.load_state_dict(init_i3d_state(seed=3, num_classes=K))
    w = m.Conv3d_1a_7x7.conv_3d.weight
    assert w.std().item() == pytest.approx(1 / np.sqrt(3 * 343), rel=0.05)
    with torch.no_grad():
        out, _ = m(torch.zeros(1, 4, 16, 16, 3))
    assert out.shape == (1, K) and torch.isfinite(out).all()
    # seeded: the same seed gives the same weights
    torch.testing.assert_close(init_i3d_state(seed=3, num_classes=K)["Logits.Conv3d_0c_1x1.conv_3d.weight"],
                               m.state_dict()["Logits.Conv3d_0c_1x1.conv_3d.weight"])


def test_bf16_forward_is_close_to_f32(port_model, clip):
    m16 = InceptionI3D(K, torch.bfloat16, device="cpu")
    m16.load_state_dict(port_model.state_dict())
    with torch.no_grad():
        l32, _ = port_model(torch.from_numpy(clip))
        l16, _ = m16(torch.from_numpy(clip))
    assert l16.dtype == torch.float32
    scale = l32.abs().max().item()
    assert (l16 - l32).abs().max().item() < 0.1 * scale

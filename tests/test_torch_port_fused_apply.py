"""The port's fused normalize + flicker apply + clip (kernel B8) held against
the JAX package's Pallas kernels, which interpret by themselves off the TPU
(``ops/fused_apply.py:43``), at a geometry they take (B*T % 8 == 0,
H*W*C % 128 == 0), and against the JAX call's ``_jnp_reference`` at a
geometry they refuse: the clip's gradient at an exact bound follows the JAX
call's (0 where it takes its kernel, jnp.clip's half where it does not).

On the CPU the port's wrapper computes the kernel's plain version, which is
what is compared here; the CUDA kernels are compared with the plain versions
on the card (``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).
Tolerances: forward 1e-6 absolute (the same f32 operations; XLA may fuse the
multiply-add), backward 1e-5 absolute plus 1e-6 relative (each component is
a sum of 256 f32 terms in another order and reaches 150, where one f32 ulp
is 1.5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.ops.fused_apply import (
    _jnp_reference,
    _supported,
    fused_normalize_perturb as jax_fused,
)
from flickering_adversarial_video_tpu_torch.ops import fused_apply

B, T, H, W, C = 2, 4, 8, 16, 3


@pytest.fixture
def data():
    rng = np.random.default_rng(21)
    video = rng.integers(0, 256, (B, T, H, W, C), dtype=np.uint8)
    delta = (rng.normal(size=(T, 1, 1, C)) * 0.5).astype(np.float32)
    return video, delta


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grad(video, delta, flag=1.0, loss=lambda out: (out * torch.cos(out)).sum(),
               fn=fused_apply.fused_normalize_perturb, **kw):
    d = _t(delta).requires_grad_(True)
    loss(fn(_t(video), d, torch.tensor(flag), **kw)).backward()
    return d.grad.numpy()


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_forward_matches_pallas(data, flag):
    video, delta = data
    assert _supported(video.shape)
    want = jax_fused(jnp.asarray(video), jnp.asarray(delta), jnp.float32(flag))
    got = fused_apply.fused_normalize_perturb(_t(video), _t(delta), torch.tensor(flag))
    assert got.dtype == torch.float32 and fused_apply.fused_apply_fwd.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", [fused_apply.fused_normalize_perturb,
                                fused_apply.fused_normalize_perturb_plain])
def test_gradient_matches_pallas(data, fn):
    video, delta = data

    def loss(d):
        out = jax_fused(jnp.asarray(video), d, jnp.float32(1.0))
        return jnp.sum(out * jnp.cos(out))  # nontrivial upstream gradient

    want = jax.grad(loss)(jnp.asarray(delta))
    got = _port_grad(video, delta, fn=fn)
    assert np.abs(np.asarray(want)).max() > 1.0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-6)


def test_saturated_pixels_give_exactly_zero(data):
    video, _ = data
    delta = np.full((T, 1, 1, C), 5.0, np.float32)  # everything clips to +1
    got = _port_grad(video, delta, loss=lambda out: out.sum())
    np.testing.assert_array_equal(got, np.zeros_like(delta))


def test_tie_rule_is_the_kernels_not_jnp_clips():
    """A black pixel under delta 0 sits exactly on -1.  The Pallas backward
    masks strictly (gradient 0 there), where jnp.clip gives 0.5; at a
    geometry the Pallas kernel takes the port keeps the kernel's rule, and
    strict=False gives jnp.clip's."""
    video = np.full((B, T, H, W, C), 128, np.uint8)
    video[0, 1, 2, 3, 1] = 0
    video[1, 1, 0, 0, 1] = 0
    delta = np.zeros((T, 1, 1, C), np.float32)
    jv, jd = jnp.asarray(video), jnp.asarray(delta)
    kernel = jax.grad(lambda d: jnp.sum(jax_fused(jv, d, jnp.float32(1.0))))(jd)
    clip = jax.grad(lambda d: jnp.sum(_jnp_reference(jv, d, jnp.float32(1.0))))(jd)
    got = _port_grad(video, delta, loss=lambda out: out.sum())
    n = B * H * W
    assert float(kernel[1, 0, 0, 1]) == n - 2 and float(clip[1, 0, 0, 1]) == n - 1
    assert fused_apply.strict_rule(video.shape)
    np.testing.assert_array_equal(got, np.asarray(kernel))
    np.testing.assert_array_equal(
        _port_grad(video, delta, loss=lambda out: out.sum(), strict=False), np.asarray(clip))


def test_geometry_the_tpu_kernel_refuses():
    """At [1,3,5,5,3] (B*T % 8, H*W*C % 128) the JAX call runs
    ``_jnp_reference``: the port's forward is its forward, and d(delta) its
    jax.vjp's, jnp.clip's half at an exact bound.  Two black pixels under
    delta 0 give n - 1 of n on the integer sum (exact; strict=True gives the
    kernel's n - 2), and a random g agrees within 1e-5 of the largest
    component."""
    rng = np.random.default_rng(22)
    video = rng.integers(0, 256, (1, 3, 5, 5, 3), dtype=np.uint8)
    delta = (rng.normal(size=(3, 1, 1, 3)) * 0.3).astype(np.float32)
    video[0, 1, 2, 3, 1] = video[0, 1, 0, 0, 1] = 0
    delta[1, 0, 0, 1] = 0.0  # frame 1, channel 1: two black pixels exactly on -1
    assert not _supported(video.shape) and not fused_apply.strict_rule(video.shape)
    jv, jd, flag = jnp.asarray(video), jnp.asarray(delta), jnp.float32(1.0)
    want = np.asarray(_jnp_reference(jv, jd, flag))
    summed = jax.grad(lambda d: jnp.sum(jax_fused(jv, d, flag)))(jd)
    np.testing.assert_array_equal(
        np.asarray(summed), np.asarray(jax.grad(lambda d: jnp.sum(_jnp_reference(jv, d, flag)))(jd)))
    n = 5 * 5
    assert float(summed[1, 0, 0, 1]) == n - 1
    wavy = np.asarray(jax.grad(lambda d: jnp.sum(jnp.sin(3 * jax_fused(jv, d, flag))))(jd))
    for fn in (fused_apply.fused_normalize_perturb, fused_apply.fused_normalize_perturb_plain):
        got = fn(_t(video), _t(delta), torch.tensor(1.0))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(_port_grad(video, delta, loss=lambda out: out.sum(), fn=fn),
                                      np.asarray(summed))
        strict = _port_grad(video, delta, loss=lambda out: out.sum(), fn=fn, strict=True)
        assert float(strict[1, 0, 0, 1]) == n - 2
        got = _port_grad(video, delta, loss=lambda out: torch.sin(3 * out).sum(), fn=fn)
        np.testing.assert_allclose(got, wavy, atol=1e-5 * np.abs(wavy).max(), rtol=0)


def test_flag_gets_zeros_and_video_none(data):
    video, delta = data
    d = _t(delta).requires_grad_(True)
    f = torch.tensor(0.7, requires_grad=True)
    fused_apply.fused_normalize_perturb(_t(video), d, f).sum().backward()
    assert float(f.grad) == 0.0 and d.grad.abs().max() > 0


def test_operand_checks(data):
    video, delta = data
    with pytest.raises(TypeError):
        fused_apply.fused_apply_fwd(_t(video).float(), _t(delta), torch.tensor(1.0))
    with pytest.raises(ValueError):
        fused_apply.fused_apply_fwd(_t(video), _t(delta)[:2], torch.tensor(1.0))
    with pytest.raises(ValueError):
        fused_apply.fused_apply_bwd(_t(video), _t(delta), torch.tensor(1.0), torch.zeros(1))

"""The PyTorch port's kernel modules held against the JAX functions that
reach the Pallas kernels (run in interpret mode on the CPU, as the JAX
package's own tests run them) and against the JAX custom VJPs around them.

On the CPU each wrapper computes its kernel's plain version, which is what
is compared here; the CUDA kernels themselves are compared with the plain
versions on the card (``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

Layouts: the port is NDHWC [B,T,H,W,C]; the TPU functions take the T-major
view [H,W,C,T*B] (lane t*B+b), converted here with numpy.  Integer grids
make every sum exact in f32 and force tie populations, so those cases must
agree bit for bit; real-valued cases agree to f32 reassociation (1e-5 of
the largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.ops.pool_s1_view_pallas import s1_pool333_view_pallas
from flickering_adversarial_video_tpu.ops.pool_s2_view_pallas import s2_pool_view_bwd_pallas
from flickering_adversarial_video_tpu.ops.stem_combine_pallas import catbwd_lane_combine_pallas
from flickering_adversarial_video_tpu.ops.stem_conv_pallas import stem_conv_bn_relu_view_pallas
from flickering_adversarial_video_tpu.ops import stem_tmajor as jst
from flickering_adversarial_video_tpu_torch.ops import conv_unit, maxpool, packed_apply
from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided, stem_combine, stem_conv


def to_view(x):
    b, t, h, w, c = x.shape
    return np.ascontiguousarray(x.transpose(2, 3, 4, 1, 0)).reshape(h, w, c, t * b)


def from_view(v, b):
    h, w, c, tb = v.shape
    return np.asarray(v).reshape(h, w, c, tb // b, b).transpose(4, 3, 0, 1, 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale, want / scale, atol=tol)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _bn(rng, c):
    return (
        rng.normal(size=c).astype(np.float32),
        rng.uniform(0.5, 2.0, c).astype(np.float32),
        rng.normal(size=c).astype(np.float32),
    )


class TestStemConvB1:
    @pytest.mark.parametrize("integer", [True, False])
    def test_plain_matches_pallas_interpret(self, rng, integer):
        b, t, h, w = 2, 4, 6, 8  # H=6: Pallas blocks of 2 rows, both edges
        if integer:
            x = rng.integers(-3, 4, (b, t, h, w, 24)).astype(np.float32)
            pk = rng.integers(-2, 3, (4, 4, 4, 24, 64)).astype(np.float32)
        else:
            x = rng.normal(size=(b, t, h, w, 24)).astype(np.float32)
            pk = rng.normal(size=(4, 4, 4, 24, 64)).astype(np.float32) * 0.1
        mean, var, bias = _bn(rng, 64)
        want = stem_conv_bn_relu_view_pallas(
            jnp.asarray(to_view(x)), jnp.asarray(pk), jnp.asarray(mean), jnp.asarray(var),
            jnp.asarray(bias), b, interpret=True,
        )
        got = stem_conv.stem_conv_bn_relu(_t(x), _t(pk), _t(mean), _t(var), _t(bias))
        assert stem_conv.stem_conv_bn_relu.launches == 0  # CPU: the plain version
        _close(got.numpy(), from_view(want, b), tol=1e-6 if integer else 1e-5)

    def test_stem_input_gradient_matches_tmajor_vjp(self, rng):
        """The model-path stem op: B1 forward, wide conv + B2 (KT=4) backward."""
        b, t, h, w = 2, 4, 6, 6
        x = rng.normal(size=(b, t, h, w, 24)).astype(np.float32)
        pk = rng.normal(size=(4, 4, 4, 24, 64)).astype(np.float32) * 0.1
        mean, var, bias = _bn(rng, 64)
        g = rng.normal(size=(b, t, h, w, 64)).astype(np.float32)
        jargs = [jnp.asarray(a) for a in (pk, mean, var, bias)]
        y, vjp = jax.vjp(lambda xv: jst.stem_bn_relu_tmajor(xv, *jargs, b), jnp.asarray(to_view(x)))
        (dxv,) = vjp(jnp.asarray(to_view(g)))
        xt = _t(x).requires_grad_(True)
        yt = stem_conv.stem_bn_relu(xt, _t(pk), _t(mean), _t(var), _t(bias))
        yt.backward(_t(g))
        _close(yt.detach().numpy(), from_view(y, b))
        _close(xt.grad.numpy(), from_view(dxv, b))


class TestTemporalCombineB2:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("n_taps,t_plo", [(3, 1), (4, 1)])
    def test_bit_equal_with_pallas_interpret(self, rng, dtype, n_taps, t_plo):
        b, t, h, w, cin = 2, 8, 8, 6, 8
        part = jnp.asarray(rng.normal(size=(b, t, h, w, n_taps * cin)), dtype)
        want = catbwd_lane_combine_pallas(
            jnp.asarray(to_view(np.asarray(part))), b, cin, t_plo, interpret=True
        )
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        tpart = _t(np.asarray(part, np.float32)).to(tdt)
        got = stem_combine.temporal_combine(tpart, cin, t_plo)
        assert got.dtype == tdt and stem_combine.temporal_combine.launches == 0
        np.testing.assert_array_equal(
            got.float().numpy(), from_view(np.asarray(want, np.float32), b)
        )


class TestConvUnit:
    @pytest.mark.parametrize("kshape", [(1, 1, 1), (3, 3, 3)])
    def test_value_and_input_grad_match_tmajor_vjp(self, rng, kshape):
        b, t, h, w, cin, cout = 2, 4, 6, 6, 8, 16
        x = rng.normal(size=(b, t, h, w, cin)).astype(np.float32)
        k = rng.normal(size=(*kshape, cin, cout)).astype(np.float32) * 0.2
        mean, var, bias = _bn(rng, cout)
        g = rng.normal(size=(b, t, h, w, cout)).astype(np.float32)
        jargs = [jnp.asarray(a) for a in (k, mean, var, bias)]
        y, vjp = jax.vjp(lambda xv: jst.conv_bn_relu_tmajor(xv, *jargs, b), jnp.asarray(to_view(x)))
        (dxv,) = vjp(jnp.asarray(to_view(g)))
        xt = _t(x).requires_grad_(True)
        yt = conv_unit.conv_bn_relu(
            xt, _t(k.transpose(4, 3, 0, 1, 2)), _t(mean), _t(var), _t(bias)
        )
        yt.backward(_t(g))
        _close(yt.detach().numpy(), from_view(y, b))
        _close(xt.grad.numpy(), from_view(dxv, b))


def _tie_grid(rng, shape):
    return rng.integers(0, 3, size=shape).astype(np.float32)


POOL_GEOMS = [(2, 4, 8, 8, 16), (2, 4, 14, 14, 32), (2, 8, 4, 6, 16), (2, 2, 28, 28, 16)]


class TestPoolS1B3B4:
    @pytest.mark.parametrize("geom", POOL_GEOMS)
    def test_values_and_tie_routing_bit_equal(self, rng, geom):
        b = geom[0]
        x = _tie_grid(rng, geom)
        dy = rng.integers(-8, 9, size=geom).astype(np.float32)
        y, vjp = jax.vjp(lambda q: s1_pool333_view_pallas(q, b, True), jnp.asarray(to_view(x)))
        (dxv,) = vjp(jnp.asarray(to_view(dy)))
        got_y = pool_s1.pool333_fwd(_t(x))
        got_dx = pool_s1.pool333_bwd(_t(x), _t(dy))
        assert pool_s1.pool333_fwd.launches == 0 and pool_s1.pool333_bwd.launches == 0
        np.testing.assert_array_equal(got_y.numpy(), from_view(y, b))
        np.testing.assert_array_equal(got_dx.numpy(), from_view(dxv, b))

    def test_autograd_op(self, rng):
        x = _tie_grid(rng, (2, 4, 6, 6, 8))
        dy = rng.integers(-8, 9, size=x.shape).astype(np.float32)
        xt = _t(x).requires_grad_(True)
        pool_s1.max_pool_333(xt).backward(_t(dy))
        np.testing.assert_array_equal(xt.grad.numpy(), pool_s1.pool333_bwd_plain(_t(x), _t(dy)).numpy())

    def test_bf16_backward_rounds_once(self, rng):
        x = _tie_grid(rng, (2, 4, 6, 6, 8))
        dy = rng.normal(size=x.shape).astype(np.float32)
        got = pool_s1.pool333_bwd(_t(x).bfloat16(), _t(dy).bfloat16())
        want = pool_s1.pool333_bwd(_t(x), _t(dy).bfloat16().float()).bfloat16()
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


class TestPoolStridedB5:
    @pytest.mark.parametrize("geom", [(2, 4, 8, 8, 16), (2, 2, 14, 6, 8), (1, 3, 4, 4, 4)])
    def test_values_and_select_and_scatter_ties(self, rng, geom):
        b = geom[0]
        x = _tie_grid(rng, geom)
        yshape = (geom[0], geom[1], geom[2] // 2, geom[3] // 2, geom[4])
        dy = rng.integers(-8, 9, size=yshape).astype(np.float32)
        y, vjp = jax.vjp(lambda q: jst.strided_pool_view(q, True), jnp.asarray(to_view(x)))
        (dxv,) = vjp(jnp.asarray(to_view(dy)))
        got_y = pool_strided.pool133_s2_fwd(_t(x))
        assert pool_strided.pool133_s2_fwd.launches == 0
        np.testing.assert_array_equal(got_y.numpy(), from_view(y, b))
        xt = _t(x).requires_grad_(True)
        pool_strided.max_pool_133_s2(xt).backward(_t(dy))
        np.testing.assert_array_equal(xt.grad.numpy(), from_view(dxv, b))

    @pytest.mark.parametrize("geom", [(2, 4, 8, 8, 16), (2, 2, 12, 6, 32)])
    def test_b6_matches_pallas_interpret(self, rng, geom):
        """B6's plain version vs the one-pass Pallas routing backward."""
        b = geom[0]
        x = _tie_grid(rng, geom)
        yshape = (geom[0], geom[1], geom[2] // 2, geom[3] // 2, geom[4])
        dy = rng.integers(-8, 9, size=yshape).astype(np.float32)
        want = s2_pool_view_bwd_pallas(
            jnp.asarray(to_view(x)), jnp.asarray(to_view(dy)), interpret=True
        )
        got = pool_strided.pool133_s2_bwd(_t(x), _t(dy))
        assert pool_strided.pool133_s2_bwd.launches == 0
        np.testing.assert_array_equal(got.numpy(), from_view(want, b))

    def test_odd_extent_rejected(self):
        with pytest.raises(ValueError):
            pool_strided.pool133_s2_fwd(torch.zeros(1, 2, 5, 4, 3))


class TestPools4a5a:
    @pytest.mark.parametrize("which", ["4a", "5a"])
    def test_values_and_tie_grads(self, rng, which):
        b, shape = 2, (2, 4, 8, 8, 8)
        x = _tie_grid(rng, shape)
        jfn = jst.pool4a_view if which == "4a" else jst.pool5a_view
        tfn = maxpool.pool4a if which == "4a" else maxpool.pool5a
        y, vjp = jax.vjp(lambda q: jfn(q, b), jnp.asarray(to_view(x)))
        dy = rng.integers(-8, 9, size=from_view(y, b).shape).astype(np.float32)
        (dxv,) = vjp(jnp.asarray(to_view(dy)))
        xt = _t(x).requires_grad_(True)
        yt = tfn(xt)
        yt.backward(_t(dy))
        np.testing.assert_array_equal(yt.detach().numpy(), from_view(y, b))
        np.testing.assert_array_equal(xt.grad.numpy(), from_view(dxv, b))


class TestInputHead:
    def test_values_and_delta_grads_with_boundary_ties(self, rng):
        """flicker_stem vs flicker_stem_tmajor: channel 0 of delta is exactly
        0, so every u8 0 pixel of channel 0 sits on the -1 bound (mask 0.5)."""
        b, tp, hw, c = 2, 4, 6, 3
        u8 = rng.integers(0, 256, (b, tp, hw, hw, 8 * c), dtype=np.uint8)
        u8[..., 0] = rng.integers(0, 2, u8[..., 0].shape)
        delta = rng.uniform(-0.2, 0.2, (2 * tp, 1, 1, c)).astype(np.float32)
        delta[..., 0] = 0.0
        pk = rng.normal(size=(4, 4, 4, 8 * c, 64)).astype(np.float32) * 0.1
        mean, var, bias = _bn(rng, 64)
        g = rng.normal(size=(b, tp, hw, hw, 64)).astype(np.float32)
        flag = np.float32(0.7)
        jconst = [jnp.asarray(a) for a in (pk, mean, var, bias)]

        def jfn(d, f):
            y = jst.flicker_stem_tmajor(jnp.asarray(u8), d, f, *jconst, -1.0, 1.0, jnp.float32)
            return jnp.transpose(y, (4, 3, 0, 1, 2))

        y, vjp = jax.vjp(jfn, jnp.asarray(delta), jnp.asarray(flag))
        jd, jf = vjp(jnp.asarray(g))
        d = _t(delta).requires_grad_(True)
        f = torch.tensor(flag, requires_grad=True)
        yt = packed_apply.flicker_stem(
            _t(u8), d, f, _t(pk), _t(mean), _t(var), _t(bias), -1.0, 1.0, torch.float32
        )
        yt.backward(_t(g))
        _close(yt.detach().numpy(), np.asarray(y))
        _close(d.grad.numpy(), np.asarray(jd))
        assert float(f.grad) == pytest.approx(float(jf), rel=1e-4)


class TestKernelSymbols:
    def test_symbols_match_the_cuda_sources(self):
        """Every exported launcher has a signature and its kernels listed,
        and every __global__ function of csrc/ is listed under one launcher."""
        import re

        from flickering_adversarial_video_tpu_torch.ops import kernels

        text = "".join(p.read_text() for p in kernels.CSRC.glob("*.cu"))
        launchers = set(re.findall(r"FAV_API int (fav_\w+)\(", text))
        kernel = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\("
        globals_ = set(re.findall(kernel, text))
        assert launchers == set(kernels.SIGNATURES) == set(kernels.KERNEL_SYMBOLS)
        listed = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]
        assert len(listed) == len(set(listed))
        assert set(listed) == globals_

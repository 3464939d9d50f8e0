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
from flickering_adversarial_video_tpu.ops import maxpool as jmaxpool
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


def _combine_against_pallas(part, cin, t_plo):
    """B2's wrapper (on the CPU: its plain version) against the Pallas kernel
    in interpret mode on the same part (a jnp array, f32 or bf16)."""
    b = part.shape[0]
    want = catbwd_lane_combine_pallas(
        jnp.asarray(to_view(np.asarray(part))), b, cin, t_plo, interpret=True
    )
    tdt = torch.float32 if part.dtype == jnp.float32 else torch.bfloat16
    got = stem_combine.temporal_combine(_t(np.asarray(part, np.float32)).to(tdt), cin, t_plo)
    assert got.dtype == tdt and stem_combine.temporal_combine.launches == 0
    np.testing.assert_array_equal(got.float().numpy(), from_view(np.asarray(want, np.float32), b))
    return got


class TestTemporalCombineB2:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("n_taps,t_plo", [(3, 1), (4, 1), (3, 0), (3, 2), (4, 0), (4, 2)])
    def test_bit_equal_with_pallas_interpret(self, rng, dtype, n_taps, t_plo):
        b, t, h, w, cin = 2, 8, 8, 6, 8
        part = jnp.asarray(rng.normal(size=(b, t, h, w, n_taps * cin)), dtype)
        _combine_against_pallas(part, cin, t_plo)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("n_taps,t_plo", [(3, 0), (3, 2), (4, 1)])
    @pytest.mark.parametrize("t,cin", [(1, 13), (2, 24), (2, 13), (1, 24)])
    def test_short_clips_and_channel_tails(self, rng, dtype, n_taps, t_plo, t, cin):
        """T < KT (a tap reaches past both edges) and Cin = 13 (the CUDA
        kernel's scalar tail) or 24 (three 16-byte bf16 vectors)."""
        part = jnp.asarray(rng.normal(size=(2, t, 3, 5, n_taps * cin)), dtype)
        _combine_against_pallas(part, cin, t_plo)

    def test_bf16_rounds_once_per_add(self, rng):
        """Taps s, s*2^-8, s*2^-8 (s a signed power of two, constant along T):
        two bf16 adds give s (s + s*2^-8 is a tie, rounded to even), one
        rounding of the f32 sum gives s*(1 + 2^-7).  So this grid tells the
        per-add rounding of the JAX chain, which the kernel keeps, from an
        f32 sum rounded once."""
        b, t, h, w, cin = 2, 6, 4, 4, 8
        s = 2.0 ** rng.integers(-4, 5, size=(b, 1, h, w, cin)) * rng.choice([-1.0, 1.0], (b, 1, h, w, cin))
        part = np.concatenate([np.broadcast_to(s * f, (b, t, h, w, cin)) for f in (1, 2.0**-8, 2.0**-8)], -1)
        got = _combine_against_pallas(jnp.asarray(part, jnp.bfloat16), cin, 1).float().numpy()
        once = stem_combine.temporal_combine(_t(part).float(), cin, 1).bfloat16().float().numpy()
        interior = slice(1, t - 1)  # all three taps in range
        np.testing.assert_array_equal(got[:, interior], np.broadcast_to(s, got[:, interior].shape))
        assert (got[:, interior] != once[:, interior]).all()


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

    @pytest.mark.parametrize("geom", [
        (1, 3, 5, 7, 40),   # odd T, H, W: partial tiles of B4 in every dimension
        (2, 1, 5, 7, 40),   # T = 1
        (1, 5, 9, 3, 40),   # H > W, both odd
        (2, 9, 7, 7, 8),    # Mixed_5x's 7x7 plane, an odd T
    ])
    def test_backward_plain_matches_jax_max_pool_same(self, rng, geom):
        """B4's plain version against the JAX package's separable SAME pool
        VJP (`ops/maxpool.max_pool_same`, window (3,3,3), stride 1) at
        geometries the Pallas view kernel's blocking refuses."""
        x = _tie_grid(rng, geom)
        dy = rng.integers(-8, 9, size=geom).astype(np.float32)
        _, vjp = jax.vjp(lambda q: jmaxpool.max_pool_same(q, (3, 3, 3), (1, 1, 1)), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(dy))
        got = pool_s1.pool333_bwd_plain(_t(x), _t(dy))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("grid", ["ties", "NaN/-inf"])
    @pytest.mark.parametrize("geom", [
        (2, 1, 15, 29, 13),  # T = 1; H, W across the CUDA kernel's 14-cell tile; C's scalar tail
        (1, 2, 29, 15, 16),  # T = 2; H across two tile edges
        (2, 2, 1, 29, 16),   # H = 1
        (1, 2, 15, 1, 13),   # W = 1
    ])
    def test_forward_edges_match_pallas_interpret(self, rng, geom, grid):
        """B3's plain version against the Pallas forward at the edges of the
        CUDA kernel's tiling, on an integer-tie grid and on one with NaNs (2%)
        and a -inf block.  The Pallas blocking takes H in blocks of 2..28 rows
        and C in tiles of 16, so x is embedded in a volume padded with -inf
        (the SAME pad itself) to an even H and whole tiles of C, and the
        result cropped."""
        b, t, h, w, c = geom
        x = _tie_grid(rng, geom)
        if grid == "NaN/-inf":
            x.reshape(-1)[rng.integers(0, x.size, size=max(1, x.size // 50))] = np.nan
            x[:, :, h // 2:, w // 2:] = -np.inf
        xp = np.full((b, t, h + h % 2, w, -(-c // 16) * 16), -np.inf, np.float32)
        xp[:, :, :h, :, :c] = x
        want = from_view(s1_pool333_view_pallas(jnp.asarray(to_view(xp)), b, True), b)
        got = pool_s1.pool333_fwd(_t(x))
        assert pool_s1.pool333_fwd.launches == 0
        np.testing.assert_array_equal(got.numpy(), want[:, :, :h, :, :c])  # NaN where NaN

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


# the edge geometries of the strip kernels of B5, B6 and B9's forward: one
# window with the pads in both axes; 3 window rows; the scalar channel tail;
# W' = 1; H' = 17 (runs of window rows); C = 40 over 112 window columns
# (split into groups of channel vectors)
STRIP_EDGE_GEOMS = [(1, 3, 2, 2, 8), (2, 3, 6, 10, 40), (2, 1, 4, 6, 13), (2, 3, 10, 2, 8),
                    (1, 1, 34, 8, 8), (1, 3, 8, 224, 40)]


def _spotted_nan_grid(rng, shape):
    """A tie grid with NaNs (one value in 50) and -inf over the lower-right
    quarter of every frame."""
    x = _tie_grid(rng, shape)
    x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 50))] = np.nan
    x[:, :, shape[2] // 2:, shape[3] // 2:] = -np.inf
    return x


class TestPoolStridedB5:
    @pytest.mark.parametrize("grid", ["ties", "NaN/-inf"])
    @pytest.mark.parametrize("geom", STRIP_EDGE_GEOMS)
    def test_b5_edges_match_pallas_interpret(self, rng, geom, grid):
        """B5's plain version and its wrapper on a CPU tensor against the
        Pallas forward of ``strided_pool_view`` in interpret mode, at the
        edge geometries the card tests hold the CUDA kernel at: values and
        NaN positions equal."""
        b = geom[0]
        x = _tie_grid(rng, geom) if grid == "ties" else _spotted_nan_grid(rng, geom)
        want = from_view(jst.strided_pool_view(jnp.asarray(to_view(x)), True), b)
        np.testing.assert_array_equal(pool_strided.pool133_s2_fwd_plain(_t(x)).numpy(), want)
        np.testing.assert_array_equal(pool_strided.pool133_s2_fwd(_t(x)).numpy(), want)
        assert pool_strided.pool133_s2_fwd.launches == 0

    def test_width_limit(self):
        """The strip kernels take a width up to 1024: B5's wrapper raises
        above it, on any device, with B6's message."""
        with pytest.raises(ValueError, match="the B5 kernel takes a width up to 1024; got 1026"):
            pool_strided.pool133_s2_fwd(torch.zeros(1, 1, 2, 1026, 1))
        assert pool_strided.pool133_s2_fwd(torch.zeros(1, 1, 2, 1024, 1)).shape == (1, 1, 1, 512, 1)

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

    @pytest.mark.parametrize("geom", [
        (1, 3, 2, 2, 13),   # one window: the pad row and column in it; C=13, a partial vector
        (2, 3, 6, 10, 40),  # H' = 3 window rows, no multiple of B6's runs
        (2, 1, 10, 6, 13),  # H' = 5, W' = 3
        (1, 2, 2, 10, 40),  # one window row over a 5-window width
    ])
    def test_b6_geometries_match_select_and_scatter(self, rng, geom):
        """B6's plain version, its wrapper on a CPU tensor and the autograd op
        against the JAX package's select-and-scatter VJP of the view pool, at
        the edges of the CUDA kernel's tiling (full-width rows, runs of
        window rows, 16-byte channel vectors with a scalar tail)."""
        b = geom[0]
        x = _tie_grid(rng, geom)
        yshape = (geom[0], geom[1], geom[2] // 2, geom[3] // 2, geom[4])
        dy = rng.integers(-8, 9, size=yshape).astype(np.float32)
        _, vjp = jax.vjp(lambda q: jst.strided_pool_view(q, True), jnp.asarray(to_view(x)))
        want = from_view(vjp(jnp.asarray(to_view(dy)))[0], b)
        np.testing.assert_array_equal(pool_strided.pool133_s2_bwd_plain(_t(x), _t(dy)).numpy(), want)
        np.testing.assert_array_equal(pool_strided.pool133_s2_bwd(_t(x), _t(dy)).numpy(), want)
        xt = _t(x).requires_grad_(True)
        pool_strided.max_pool_133_s2(xt).backward(_t(dy))
        np.testing.assert_array_equal(xt.grad.numpy(), want)
        assert pool_strided.pool133_s2_bwd.launches == 0

    def test_odd_extent_rejected(self):
        with pytest.raises(ValueError):
            pool_strided.pool133_s2_fwd(torch.zeros(1, 2, 5, 4, 3))


def _nan_grid(rng, shape):
    """A tie grid with one NaN and a -inf block: windows whose maximum is
    NaN, windows of -inf only (some starting on a pad), and plain ones."""
    x = _tie_grid(rng, shape)
    x[0, 0, 0, 1, 0] = np.nan
    x[0, :, 2:, 2:, :] = -np.inf
    return x


class TestNanRule:
    """Each kernel's plain version against its JAX function where a NaN or a
    -inf reaches it: values and NaN positions equal, and the routed
    gradients equal."""

    @pytest.mark.parametrize("kernel", ["B1", "B3", "B4", "B5", "B6"])
    def test_plain_matches_jax(self, rng, kernel):
        b, shape = 1, (1, 2, 4, 4, 16)  # 16 channels: the s1 Pallas pool's tile
        x = _nan_grid(rng, shape)
        xv = jnp.asarray(to_view(x))
        if kernel == "B1":  # NaN in outputs 0..1 and -inf (as NaN) in 1..3 of H and W
            x = rng.integers(-3, 4, (1, 2, 4, 4, 24)).astype(np.float32)
            x[0, 0, 0, 0, 5] = np.nan
            x[0, :, 3, 3, :] = -np.inf
            pk = rng.integers(-2, 3, (4, 4, 4, 24, 64)).astype(np.float32)
            mean, var, bias = _bn(rng, 64)
            want = from_view(stem_conv_bn_relu_view_pallas(
                jnp.asarray(to_view(x)), jnp.asarray(pk), jnp.asarray(mean), jnp.asarray(var),
                jnp.asarray(bias), b, interpret=True), b)
            got = stem_conv.stem_conv_bn_relu(_t(x), _t(pk), _t(mean), _t(var), _t(bias)).numpy()
            assert np.isnan(want).any() and np.isfinite(want).any()
            # integer sums are exact; BN's f32 ops reassociate (as in the test above)
            scale = np.abs(want[np.isfinite(want)]).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)  # NaN where NaN
            return
        elif kernel in ("B3", "B4"):
            dy = rng.integers(1, 9, size=shape).astype(np.float32)
            y, vjp = jax.vjp(lambda q: s1_pool333_view_pallas(q, b, True), xv)
            if kernel == "B3":
                want, got = from_view(y, b), pool_s1.pool333_fwd(_t(x)).numpy()
            else:
                want = from_view(vjp(jnp.asarray(to_view(dy)))[0], b)
                got = pool_s1.pool333_bwd(_t(x), _t(dy)).numpy()
        else:
            dy = rng.integers(1, 9, size=(1, 2, 2, 2, 16)).astype(np.float32)
            y, vjp = jax.vjp(lambda q: jst.strided_pool_view(q, True), xv)
            if kernel == "B5":
                want, got = from_view(y, b), pool_strided.pool133_s2_fwd(_t(x)).numpy()
            else:  # the select-and-scatter backward the JAX package runs
                want = from_view(vjp(jnp.asarray(to_view(dy)))[0], b)
                got = pool_strided.pool133_s2_bwd(_t(x), _t(dy)).numpy()
                # the gated-off Pallas B6 routes nothing from the NaN window
                # (the index pair's rule), where select-and-scatter moves on
                pallas = from_view(s2_pool_view_bwd_pallas(xv, jnp.asarray(to_view(dy)),
                                                           interpret=True), b)
                idx = pool_strided.pool133_s2_pair_fwd_plain(_t(x))[1]
                np.testing.assert_array_equal(
                    pallas, pool_strided.pool133_s2_pair_bwd_plain(idx, _t(dy)).numpy())
                assert not np.array_equal(pallas, want)
        np.testing.assert_array_equal(got, want)  # NaN where NaN


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


class TestEmitB7:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_bit_equal_with_pallas_interpret(self, rng, dtype):
        """B7's plain version vs emit_tmajor in interpret mode: the same adv
        and mask bits after the layout change (lane = t'*B + b), with an
        engineered boundary hit: u8 0 under dl 0 is exactly lo, mask 1."""
        b, t, h, w, c = 2, 4, 6, 8, 24
        u8 = rng.integers(0, 256, (b, t, h, w, c), dtype=np.uint8)
        u8[0, 0, 0, 0, 0] = 0
        dl = rng.uniform(-0.3, 0.3, (t, c)).astype(np.float32)  # flag * pack(delta)
        dl[:, 0] = 0.0
        dl_lanes = np.broadcast_to(dl.T[:, :, None], (c, t, b)).reshape(c, t * b)
        want_adv, want_mask = jst.emit_tmajor(
            jnp.asarray(u8), jnp.asarray(dl_lanes), -1.0, 1.0, dtype, interpret=True
        )
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        adv, mask = packed_apply.emit_adv_mask(_t(u8), _t(dl), -1.0, 1.0, tdt)
        assert packed_apply.emit_adv_mask.launches == 0  # CPU: the plain version
        assert adv.dtype == tdt and mask.dtype == torch.uint8
        np.testing.assert_array_equal(
            adv.float().numpy(), from_view(np.asarray(want_adv, np.float32), b)
        )
        np.testing.assert_array_equal(mask.numpy(), from_view(np.asarray(want_mask), b))
        assert (mask.numpy() == 1).any()

    def test_no_grad_forward_asks_for_no_mask(self, rng):
        u8 = _t(rng.integers(0, 256, (1, 2, 2, 2, 24), dtype=np.uint8))
        dl = torch.zeros(2, 24)
        adv, mask = packed_apply.emit_adv_mask(u8, dl, -1.0, 1.0, torch.float32, want_mask=False)
        assert mask is None
        np.testing.assert_array_equal(adv.numpy(), u8.numpy().astype(np.float32) / 128.0 - 1.0)

    def test_operand_checks(self):
        with pytest.raises(TypeError):
            packed_apply.emit_adv_mask(torch.zeros(1, 2, 2, 2, 24), torch.zeros(2, 24),
                                       -1.0, 1.0, torch.float32)
        with pytest.raises(ValueError):
            packed_apply.emit_adv_mask(torch.zeros(1, 2, 2, 2, 24, dtype=torch.uint8),
                                       torch.zeros(3, 24), -1.0, 1.0, torch.float32)


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
        assert {"fav_pool_pair_fwd", "fav_pool_pair_bwd"} <= launchers  # B9
        listed = [s for names in kernels.KERNEL_SYMBOLS.values() for s in names]
        assert len(listed) == len(set(listed))
        assert set(listed) == globals_

"""Kernel B9 of the PyTorch port (pool values + first-match argmax index,
index-routing backward) held against the Pallas pair it replaces, and the
port's pool kernels B3/B5/B6 held against the other Pallas functions that
compute the same pools in other TPU layouts (``overlap_pool_333``,
``spatial_pool_132``, ``strided_spatial_pool_conv``).

The Pallas functions run in interpret mode on the CPU, as the JAX package's
own tests run them; on CPU tensors the port's wrappers compute their kernels'
plain versions, which is what is compared here (the CUDA kernels are held
against the plain versions on the card).  Inputs come from a numpy seed, in
f32.  Everything here must agree bit for bit: max is order-free, the index is
an integer, and a gradient cell sums at most 4 terms in ascending tap order
in both packages (an f32 add chain of the same terms in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.ops import pallas_pool as jpp
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided

# H != W, C not a multiple of 32, B*T odd, single plane
PAIR_GEOMS = [(2, 3, 8, 8, 4), (1, 3, 12, 16, 5), (1, 1, 16, 8, 2), (2, 2, 14, 6, 33)]
# the edge geometries of the strip kernels (B5, B6, B9)
STRIP_EDGES = [
    (1, 3, 2, 2, 8),     # one window: the pads in both axes; H' = W' = 1
    (2, 3, 6, 10, 40),   # 3 window rows
    (2, 1, 4, 6, 13),    # the scalar channel tail: C = 13
    (2, 3, 10, 2, 8),    # W' = 1
    (1, 1, 34, 8, 8),    # H' = 17: runs of window rows
    (1, 3, 8, 224, 40),  # C = 40 over 112 window columns: groups of channel vectors
]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def _grid(rng, shape, ties):
    if ties:
        return (rng.integers(0, 3, shape) * 0.5).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _pooled(shape):
    return (shape[0], shape[1], shape[2] // 2, shape[3] // 2, shape[4])


def _unview_idx(idx_t, b, c):
    """The Pallas index [T,Ho,Wo,B*C] bf16 as [B,T,Ho,Wo,C] uint8."""
    t, ho, wo, _ = idx_t.shape
    a = np.asarray(idx_t, np.float32).reshape(t, ho, wo, b, c)
    return a.transpose(3, 0, 1, 2, 4).astype(np.uint8)


class TestPairB9:
    @pytest.mark.parametrize("block", [None, 1])
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("shape", PAIR_GEOMS)
    def test_values_and_index_equal_pallas_interpret(self, rng, shape, ties, block):
        x = _grid(rng, shape, ties)
        want_y, want_idx = jpp._pair_fwd_impl(jnp.asarray(x), True, block)
        y, idx = pool_strided.pool133_s2_pair_fwd(_t(x))
        assert pool_strided.pool133_s2_pair_fwd.launches == 0  # CPU: the plain version
        assert idx.dtype == torch.uint8 and y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(idx.numpy(), _unview_idx(want_idx, shape[0], shape[4]))
        # the same values as B5
        np.testing.assert_array_equal(y.numpy(), pool_strided.pool133_s2_fwd(_t(x)).numpy())

    @pytest.mark.parametrize("block", [None, 1])
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("shape", PAIR_GEOMS)
    def test_gradient_equals_pallas_interpret(self, rng, shape, ties, block):
        x = _grid(rng, shape, ties)
        dy = rng.standard_normal(_pooled(shape)).astype(np.float32)
        want = jax.grad(
            lambda z: jnp.sum(jpp.strided_spatial_pool_pair(z, True, block) * jnp.asarray(dy))
        )(jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        pool_strided.max_pool_133_s2_pair(xt).backward(_t(dy))
        assert pool_strided.pool133_s2_pair_bwd.launches == 0
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
        # and B6's rule (the select-and-scatter the other variants run); B6
        # sums a cell's windows H first, then W, so only integers are exact
        dyi = rng.integers(-8, 9, _pooled(shape)).astype(np.float32)
        _, idx = pool_strided.pool133_s2_pair_fwd(_t(x))
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_pair_bwd(idx, _t(dyi)).numpy(),
            pool_strided.pool133_s2_bwd(_t(x), _t(dyi)).numpy(),
        )

    @pytest.mark.parametrize("grid", ["random", "ties", "NaN/-inf"])
    @pytest.mark.parametrize("shape", STRIP_EDGES)
    def test_strip_edges_equal_pallas_interpret(self, rng, shape, grid):
        """The forward's plain version (the CUDA kernel's reference on the
        card) against the Pallas pair in interpret mode at the edge
        geometries of the strip kernel: values and NaN positions equal, the
        index equal everywhere (9 where the value is NaN)."""
        x = _grid(rng, shape, grid != "random")
        if grid == "NaN/-inf":
            x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 50))] = np.nan
            x[:, :, shape[2] // 2:, shape[3] // 2:] = -np.inf
        want_y, want_idx = jpp._pair_fwd_impl(jnp.asarray(x), True)
        want_idx = _unview_idx(want_idx, shape[0], shape[4])
        for y, idx in (pool_strided.pool133_s2_pair_fwd_plain(_t(x)),
                       pool_strided.pool133_s2_pair_fwd(_t(x))):
            np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
            np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert pool_strided.pool133_s2_pair_fwd.launches == 0
        if grid == "NaN/-inf":
            assert (np.isnan(np.asarray(want_y)) == (want_idx == 9)).all()

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("grid", ["random", "ties", "NaN/-inf"])
    @pytest.mark.parametrize("shape", STRIP_EDGES)
    def test_backward_strip_edges_equal_pallas_interpret(self, rng, shape, grid, dtype):
        """The backward's plain version (the CUDA kernel's reference on the
        card) against the Pallas pair's backward in interpret mode at the
        strip kernel's edge geometries, routed by the Pallas forward's own
        index, tolerance 0.  In f32 both add a cell's terms in ascending k;
        in bf16 the TPU kernel adds in bf16 and the port in f32, rounding
        once, so dy there is integer-valued and every sum exact."""
        x = _grid(rng, shape, grid != "random")
        if grid == "NaN/-inf":
            x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 50))] = np.nan
            x[:, :, shape[2] // 2:, shape[3] // 2:] = -np.inf
        if dtype == "float32" and grid == "random":
            dy = rng.standard_normal(_pooled(shape)).astype(np.float32)
        else:
            dy = rng.integers(-8, 9, _pooled(shape)).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
        _, idx_t = jpp._pair_fwd_impl(xj, True)
        want = np.asarray(jpp._pair_vjp_bwd(True, None, idx_t, dyj)[0], np.float32)
        tdt = getattr(torch, dtype)
        idx = _t(_unview_idx(idx_t, shape[0], shape[4]))
        dyt = _t(dy).to(tdt)
        got = pool_strided.pool133_s2_pair_bwd(idx, dyt)
        assert got.dtype == tdt and pool_strided.pool133_s2_pair_bwd.launches == 0
        np.testing.assert_array_equal(got.float().numpy(), want)
        # the same index from the port's forward
        np.testing.assert_array_equal(idx.numpy(), pool_strided.pool133_s2_pair_fwd(
            _t(x).to(tdt))[1].numpy())

    def test_first_match_wins_and_edges(self):
        """A constant grid ties every candidate: k = 0 everywhere.  On a grid
        rising along W then H the last in-range tap wins: 8 inside, 7 / 5 / 4
        at the right / bottom / corner windows, whose taps {2,5,8} / {6,7,8}
        lie outside the frame."""
        _, idx = pool_strided.pool133_s2_pair_fwd(torch.ones(1, 1, 6, 6, 2))
        assert (idx == 0).all()
        ramp = torch.arange(36, dtype=torch.float32).reshape(1, 1, 6, 6, 1)
        _, idx = pool_strided.pool133_s2_pair_fwd(ramp)
        want = np.array([[8, 8, 7], [8, 8, 7], [5, 5, 4]], np.uint8)
        np.testing.assert_array_equal(idx[0, 0, :, :, 0].numpy(), want)
        jy, jidx = jpp._pair_fwd_impl(jnp.asarray(ramp.numpy()), True, 1)
        np.testing.assert_array_equal(_unview_idx(jidx, 1, 1)[0, 0, :, :, 0], want)

    def test_nan_and_all_minus_inf_follow_the_pallas_rule(self):
        """A NaN candidate makes the value NaN and the index 9 (no candidate
        equals NaN); a window of -inf only picks tap 0."""
        x = np.zeros((1, 1, 4, 4, 1), np.float32)
        x[0, 0, 0, 1, 0] = np.nan
        x[0, 0, 2:, 2:, 0] = -np.inf
        want_y, want_idx = jpp._pair_fwd_impl(jnp.asarray(x), True, None)
        y, idx = pool_strided.pool133_s2_pair_fwd(_t(x))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
        np.testing.assert_array_equal(idx.numpy(), _unview_idx(want_idx, 1, 1))
        assert idx[0, 0, 0, 0, 0] == 9 and idx[0, 0, 1, 1, 0] == 0
        dx = pool_strided.pool133_s2_pair_bwd(idx, torch.ones(1, 1, 2, 2, 1))
        assert dx[0, 0, :2, :2].abs().sum() == 0  # index 9 routes nowhere

    def test_autograd_op_saves_the_index_and_never_x(self, rng):
        x = _t(_grid(rng, (1, 2, 8, 8, 4), False)).requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
            y = pool_strided.max_pool_133_s2_pair(x)
        assert [(s.dtype, tuple(s.shape)) for s in saved] == [(torch.uint8, (1, 2, 4, 4, 4))]
        assert y.grad_fn is not None

    def test_no_grad_forward_stores_no_index(self, rng):
        x = _t(_grid(rng, (1, 2, 4, 4, 3), False))
        y, idx = pool_strided.pool133_s2_pair_fwd(x, want_idx=False)
        assert idx is None
        np.testing.assert_array_equal(y.numpy(), pool_strided.pool133_s2_fwd(x).numpy())
        with torch.no_grad():
            out = pool_strided.max_pool_133_s2_pair(x.clone().requires_grad_(True))
        assert out.grad_fn is None

    def test_bf16_backward_rounds_once(self, rng):
        x = _t(_grid(rng, (1, 2, 8, 8, 4), True)).bfloat16()
        dy = _t(rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)).bfloat16()
        y, idx = pool_strided.pool133_s2_pair_fwd(x)
        got = pool_strided.pool133_s2_pair_bwd(idx, dy)
        want = pool_strided.pool133_s2_pair_bwd(idx, dy.float()).bfloat16()
        assert got.dtype == y.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())

    def test_operand_checks(self):
        with pytest.raises(ValueError):
            pool_strided.pool133_s2_pair_fwd(torch.zeros(1, 2, 5, 4, 3))
        # the strip kernel's width limit, with B6's message
        with pytest.raises(ValueError, match="the B9 forward kernel takes a width up to 1024"):
            pool_strided.pool133_s2_pair_fwd(torch.zeros(1, 1, 2, 1026, 1))
        with pytest.raises(ValueError, match="the B9 backward kernel takes a width up to 1024"):
            pool_strided.pool133_s2_pair_bwd(torch.zeros(1, 1, 1, 513, 1, dtype=torch.uint8),
                                             torch.zeros(1, 1, 1, 513, 1))
        with pytest.raises(ValueError):
            pool_strided.pool133_s2_pair_bwd(torch.zeros(1, 2, 2, 2, 3), torch.zeros(1, 2, 2, 2, 3))
        with pytest.raises(ValueError):
            pool_strided.pool133_s2_pair_bwd(
                torch.zeros(1, 2, 2, 3, 3, dtype=torch.uint8), torch.zeros(1, 2, 2, 2, 3))


class TestOtherPallasLayoutsOfB3:
    """``overlap_pool_333`` computes B3's function in three TPU blockings."""

    @pytest.mark.parametrize("layout,shape", [
        ("conv", (2, 4, 8, 8, 4)),
        ("conv", (1, 3, 7, 7, 5)),
        ("plain", (1, 3, 7, 7, 5)),       # per-plane kernel
        ("plain", (2, 5, 4, 6, 3)),
        ("plain", (2, 16, 4, 4, 8)),      # T-blocked kernel
    ])
    @pytest.mark.parametrize("ties", [False, True])
    def test_b3_plain_equals_overlap_pool_333(self, rng, layout, shape, ties):
        if layout == "plain" and shape[1] == 16:
            assert jpp._pick_t_block(shape[1], *shape[2:], 4) > 1
        x = _grid(rng, shape, ties)
        want = jpp.overlap_pool_333(jnp.asarray(x), True, layout=layout)
        got = pool_s1.pool333_fwd(_t(x))
        assert pool_s1.pool333_fwd.launches == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestOtherPallasLayoutsOfB5:
    """``spatial_pool_132`` and ``strided_spatial_pool_conv`` compute B5's
    function; their backward is XLA's select-and-scatter, B6's rule."""

    @pytest.mark.parametrize("name", ["spatial_pool_132", "strided_spatial_pool_conv"])
    @pytest.mark.parametrize("ties", [False, True])
    @pytest.mark.parametrize("shape", [(2, 3, 8, 8, 4), (1, 2, 12, 16, 3), (2, 2, 14, 14, 8)])
    def test_b5_b6_plain_equal_values_and_vjp(self, rng, name, ties, shape):
        fn = getattr(jpp, name)
        x = _grid(rng, shape, ties)
        dy = rng.integers(-8, 9, _pooled(shape)).astype(np.float32)
        y, vjp = jax.vjp(lambda z: fn(z, True), jnp.asarray(x))
        (dx,) = vjp(jnp.asarray(dy))
        np.testing.assert_array_equal(pool_strided.pool133_s2_fwd(_t(x)).numpy(), np.asarray(y))
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_bwd(_t(x), _t(dy)).numpy(), np.asarray(dx)
        )
        assert pool_strided.pool133_s2_fwd.launches == pool_strided.pool133_s2_bwd.launches == 0


class TestModelSwitch:
    def test_pair_pools_leave_logits_and_input_gradient_unchanged(self, rng):
        """InceptionI3D at frames=8, size=32 in f32: the pair computes the
        same values (logits bit-equal) and the same routing; the gradient may
        differ by f32 sum order where a cell collects several windows
        (B6 routes H then W, the pair sums in tap order): 1e-6 absolute."""
        sd = init_i3d_state(3, 400)
        x = rng.uniform(-1, 1, (1, 8, 32, 32, 3)).astype(np.float32)
        out = {}
        for pools in ((), ("MaxPool3d_2a_3x3", "MaxPool3d_3a_3x3")):
            model = InceptionI3D(400, torch.float32, device="cpu", pair_pools=pools)
            model.load_state_dict(sd)
            xt = _t(x).requires_grad_(True)
            logits, _ = model(xt)
            logits.square().sum().backward()
            out[pools] = (logits.detach().numpy(), xt.grad.numpy())
        (l0, g0), (l1, g1) = out.values()
        np.testing.assert_array_equal(l0, l1)
        assert np.abs(g0).max() > 0
        np.testing.assert_allclose(g1, g0, atol=1e-6 * max(1.0, np.abs(g0).max()), rtol=0)

    def test_unknown_endpoint_rejected(self):
        with pytest.raises(ValueError, match="pair_pools"):
            InceptionI3D(400, torch.float32, device="cpu", pair_pools=("MaxPool3d_4a_3x3",))

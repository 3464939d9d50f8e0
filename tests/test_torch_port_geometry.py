"""Odd geometries in the PyTorch port, held against the JAX package in f32 on
the CPU: the unpacked 7x7x7 stride-2 stem at an odd T, H or W (the JAX
package's ``Unit3D`` stem), the generic (1,3,3)/(1,2,2) pool at an odd
extent of MaxPool3d_2a/3a/4a, the whole net at odd and not-multiple-of-8
sizes, the attack step there, and kernel B1's column segments for rows wider
than its 128 columns.

Tolerances: per op on integer-tie grids, bit-equal (the same maxima, the same
first-match routing, sums of at most a few integers); the stem's values and
input gradient, 1e-5 relative to the largest (f32 reassociation of a 1,029-tap
sum); the whole net, the ``atol=rtol=1e-4`` of test_torch_port_i3d.py; the
attack step, the 1e-5 relative loss terms and 1e-6 absolute delta of
test_torch_port_engine.py.  B1's segments are bit-equal to one launch of its
plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.attack import FlickerSpec as JaxSpec
from flickering_adversarial_video_tpu.engine import AttackConfig as JaxConfig
from flickering_adversarial_video_tpu.engine import AttackEngine as JaxEngine
from flickering_adversarial_video_tpu.engine import RuntimeFlags as JaxFlags
from flickering_adversarial_video_tpu.models.i3d import InceptionI3D as JaxI3D
from flickering_adversarial_video_tpu.ops import maxpool as jmaxpool
from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
from flickering_adversarial_video_tpu_torch.convert import (
    from_flax_variables, init_i3d_state, to_flax_variables)
from flickering_adversarial_video_tpu_torch.engine import AttackEngine, RuntimeFlags
from flickering_adversarial_video_tpu_torch.models import i3d as ti3d
from flickering_adversarial_video_tpu_torch.ops import conv_unit, maxpool, stem_conv
from flickering_adversarial_video_tpu_torch.ops.space_to_depth import pack_input

K = 7
# (T, H, W): odd everywhere (unpacked stem, generic pools from 2a on); even
# but no multiple of 8 (packed stem, B5 at 2a, generic pool from 3a on)
GEOMETRIES = [(9, 17, 17), (8, 20, 20)]
STEPS = 3
TERMS = ("total_loss", "adv_loss", "reg_loss", "l12", "norm_reg", "diff_norm_reg",
         "laplacian_norm_reg", "prob_to_min", "prob_to_max", "thickness", "roughness")


@pytest.fixture(scope="module")
def flax_vars():
    """Seeded random weights as the JAX I3D's Flax tree (the JAX package's
    own init_i3d_params takes 15 s to trace)."""
    return to_flax_variables(init_i3d_state(5, K))


@pytest.fixture(scope="module")
def model(flax_vars):
    m = ti3d.InceptionI3D(K, torch.float32, device="cpu")
    m.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, flax_vars)))
    return m


def _clip(geometry, seed=1):
    t, h, w = geometry
    return np.random.default_rng(seed).uniform(-1, 1, (2, t, h, w, 3)).astype(np.float32)


def _weights():
    return np.random.default_rng(2).normal(size=(2, K)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_net(flax_vars):
    """Per geometry: the JAX model's (logits, endpoints, d(sum(logits * w))/dx)."""
    jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
    w = jnp.asarray(_weights())

    def f(x):
        logits, ep = jm.apply(flax_vars, x)
        return jnp.sum(logits * w), (logits, ep)

    grad_fn = jax.jit(jax.value_and_grad(f, has_aux=True))
    out = {}
    for g in GEOMETRIES:
        (_, (logits, ep)), grad = grad_fn(jnp.asarray(_clip(g)))
        out[g] = (np.asarray(logits), {k: np.asarray(v) for k, v in ep.items()}, np.asarray(grad))
    return out


class TestUnpackedStem:
    @pytest.mark.parametrize("geometry", [(9, 17, 17), (9, 16, 16), (8, 17, 16)])
    def test_values_and_input_gradient_match_the_jax_unit3d(self, flax_vars, model, geometry):
        jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32, final_endpoint="Conv3d_1a_7x7")
        clip = _clip(geometry)
        g = np.random.default_rng(3).normal(size=(2, *[(s + 1) // 2 for s in geometry], 64))
        g = g.astype(np.float32)
        want, vjp = jax.vjp(lambda x: jm.apply(flax_vars, x)[0], jnp.asarray(clip))
        (want_dx,) = vjp(jnp.asarray(g))
        x = torch.from_numpy(clip).requires_grad_(True)
        got = model(x, final_endpoint="Conv3d_1a_7x7")[0]
        got.backward(torch.from_numpy(g))
        want, want_dx = np.asarray(want), np.asarray(want_dx)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(x.grad.numpy(), want_dx, rtol=0,
                                   atol=1e-5 * np.abs(want_dx).max())

    @pytest.mark.parametrize("extent,pads", [(63, (3, 3)), (64, (2, 3)), (17, (3, 3)), (20, (2, 3))])
    def test_same_pads(self, extent, pads):
        assert maxpool.same_pads(extent, 7, 2)[1:] == pads

    def test_equals_the_packed_stem_at_even_extents(self, model):
        """SAME pads (2,3): the unpacked stride-2 conv and the packed stem
        (B1's plain version) compute one function, to reassociation."""
        x = torch.from_numpy(_clip((8, 20, 20)))
        st = model.Conv3d_1a_7x7
        bn = st.batch_norm
        unpacked = conv_unit.conv_bn_relu(x, st.conv_3d.weight, bn.running_mean,
                                          bn.running_var, bn.bias, stride=(2, 2, 2))
        packed = stem_conv.stem_conv_bn_relu(pack_input(x), *model.stem_params())
        torch.testing.assert_close(unpacked, packed, rtol=0, atol=1e-5 * packed.abs().max().item())

    def test_route_by_geometry(self, model, monkeypatch):
        """The packed stem (B1) exactly when T, H and W are even."""
        calls = []
        real = ti3d.stem_bn_relu
        monkeypatch.setattr(ti3d, "stem_bn_relu", lambda *a: calls.append(1) or real(*a))
        with torch.no_grad():
            for g, packed in (((8, 16, 16), True), ((9, 16, 16), False), ((8, 15, 16), False),
                              ((8, 16, 17), False)):
                model(torch.zeros(1, *g, 3), final_endpoint="Conv3d_1a_7x7")
                assert len(calls) == int(packed), g
                calls.clear()


def _int_grid(rng, shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


class TestGenericStridedPool:
    @pytest.mark.parametrize("shape", [(2, 3, 5, 7, 8), (1, 2, 9, 6, 4), (1, 4, 6, 11, 3),
                                       (2, 1, 55, 55, 2)])
    def test_odd_extent_matches_jax_on_ties(self, shape):
        """MaxPool3d_2a/3a at an odd H or W: SAME pads (1,1) there; the
        values and XLA's select-and-scatter routing (first maximum in raster
        order on tie grids) bit for bit."""
        rng = np.random.default_rng(7)
        x = _int_grid(rng, shape)
        y, vjp = jax.vjp(lambda q: jmaxpool.max_pool_same(q, (1, 3, 3), (1, 2, 2)), jnp.asarray(x))
        dy = rng.integers(-8, 9, size=y.shape).astype(np.float32)
        (want_dx,) = vjp(jnp.asarray(dy))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = maxpool.max_pool_same(xt, (1, 3, 3), (1, 2, 2))
        got.backward(torch.from_numpy(dy))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))

    @pytest.mark.parametrize("shape", [(1, 5, 7, 7, 4), (2, 4, 6, 5, 3), (1, 4, 8, 8, 2)])
    def test_pool4a_matches_jax_on_ties(self, shape):
        """MaxPool3d_4a: the spatial pool (generic at an odd extent, B5's
        route at even ones) then the temporal, against one (3,3,3)/(2,2,2)
        SAME pool."""
        rng = np.random.default_rng(8)
        x = _int_grid(rng, shape)
        y, vjp = jax.vjp(lambda q: jmaxpool.max_pool_same(q, (3, 3, 3), (2, 2, 2)), jnp.asarray(x))
        dy = rng.integers(-8, 9, size=y.shape).astype(np.float32)
        (want_dx,) = vjp(jnp.asarray(dy))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = maxpool.pool4a(xt)
        got.backward(torch.from_numpy(dy))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))

    @pytest.mark.parametrize("pair", [False, True])
    def test_route_by_geometry(self, monkeypatch, pair):
        """B5/B6 (or the pair B9) at even extents, the generic pool at an odd
        one, with the pair switch set or not (the JAX package gates its
        Pallas pools on even H and W)."""
        m = ti3d.InceptionI3D(K, torch.float32, device="cpu",
                              pair_pools=ti3d.PAIR_POOL_ENDPOINTS if pair else ())
        calls = []
        for name in ("max_pool_133_s2", "max_pool_133_s2_pair"):
            real = getattr(ti3d, name)
            monkeypatch.setattr(ti3d, name, lambda v, n=name, r=real: calls.append(
                (n, tuple(v.shape[2:4]))) or r(v))
        kernel = "max_pool_133_s2_pair" if pair else "max_pool_133_s2"
        with torch.no_grad():
            m(torch.zeros(1, 8, 20, 20, 3), final_endpoint="MaxPool3d_3a_3x3")  # 2a 10x10, 3a 5x5
            assert calls == [(kernel, (10, 10))]
            calls.clear()
            m(torch.zeros(1, 9, 17, 17, 3), final_endpoint="MaxPool3d_3a_3x3")  # 9x9, 5x5
            assert calls == []


class TestWholeNet:
    @pytest.mark.parametrize("geometry", GEOMETRIES)
    def test_endpoints_and_logits_match_jax(self, jax_net, model, geometry):
        jl, jep, _ = jax_net[geometry]
        with torch.no_grad():
            tl, tep = model(torch.from_numpy(_clip(geometry)))
        for name in tep:
            assert tep[name].shape == jep[name].shape, name
            np.testing.assert_allclose(tep[name].numpy(), jep[name], atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("geometry", GEOMETRIES)
    def test_input_gradient_matches_jax(self, jax_net, model, geometry):
        """As test_torch_port_i3d.py: near-tied pool argmaxes may reroute a
        few entries across backends; 1e-3 of the largest everywhere, 1e-5 on
        99.9% of the entries."""
        jg = jax_net[geometry][2]
        x = torch.from_numpy(_clip(geometry)).requires_grad_(True)
        (model(x)[0] * torch.from_numpy(_weights())).sum().backward()
        err = np.abs(x.grad.numpy() - jg) / np.abs(jg).max()
        assert err.max() < 1e-3
        assert (err < 1e-5).mean() > 0.999


@pytest.fixture(scope="module")
def step_runs(flax_vars, model):
    """Per geometry: the metrics of 3 train steps and the final delta, JAX
    (its generic path: no packed forward is given) and the port (the packed
    input head where T, H, W are even, else the generic path)."""
    jm = JaxI3D(num_classes=K, compute_dtype=jnp.float32)
    out = {}
    for g in GEOMETRIES:
        rng = np.random.default_rng(4)
        video = rng.integers(0, 256, (2, *g, 3), dtype=np.uint8)
        labels = rng.integers(0, K, (2,))
        jeng = JaxEngine(lambda v, x: jm.apply(v, x)[0], flax_vars, JaxSpec(frames=g[0]),
                         JaxConfig())
        jbatch = {"video": jnp.asarray(video), "labels": jnp.asarray(labels)}
        state, jm_ = jeng.init_state(), []
        for _ in range(STEPS):
            state, mt = jeng.train_step(state, jbatch, JaxFlags(), jax.random.key(0))
            jm_.append({k: float(mt[k]) for k in TERMS})
        eng = AttackEngine(model, FlickerSpec(frames=g[0]))
        batch = {"video": video, "labels": labels}
        tstate, tm = eng.init_state(), []
        for _ in range(STEPS):
            tstate, mt = eng.train_step(tstate, batch, RuntimeFlags())
            tm.append({k: float(mt[k]) for k in TERMS})
        out[g] = (jm_, np.asarray(state.delta), tm, tstate.delta.numpy(),
                  eng.prepare_batch(batch)[1])
    return out


class TestAttackStep:
    @pytest.mark.parametrize("geometry", GEOMETRIES)
    def test_loss_terms_and_delta_match_jax(self, step_runs, geometry):
        jm, jdelta, tm, tdelta, _ = step_runs[geometry]
        for s in range(STEPS):
            for k in TERMS:
                assert tm[s][k] == pytest.approx(jm[s][k], rel=1e-5, abs=1e-9), (s, k)
        assert np.abs(jdelta).max() > 1e-3
        np.testing.assert_allclose(tdelta, jdelta, atol=1e-6, rtol=0)

    @pytest.mark.parametrize("geometry,packed", [(GEOMETRIES[0], False), (GEOMETRIES[1], True)])
    def test_input_path_by_geometry(self, step_runs, geometry, packed):
        """An odd T, H or W takes the generic input path (no B7, no
        prepack), as the JAX package's ``packable`` gate; even ones the
        packed input head."""
        assert step_runs[geometry][4] is packed


class TestStemSegments:
    @pytest.mark.parametrize("w", [1, 4, 100, 128, 129, 144, 200, 256, 300, 513])
    def test_segments_cover_the_row_with_their_halos(self, w):
        segs = stem_conv.stem_segments(w)
        assert segs[0][0] == 0 and segs[-1][1] == w
        for (a, b, lo, hi), nxt in zip(segs, segs[1:] + [None]):
            assert lo == max(a - 1, 0) and hi == min(b + 2, w) and hi - lo <= stem_conv.MAX_W
            if nxt is not None:
                assert nxt[0] == b
        if w <= 128:
            assert segs == [(0, w, 0, w)]
        else:  # the fewest: the row and its halos need more than one segment fewer
            assert w + 3 * (len(segs) - 2) > (len(segs) - 1) * stem_conv.MAX_W

    @pytest.mark.parametrize("w", [129, 144])
    @pytest.mark.parametrize("max_w", [128, 64, 9])
    def test_segmented_equals_one_plain_launch(self, model, w, max_w):
        """B1's route above 128 columns, run here with its plain version as
        the per-segment function: bit-equal to the plain version over the
        whole row (every output sums the same taps in the same order)."""
        xp = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 3, 4, w, 24))
                              .astype(np.float32))
        params = model.stem_params()
        full = stem_conv.stem_conv_bn_relu_plain(xp, *params)
        seg = stem_conv.segmented(xp, lambda v: stem_conv.stem_conv_bn_relu_plain(v, *params), max_w)
        assert len(stem_conv.stem_segments(w, max_w)) > 1
        torch.testing.assert_close(seg, full, rtol=0, atol=0)

    def test_stem_with_input_gradient_at_a_wide_row(self, model):
        """The stem with an input gradient (the float-clip path) at W' = 144,
        --size 288: B1's wrapper and its backward (B2) take the width."""
        xp = torch.from_numpy(np.random.default_rng(10).normal(size=(1, 2, 2, 144, 24))
                              .astype(np.float32)).requires_grad_(True)
        y = stem_conv.stem_bn_relu(xp, *model.stem_params())
        y.sum().backward()
        assert y.shape == (1, 2, 2, 144, 64) and xp.grad.shape == xp.shape
        assert torch.isfinite(xp.grad).all()

"""The port's video ResNets (r3d_18, mc3_18, r2plus1d_18, r2plus1d_34) held
against the JAX package's, in f32 on the CPU at T=4, 16x16, B=2.

Weights: the port's seeded torchvision-layout state dict
(``convert.video_resnet_state_dict``: every tensor random, BN statistics
included), carried to the JAX model by ``convert/flax_video_resnet.py``.
Tolerances: logits within 1e-4 of the largest logit (f32 reassociation);
weight files bit-equal.  The attack's d(delta) through these models is
held in tests/test_torch_port_resnet_grad.py.

Batch-norm: flax's ``_normalize`` arithmetic, op for op.  XLA's CPU rsqrt
is not correctly rounded (within 1 ulp; about 85% of values exact) and
neither is torch's (1/sqrt, rounded twice), so the bit-equality is held on
statistics whose ``var + eps`` is a power of 4 (an exact rsqrt in both);
other statistics agree within that ulp.  Jitted, XLA contracts the f32
multiply-add into an FMA: bit-equal in bf16, within an ulp in f32.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu.convert import convert_video_resnet_state_dict as j_convert
from flickering_adversarial_video_tpu.convert import golden as jgolden
from flickering_adversarial_video_tpu.models.video_resnet import VideoResNet as JResNet
from flickering_adversarial_video_tpu_torch.convert import (
    cli, convert_video_resnet_state_dict, golden, load_weights, save_weights,
    video_resnet_state_dict, write_torchvision_pth)
from flickering_adversarial_video_tpu_torch.convert.flax_video_resnet import (
    from_flax_variables, to_flax_variables)
from flickering_adversarial_video_tpu_torch.models import video_resnet as tvr
from flickering_adversarial_video_tpu_torch.models.registry import MODEL_REGISTRY, create_model

VARIANTS = ("r3d_18", "mc3_18", "r2plus1d_18", "r2plus1d_34")
K, B, FRAMES, SIZE = 7, 2, 4, 16


def _state(variant, k=K, seed=1):
    return {n: torch.from_numpy(v) for n, v in video_resnet_state_dict(variant, k, seed).items()}


def _model(variant, state, dtype=torch.float32):
    m = tvr.VideoResNet(variant, int(state["fc.weight"].shape[0]), dtype, device="cpu")
    m.load_state_dict(state)
    return m


def _jax_variables(variant, state):
    return jax.tree_util.tree_map(jnp.asarray, to_flax_variables(state, variant))


def _clip(seed=0):
    return np.random.default_rng(seed).normal(size=(B, FRAMES, SIZE, SIZE, 3)).astype(np.float32)


class TestForward:
    @pytest.mark.parametrize("variant,k", [(v, K) for v in VARIANTS]
                             + [("r2plus1d_34", 359), ("r2plus1d_34", 487)])
    def test_logits_match_jax(self, variant, k):
        """The same weights and clip through both packages' models."""
        state = _state(variant, k)
        x = _clip()
        want = np.asarray(JResNet(variant, k, jnp.float32).apply(_jax_variables(variant, state), x))
        with torch.no_grad():
            got = _model(variant, state)(torch.from_numpy(x)).numpy()
        assert got.shape == (B, k) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    @pytest.mark.parametrize("variant", VARIANTS)
    def test_state_names_and_shapes_are_torchvisions(self, variant):
        """The JAX package's torchvision converter reads every tensor of the
        port's state dict but the BN counters, and gives the tree of the JAX
        model's shapes."""
        state = {k: v.numpy() for k, v in _state(variant).items()}
        read = set()

        class Recording(dict):
            def __getitem__(self, k):
                read.add(k)
                return dict.__getitem__(self, k)

        tree = j_convert(Recording(state), variant)
        assert read == {k for k in state if not k.endswith("num_batches_tracked")}
        want = jax.eval_shape(JResNet(variant, K).init, jax.random.key(0),
                              jnp.zeros((1, FRAMES, SIZE, SIZE, 3)))
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape

    def test_stem_forms_agree(self):
        """The packed stem (taken on an even H and W) and the plain
        (kt,7,7) stride-(1,2,2) conv compute one function; an odd size takes
        the plain form."""
        g = torch.Generator().manual_seed(0)
        for kt in (1, 3):
            w = torch.randn(8, 3, kt, 7, 7, generator=g)
            x = torch.randn(2, 4, 18, 14, 3, generator=g)
            torch.testing.assert_close(tvr.stem_conv_packed(x, w), tvr.stem_conv_plain(x, w),
                                       rtol=1e-5, atol=1e-5)
        state = _state("r3d_18")
        odd = np.random.default_rng(2).normal(size=(1, FRAMES, 15, 17, 3)).astype(np.float32)
        want = np.asarray(JResNet("r3d_18", K, jnp.float32).apply(
            _jax_variables("r3d_18", state), odd))
        with torch.no_grad():
            got = _model("r3d_18", state)(torch.from_numpy(odd)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    def test_bf16_forward_is_finite_and_near_f32(self):
        state = _state("r2plus1d_18")
        x = torch.from_numpy(_clip())
        with torch.no_grad():
            f32 = _model("r2plus1d_18", state)(x)
            bf16 = _model("r2plus1d_18", state, torch.bfloat16)(x)
        assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
        assert (bf16 - f32).abs().max() < 0.1 * f32.abs().max()

    def test_registry(self):
        for name in VARIANTS:
            spec = MODEL_REGISTRY[name]
            assert spec.norm_world == "meanstd" and spec.default_size == 112
            assert spec.default_frames == (32 if name == "r2plus1d_34" else 16)
            model, _ = create_model(name, num_classes=K, device="meta")
            assert isinstance(model, tvr.VideoResNet) and model.variant == name
        with pytest.raises(ValueError, match="max-pool"):
            create_model("r3d_18", device="meta", pair_pools=("MaxPool3d_2a_3x3",))


def _power_of_4_var(rng, c, eps=np.float32(1e-5)):
    """Statistics whose var + eps (in f32) is a power of 4."""
    var = np.empty(c, np.float32)
    for i, t in enumerate(np.float32([0.25, 1.0, 4.0, 16.0, 0.0625])[rng.integers(0, 5, c)]):
        v = np.float32(t - eps)
        while np.float32(v + eps) != t:
            v = np.nextafter(v, np.float32(np.inf) if np.float32(v + eps) < t else -np.inf)
        var[i] = v
    return var


class TestBatchNorm:
    C = 45

    def _case(self, exact_rsqrt):
        rng = np.random.default_rng(4)
        x = (rng.normal(size=(2, 3, 5, 5, self.C)) * 3).astype(np.float32)
        var = (_power_of_4_var(rng, self.C) if exact_rsqrt
               else rng.uniform(0.5, 1.5, self.C).astype(np.float32))
        p = {"scale": rng.uniform(0.5, 1.5, self.C).astype(np.float32),
             "bias": rng.normal(0, 0.1, self.C).astype(np.float32)}
        s = {"mean": rng.normal(0, 0.1, self.C).astype(np.float32), "var": var}
        return x, p, s

    @staticmethod
    def _both(x, p, s, jdt, tdt, jit=False):
        bn = nn.BatchNorm(use_running_average=True, epsilon=1e-5, momentum=0.9, dtype=jdt,
                          param_dtype=jnp.float32)
        f = lambda v, xx: bn.apply(v, xx)
        f = jax.jit(f) if jit else f
        want = np.asarray(f({"params": p, "batch_stats": s}, jnp.asarray(x).astype(jdt))
                          .astype(jnp.float32))
        got = tvr.batch_norm(torch.from_numpy(x).to(tdt), *(torch.from_numpy(a) for a in (
            p["scale"], p["bias"], s["mean"], s["var"])))
        assert got.dtype == tdt
        return got.float().numpy(), want

    @pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                         (jnp.bfloat16, torch.bfloat16)])
    def test_bit_equal_to_flax(self, jdt, tdt):
        got, want = self._both(*self._case(True), jdt, tdt)
        np.testing.assert_array_equal(got, want)
        if tdt == torch.bfloat16:  # jitted too: the FMA's f32 rounding vanishes in bf16
            got, want = self._both(*self._case(True), jdt, tdt, jit=True)
            np.testing.assert_array_equal(got, want)

    def test_any_statistics_within_the_rsqrt_ulp(self):
        got, want = self._both(*self._case(False), jnp.float32, torch.float32)
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=1e-6)


class TestWeightFiles:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_torchvision_pth_through_both_converters(self, variant, tmp_path):
        """A torchvision .pth read by both packages' converters gives the same
        tensors (the JAX tree carried back by the port's bridge), as written;
        a 'module.' prefix (``nn.DataParallel``'s) is stripped."""
        pth = write_torchvision_pth(str(tmp_path / "p.pth"), variant, num_classes=K, seed=3)
        sd = torch.load(pth, weights_only=True)
        ours = convert_video_resnet_state_dict(pth, variant)
        jvars = j_convert({k: v.numpy() for k, v in sd.items()}, variant)
        back = from_flax_variables(jax.tree_util.tree_map(np.asarray, jvars), variant)
        assert set(ours) == set(back) == set(sd)
        for k, v in ours.items():
            assert torch.equal(back[k], v) and torch.equal(sd[k].to(v.dtype), v), k
        torch.save({f"module.{k}": v for k, v in sd.items()}, str(tmp_path / "dp.pth"))
        got = load_weights(str(tmp_path / "dp.pth"), model_name=variant)
        assert all(torch.equal(got[k], ours[k]) for k in ours)

    def test_converter_refuses_bad_state(self, tmp_path):
        sd = _state("r3d_18")
        with pytest.raises(ValueError, match="7 classes, not 400"):
            convert_video_resnet_state_dict(sd, "r3d_18", num_classes=400)
        bad = dict(sd)
        bad["layer1.0.conv1.0.weight"] = torch.zeros(64, 64, 3, 3, 1)
        with pytest.raises(ValueError, match="shape"):
            convert_video_resnet_state_dict(bad, "r3d_18")
        with pytest.raises(ValueError, match="missing"):
            convert_video_resnet_state_dict(sd, "r2plus1d_18")
        del bad["stem.1.num_batches_tracked"]  # optional, as torchvision's older files
        bad["layer1.0.conv1.0.weight"] = sd["layer1.0.conv1.0.weight"]
        assert int(convert_video_resnet_state_dict(bad, "r3d_18")["stem.1.num_batches_tracked"]) == 0

    @pytest.mark.parametrize("variant", ["mc3_18", "r2plus1d_34"])
    def test_msgpack_and_cli(self, variant, tmp_path, capsys):
        """The CLI converts a torchvision .pth to the JAX package's .msgpack
        (flax reads it as the JAX converter's tree) and back to a .pt."""
        import flax.serialization

        pth = write_torchvision_pth(str(tmp_path / "v.pth"), variant, num_classes=K, seed=5)
        mp = str(tmp_path / "v.msgpack")
        cli.main([variant, pth, "--out", mp])
        assert f"wrote {mp}" in capsys.readouterr().out
        with open(mp, "rb") as f:
            tree = flax.serialization.msgpack_restore(f.read())
        want = j_convert({k: v.numpy() for k, v in torch.load(pth, weights_only=True).items()},
                         variant)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        pt = str(tmp_path / "v.pt")
        cli.main([variant, mp, "--out", pt])
        ref = convert_video_resnet_state_dict(pth, variant)
        got = load_weights(pt, model_name=variant)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
        save_weights(ref, str(tmp_path / "again.msgpack"), variant)
        again = load_weights(str(tmp_path / "again.msgpack"), model_name=variant)
        assert all(torch.equal(again[k], ref[k]) for k in ref)

    def test_golden_in_the_jax_format(self, tmp_path, monkeypatch):
        """The port's golden file of a video ResNet (the mean/std canonical
        clip) against the JAX package's dump of the same weights."""
        monkeypatch.setitem(golden.GOLDEN_GEOMETRY, "meanstd", (FRAMES, SIZE))
        monkeypatch.setitem(jgolden.GOLDEN_GEOMETRY, "meanstd", (FRAMES, SIZE))
        np.testing.assert_array_equal(golden.canonical_clip("meanstd", FRAMES, SIZE),
                                      jgolden.canonical_clip("meanstd", FRAMES, SIZE))
        pth = write_torchvision_pth(str(tmp_path / "w.pth"), "r2plus1d_18", num_classes=K)
        jnpz, npz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        state = convert_video_resnet_state_dict(pth, "r2plus1d_18")
        jgolden.dump_golden("r2plus1d_18", _jax_variables("r2plus1d_18", state), jnpz, pth,
                            num_classes=K)
        cli.main(["r2plus1d_18", pth, "--dump-golden", npz, "--device", "cpu"])
        got, want = np.load(npz), np.load(jnpz)
        assert set(got.files) == set(want.files)
        for k in ("model", "num_classes", "frames", "size", "seed", "norm_world", "top5"):
            assert (got[k] == want[k]).all(), k
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=1e-4 * np.abs(want["logits"]).max())
        golden.verify_golden(npz, device="cpu")

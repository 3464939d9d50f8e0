"""The port's TV-L1 optical flow (``data/optical_flow.py``) and the flow branch
of ``data/video.py`` held against the JAX package's on the CPU.

Inputs are made by the JAX tests' ``_smooth_image`` recipe (blurred uniform
noise on the 0..255 gray scale).  The stencils, ``rgb_to_gray`` and
``postprocess_flow`` are exact.  ``_warp`` is exact: the port rounds each
corner's product into the running sum once, as XLA's fused sum does.  The
resize is exact at a zoom of 0.5 (the pyramid of even sizes); at other sizes
XLA computes its weight matrix inside the fused program and rounds some
weights an ulp away from ``jax.image.scale_and_translate``'s own
(the port's equal those exactly), so the values there are held to 1e-6 of
the image's largest value (a few f32 ulps at 255).
"""

import numpy as np
import pytest
import torch

import jax
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from flickering_adversarial_video_tpu.data import optical_flow as jflow
from flickering_adversarial_video_tpu.data import video as jvideo
from flickering_adversarial_video_tpu_torch.data import optical_flow as tflow
from flickering_adversarial_video_tpu_torch.data import video as tvideo

# max |port - JAX| of the solver at 48x64, nscales 2, warps 2, iterations 5
# (measured 4.7e-6 px), and of the postprocessed flow of the default solver
# (5/5/30) on 48x64 frames (measured 5.1e-7 at 80x80, in flow units, px / 20)
TVL1_ATOL_PX = 1e-4
POSTPROCESSED_ATOL = 1e-5


def _smooth_image(rng, h, w, blur=4):
    """Blurred noise: textured enough for flow, smooth enough to linearize."""
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(blur, np.float32) / blur
    for _ in range(3):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    return _smooth_image(rng, 48, 64), _smooth_image(rng, 48, 64)


class TestHelpers:
    def test_stencils_exact(self, pair):
        a, b = pair
        for got, want in zip(tflow._forward_diff(_t(a)), jflow._forward_diff(a)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tflow._centered_grad(_t(a)), jflow._centered_grad(a)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tflow._divergence(_t(a), _t(b)).numpy(),
                                      np.asarray(jflow._divergence(a, b)))

    def test_divergence_single_row_and_column(self):
        p = np.arange(5, dtype=np.float32)
        for shape in ((1, 5), (5, 1)):
            x = p.reshape(shape)
            np.testing.assert_array_equal(tflow._divergence(_t(x), _t(x)).numpy(),
                                          np.asarray(jflow._divergence(x, x)))

    def test_stencils_batched(self, pair):
        """A leading batch of pairs gives each pair's own result."""
        stack = np.stack(pair)
        got = tflow._divergence(_t(stack), _t(stack[::-1].copy()))
        for i in range(2):
            np.testing.assert_array_equal(
                got[i].numpy(), np.asarray(jflow._divergence(stack[i], stack[1 - i])))

    def test_warp_exact(self, pair):
        a, _ = pair
        rng = np.random.default_rng(8)
        # displacements that leave the frame on every side (border clamp)
        u1 = rng.normal(0, 6, a.shape).astype(np.float32)
        u2 = rng.normal(0, 6, a.shape).astype(np.float32)
        want = np.asarray(jflow._warp(a, u1, u2))
        np.testing.assert_array_equal(tflow._warp(_t(a), _t(u1), _t(u2)).numpy(), want)
        got = tflow._warp(_t(np.stack([a, a])), _t(np.stack([u1, u1])), _t(np.stack([u2, u2])))
        np.testing.assert_array_equal(got[1].numpy(), want)

    @pytest.mark.parametrize("n_in,n_out", [(48, 24), (85, 42), (21, 42)])
    def test_weight_matrix_equals_jax(self, n_in, n_out):
        want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, _fill_triangle_kernel, True)
        np.testing.assert_array_equal(tflow._weight_mat(n_in, n_out), np.asarray(want))

    def test_resize_at_half_zoom_exact(self, pair):
        stack = np.stack(pair)
        want = jax.vmap(lambda x: jax.image.resize(x, (24, 32), "linear", antialias=True))(stack)
        np.testing.assert_array_equal(tflow._resize(_t(stack), (24, 32)).numpy(),
                                      np.asarray(want))

    @pytest.mark.parametrize("shape", [(23, 31), (17, 45), (96, 128), (48, 33)])
    def test_resize_other_sizes(self, pair, shape):
        a, _ = pair
        want = np.asarray(jax.image.resize(a, shape, "linear", antialias=True))
        got = tflow._resize(_t(a), shape).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(a).max()

    def test_pyramid_shapes(self):
        assert tflow._pyramid_shapes(256, 340, 5) == jflow._pyramid_shapes(256, 340, 5) == [
            (256, 340), (128, 170), (64, 85), (32, 42), (16, 21)]
        assert tflow._pyramid_shapes(40, 60, 5) == jflow._pyramid_shapes(40, 60, 5)

    def test_rgb_to_gray_exact(self):
        rgb = np.random.default_rng(9).uniform(0, 255, (3, 8, 10, 3)).astype(np.float32)
        np.testing.assert_array_equal(tflow.rgb_to_gray(_t(rgb)).numpy(),
                                      np.asarray(jflow.rgb_to_gray(rgb)))

    def test_postprocess_exact(self):
        flow = np.random.default_rng(10).normal(0, 15, (3, 12, 14, 2)).astype(np.float32)
        np.testing.assert_array_equal(tflow.postprocess_flow(_t(flow), crop_size=8).numpy(),
                                      np.asarray(jflow.postprocess_flow(flow, crop_size=8)))


class TestSolver:
    def test_tvl1_against_jax(self, pair):
        a, b = pair
        kw = dict(nscales=2, warps=2, iterations=5)
        want = np.asarray(jflow.tvl1_flow(a, b, **kw))
        got = tflow.tvl1_flow(_t(a), _t(b), **kw).numpy()
        assert got.shape == want.shape == (48, 64, 2)
        assert np.abs(got - want).max() <= TVL1_ATOL_PX

    @pytest.mark.parametrize("shift", [(2, 0), (0, 3), (2, 1)])
    def test_translation_recovery(self, rng, shift):
        dx, dy = shift
        big = _smooth_image(rng, 128, 128)
        # crop the SAME content at offset vs origin: i1's content moved +d
        i0 = big[16 : 16 + 80, 16 : 16 + 80]
        i1 = big[16 - dy : 16 - dy + 80, 16 - dx : 16 - dx + 80]
        flow = tflow.tvl1_flow(_t(i0), _t(i1), nscales=3, iterations=30).numpy()
        med = np.median(flow[12:-12, 12:-12].reshape(-1, 2), axis=0)
        assert abs(med[0] - dx) < 0.5, med
        assert abs(med[1] - dy) < 0.5, med

    def test_zero_flow_for_identical_frames(self, pair):
        a, _ = pair
        flow = tflow.tvl1_flow(_t(a), _t(a), nscales=2, iterations=10).numpy()
        assert np.abs(flow).max() < 0.1

    def test_flow_for_video_batched_equals_pair_by_pair(self):
        rng = np.random.default_rng(11)
        gray = _t(np.stack([_smooth_image(rng, 32, 40) for _ in range(4)]))
        kw = dict(nscales=2, warps=2, iterations=4)
        got = tflow.flow_for_video(gray, **kw)
        assert got.shape == (3, 32, 40, 2)
        for t in range(3):
            want = tflow.tvl1_flow(gray[t], gray[t + 1], **kw)
            np.testing.assert_array_equal(got[t].numpy(), want.numpy())


class TestVideoFlowBranch:
    def test_frames_to_flow_against_jax(self, rng):
        # 4 frames of 48x64 (the video test's geometry: one JAX compile),
        # the content moving +2 rows a frame
        big = _smooth_image(rng, 96, 96)
        gray = np.stack([big[16 - 2 * t : 64 - 2 * t, 16:80] for t in range(4)])
        got = tvideo.frames_to_flow(gray, crop_size=32, device="cpu")
        want = jvideo.frames_to_flow(gray, crop_size=32)
        assert got.shape == want.shape == (3, 32, 32, 2)
        assert np.abs(got - want).max() <= POSTPROCESSED_ATOL
        # +2 px -> 2/20 = 0.1 after the reference normalization
        assert np.abs(np.median(got[..., 1].reshape(3, -1), axis=1) - 0.1).max() < 0.03

    def test_frames_to_flow_needs_cuda_or_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvideo.frames_to_flow(np.zeros((2, 16, 16), np.float32), crop_size=8)

    def test_video_to_frames_flow_against_jax(self, rng, tmp_path):
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (64, 48))
        if not writer.isOpened():  # pragma: no cover
            pytest.skip("no MJPG writer in this cv2 build")
        base = _smooth_image(rng, 64, 96)
        for t in range(6):
            frame = base[:48, t : t + 64]
            writer.write(cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_GRAY2BGR))
        writer.release()
        # n_steps 4 < 6 frames: the gray frames are truncated with the clip
        kw = dict(resize_height=48, crop_size=32, n_steps=4, flow=True)
        clip, flow = tvideo.video_to_frames(path, device="cpu", **kw)
        jclip, jflow_ = jvideo.video_to_frames(path, **kw)
        np.testing.assert_array_equal(clip, jclip)
        assert clip.shape == (1, 4, 32, 32, 3)
        assert flow.shape == jflow_.shape == (1, 3, 32, 32, 2)
        assert np.abs(flow - jflow_).max() <= POSTPROCESSED_ATOL

"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes (the full-size comparison is chip_smoke.py's), and the
graphed train step against the eager one.  Skipped without a GPU.  This
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from flickering_adversarial_video_tpu_torch import ops
from flickering_adversarial_video_tpu_torch.attack import FlickerSpec
from flickering_adversarial_video_tpu_torch.convert import init_i3d_state
from flickering_adversarial_video_tpu_torch.engine import AttackConfig, AttackEngine, RuntimeFlags
from flickering_adversarial_video_tpu_torch.models.i3d import InceptionI3D
from flickering_adversarial_video_tpu_torch.ops import fused_apply, packed_apply
from flickering_adversarial_video_tpu_torch.ops import pool_s1, pool_strided, stem_combine, stem_conv


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_all_kernels_match_plain(self, dtype):
        gen = torch.Generator().manual_seed(0)

        def rand(*shape):
            return torch.randn(*shape, generator=gen).to("cuda", dtype)

        x = rand(2, 4, 5, 40, 24)  # odd H: a half-used row pair; W=40: a partial M tile
        pk, bn = rand(4, 4, 4, 24, 64) * 0.1, [t.cuda() for t in _bn_t(gen, 64)]
        got = stem_conv.stem_conv_bn_relu(x, pk, *bn)
        want = stem_conv.stem_conv_bn_relu_plain(x, pk, *bn)
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
               1e-2 if dtype == torch.bfloat16 else 1e-5)
        part = rand(2, 5, 3, 4, 3 * 16)
        np.testing.assert_array_equal(
            stem_combine.temporal_combine(part, 16, 1).float().cpu().numpy(),
            stem_combine.temporal_combine_plain(part, 16, 1).float().cpu().numpy(),
        )
        p = torch.randint(0, 3, (2, 4, 6, 6, 32), generator=gen).to("cuda", dtype)
        dy = rand(2, 4, 6, 6, 32)
        np.testing.assert_array_equal(
            pool_s1.pool333_fwd(p).cpu().float().numpy(),
            pool_s1.pool333_fwd_plain(p).cpu().float().numpy(),
        )
        np.testing.assert_array_equal(
            pool_s1.pool333_bwd(p, dy).float().cpu().numpy(),
            pool_s1.pool333_bwd_plain(p, dy).float().cpu().numpy(),
        )
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_fwd(p).cpu().float().numpy(),
            pool_strided.pool133_s2_fwd_plain(p).cpu().float().numpy(),
        )
        # B6 on a tie grid: 5 window rows of 7 windows
        q = torch.randint(0, 3, (2, 3, 10, 14, 40), generator=gen).to("cuda", dtype)
        dq = torch.randint(-8, 9, (2, 3, 5, 7, 40), generator=gen).to("cuda", dtype)
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_bwd(q, dq).float().cpu().numpy(),
            pool_strided.pool133_s2_bwd_plain(q, dq).float().cpu().numpy(),
        )

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (2, 3, 8, 112, 24),   # W' = 112: a ragged second 64-position tile
        (2, 3, 8, 56, 24),    # W' = 56: one tile, the second warpgroup idle
        (1, 2, 7, 100, 24),   # W' = 100 and odd H': a half-used row pair
        (2, 1, 6, 128, 24),   # W' = 128, the widest row; T' = 1
        (1, 45, 112, 112, 24),  # the single-video clip: B*T' odd
    ])
    def test_stem_b1_edges(self, dtype, shape):
        gen = torch.Generator().manual_seed(4)
        x = (torch.randint(0, 256, shape, generator=gen).float() / 128 - 1).to("cuda", dtype)
        pk = (torch.randn(4, 4, 4, 24, 64, generator=gen) * 0.05).to("cuda", dtype)
        bn = [t.cuda() for t in _bn_t(gen, 64)]
        got = stem_conv.stem_conv_bn_relu(x, pk, *bn)
        want = stem_conv.stem_conv_bn_relu_plain(x, pk, *bn)
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(),
               1e-2 if dtype == torch.bfloat16 else 1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (2, 3, 14, 14, 528),  # Mixed_4f's C: no multiple of 32 channels
        (1, 3, 5, 7, 40),     # partial tiles in every dimension
        (2, 1, 5, 7, 13),     # T = 1; C takes the scalar tail
        (1, 9, 7, 7, 24),     # the 7x7 tile of Mixed_5x
        (1, 20, 30, 29, 16),  # 28x28-like planes over 3x3 tiles, T split in runs
    ])
    def test_pool_s1_backward_b4_bit_equal(self, dtype, shape):
        """B4 is bit-equal to its plain version: random values, and an
        integer tie grid."""
        gen = torch.Generator().manual_seed(6)
        for x, dy in (
            (torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)),
            (torch.randint(0, 3, shape, generator=gen).float(),
             torch.randint(-8, 9, shape, generator=gen).float()),
        ):
            x, dy = x.to("cuda", dtype), dy.to("cuda", dtype)
            np.testing.assert_array_equal(
                pool_s1.pool333_bwd(x, dy).float().cpu().numpy(),
                pool_s1.pool333_bwd_plain(x, dy).float().cpu().numpy(),
            )

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (8, 32, 28, 28, 192), (8, 32, 28, 28, 256),  # Mixed_3b, 3c: 4 tiles of 14x14
        (8, 16, 14, 14, 480), (8, 16, 14, 14, 512),  # Mixed_4b, 4c (= 4d, 4e)
        (8, 16, 14, 14, 528), (8, 8, 7, 7, 832),     # Mixed_4f; 5b (= 5c): the 7x7 tile
        (1, 45, 28, 28, 192), (1, 23, 14, 14, 480),  # the single-video clip: runs of frames
        (1, 12, 7, 7, 832),
        (2, 1, 15, 29, 13),   # T = 1; across the 14-cell tile; the scalar tail
        (1, 2, 29, 15, 16),   # T = 2; H across two tile boundaries
        (3, 2, 1, 1, 8),      # one cell a plane
        (1, 1, 29, 1, 40),    # W = 1
    ])
    def test_pool_s1_forward_b3_bit_equal(self, dtype, shape):
        """B3 is bit-equal to its plain version: random values, an integer
        tie grid, and a tie grid with NaNs and a -inf block (NaN positions
        equal)."""
        gen = torch.Generator(device="cuda").manual_seed(8)
        b, t, h, w, c = shape
        nan = torch.randint(0, 3, shape, generator=gen, device="cuda").float()
        spots = torch.randint(0, nan.numel(), (max(1, nan.numel() // 64),), generator=gen,
                              device="cuda")
        nan.view(-1)[spots] = float("nan")
        nan[:, :, h // 2:, w // 2:] = float("-inf")
        for x in (torch.randn(shape, generator=gen, device="cuda"),
                  torch.randint(0, 3, shape, generator=gen, device="cuda").float(), nan):
            x = x.to(dtype)
            got, want = pool_s1.pool333_fwd(x), pool_s1.pool333_fwd_plain(x)
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got.masked_fill(want.isnan(), 0), want.masked_fill(want.isnan(), 0))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims,cin,taps", [
        ((8, 32, 56, 56), 64, 3),                                           # Conv3d_2c
        ((8, 32, 28, 28), 96, 3), ((8, 32, 28, 28), 16, 3),                 # Mixed_3b
        ((8, 32, 28, 28), 128, 3), ((8, 32, 28, 28), 32, 3),                # Mixed_3c
        ((8, 16, 14, 14), 96, 3), ((8, 16, 14, 14), 16, 3),                 # Mixed_4b
        ((8, 16, 14, 14), 112, 3), ((8, 16, 14, 14), 24, 3),                # Mixed_4c (24: 4d)
        ((8, 16, 14, 14), 128, 3), ((8, 16, 14, 14), 144, 3),               # Mixed_4d, 4e
        ((8, 16, 14, 14), 32, 3), ((8, 16, 14, 14), 160, 3),                # 4e/4f, 4f
        ((8, 8, 7, 7), 160, 3), ((8, 8, 7, 7), 32, 3),                      # Mixed_5b
        ((8, 8, 7, 7), 192, 3), ((8, 8, 7, 7), 48, 3),                      # Mixed_5c
        ((8, 32, 112, 112), 24, 4),                                         # the stem's dgrad
        ((1, 45, 56, 56), 64, 3), ((1, 45, 28, 28), 128, 3),                # the single-video
        ((1, 23, 14, 14), 112, 3), ((1, 12, 7, 7), 160, 3),                 # clip
        ((1, 45, 112, 112), 24, 4),
        ((2, 2, 3, 5), 13, 3), ((1, 1, 4, 4), 24, 4),                       # tail; T < KT
    ])
    def test_temporal_combine_b2_bit_equal(self, dtype, dims, cin, taps):
        gen = torch.Generator(device="cuda").manual_seed(9)
        part = torch.randn(*dims, taps * cin, generator=gen, device="cuda").to(dtype)
        for t_plo in range(taps):
            assert torch.equal(stem_combine.temporal_combine(part, cin, t_plo),
                               stem_combine.temporal_combine_plain(part, cin, t_plo))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (1, 3, 2, 2, 8),      # one window: the pads in both axes
        (2, 3, 6, 10, 40),    # 3 window rows, 5 columns
        (2, 1, 4, 6, 13),     # C takes the scalar tail
        (1, 4, 28, 28, 480),  # 4a's plane: two channel groups of 30 vectors (bf16)
        (1, 3, 40, 112, 64),  # 2a's width; runs of window rows at B*T = 3
    ])
    def test_pool_s2_backward_b6_bit_equal(self, dtype, shape):
        """B6 is bit-equal to its plain version: random values, an integer
        tie grid, and a tie grid with NaNs and a -inf block."""
        gen = torch.Generator().manual_seed(7)
        b, t, h, w, c = shape
        pooled = (b, t, h // 2, w // 2, c)
        nan = torch.randint(0, 3, shape, generator=gen).float()
        spots = torch.randint(0, nan.numel(), (max(1, nan.numel() // 64),), generator=gen)
        nan.view(-1)[spots] = float("nan")
        nan[:, :, h // 2:, w // 2:] = float("-inf")
        for x, dy in (
            (torch.randn(shape, generator=gen), torch.randn(pooled, generator=gen)),
            (torch.randint(0, 3, shape, generator=gen).float(),
             torch.randint(-8, 9, pooled, generator=gen).float()),
            (nan, torch.randint(1, 9, pooled, generator=gen).float()),
        ):
            x, dy = x.to("cuda", dtype), dy.to("cuda", dtype)
            np.testing.assert_array_equal(
                pool_strided.pool133_s2_bwd(x, dy).float().cpu().numpy(),
                pool_strided.pool133_s2_bwd_plain(x, dy).float().cpu().numpy(),
            )

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (1, 3, 2, 2, 8),       # one window: the pads in both axes
        (2, 3, 6, 10, 40),     # 3 window rows, 5 columns
        (2, 1, 4, 6, 13),      # C takes the scalar tail
        (2, 3, 10, 2, 8),      # W' = 1
        (1, 1, 34, 8, 8),      # H' = 17 in runs of 5 window rows
        (1, 3, 8, 224, 40),    # C = 40 over 112 window columns: 2 (bf16) or 3 (f32) groups
        (1, 4, 28, 28, 480),   # 4a's plane: two channel groups of 30 vectors (bf16)
        (1, 2, 56, 56, 192),   # 3a's plane: two channel groups of 12 vectors (bf16)
        (1, 3, 40, 112, 64),   # 2a's width; runs of window rows at B*T = 3
    ])
    def test_pool_s2_forward_b5_b9_bit_equal(self, dtype, shape):
        """B5 and B9's forward are bit-equal to their plain versions (NaN
        where NaN) on random values, an integer tie grid and a tie grid with
        NaNs and a -inf block: B9's y equals B5's, its index the plain
        version's, and without an index it writes y alone."""
        gen = torch.Generator().manual_seed(8)
        b, t, h, w, c = shape
        nan = torch.randint(0, 3, shape, generator=gen).float()
        spots = torch.randint(0, nan.numel(), (max(1, nan.numel() // 64),), generator=gen)
        nan.view(-1)[spots] = float("nan")
        nan[:, :, h // 2:, w // 2:] = float("-inf")
        for x in (torch.randn(shape, generator=gen), torch.randint(0, 3, shape, generator=gen).float(),
                  nan):
            x = x.to(dtype)
            want_y, want_idx = pool_strided.pool133_s2_pair_fwd_plain(x)
            y5 = pool_strided.pool133_s2_fwd(x.cuda())
            y9, idx = pool_strided.pool133_s2_pair_fwd(x.cuda())
            y0, none = pool_strided.pool133_s2_pair_fwd(x.cuda(), want_idx=False)
            assert none is None
            np.testing.assert_array_equal(
                pool_strided.pool133_s2_fwd_plain(x).float().numpy(), want_y.float().numpy())
            for y in (y5, y9, y0):
                np.testing.assert_array_equal(y.float().cpu().numpy(), want_y.float().numpy())
            np.testing.assert_array_equal(idx.cpu().numpy(), want_idx.numpy())

    def test_pool_s2_forward_width_limit(self):
        """The strip kernels take a width up to 1024 and raise above it."""
        x = torch.zeros(1, 1, 2, 1026, 8, device="cuda")
        with pytest.raises(ValueError, match="width up to 1024"):
            pool_strided.pool133_s2_fwd(x)
        with pytest.raises(ValueError, match="width up to 1024"):
            pool_strided.pool133_s2_pair_fwd(x)
        y = pool_strided.pool133_s2_fwd(x[:, :, :, :1024].contiguous())
        assert y.shape == (1, 1, 1, 512, 8) and torch.equal(y, torch.zeros_like(y))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_nan_rule(self, dtype):
        """A NaN and a -inf block: each kernel equals its plain version, NaN
        positions, values and routed gradients (B4 and B6 route by equality
        with the pooled value and by select-and-scatter, as the plain ones)."""
        gen = torch.Generator().manual_seed(5)
        x = torch.randint(0, 3, (1, 2, 4, 4, 2), generator=gen).float()
        x[0, 0, 0, 1, 0] = float("nan")
        x[0, :, 2:, 2:, :] = float("-inf")
        x = x.to("cuda", dtype)
        dy = torch.randint(1, 9, x.shape, generator=gen).to("cuda", dtype)
        dy5 = torch.randint(1, 9, (1, 2, 2, 2, 2), generator=gen).to("cuda", dtype)
        for got, want in (
            (pool_s1.pool333_fwd(x), pool_s1.pool333_fwd_plain(x)),
            (pool_s1.pool333_bwd(x, dy), pool_s1.pool333_bwd_plain(x, dy)),
            (pool_strided.pool133_s2_fwd(x), pool_strided.pool133_s2_fwd_plain(x)),
            (pool_strided.pool133_s2_bwd(x, dy5), pool_strided.pool133_s2_bwd_plain(x, dy5)),
        ):
            np.testing.assert_array_equal(got.float().cpu().numpy(), want.float().cpu().numpy())
        xs = (torch.randint(-3, 4, (1, 2, 4, 4, 24), generator=gen).float() / 4).to("cuda", dtype)
        xs[0, 0, 0, 0, 5] = float("nan")
        xs[0, :, 3, 3, :] = float("-inf")
        pk = (torch.randn(4, 4, 4, 24, 64, generator=gen) * 0.05).to("cuda", dtype)
        bn = [t.cuda() for t in _bn_t(gen, 64)]
        got = stem_conv.stem_conv_bn_relu(xs, pk, *bn).float().cpu().numpy()
        want = stem_conv.stem_conv_bn_relu_plain(xs, pk, *bn).float().cpu().numpy()
        assert np.isnan(want).any() and np.isfinite(want).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = np.isfinite(want)
        _close(got[keep], want[keep], 1e-2 if dtype == torch.bfloat16 else 1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(2, 3, 10, 14, 40), (1, 5, 4, 6, 3)])  # odd B*T, H != W
    def test_pool_pair_b9(self, dtype, shape):
        gen = torch.Generator().manual_seed(3)
        b, t, h, w, c = shape
        for x in (torch.randint(0, 3, shape, generator=gen).to(dtype),   # a tie grid
                  torch.randn(shape, generator=gen).to(dtype)):
            y, idx = pool_strided.pool133_s2_pair_fwd(x.cuda())
            wy, widx = pool_strided.pool133_s2_pair_fwd_plain(x)
            assert torch.equal(y.cpu(), wy) and torch.equal(idx.cpu(), widx)
            assert torch.equal(y, pool_strided.pool133_s2_fwd(x.cuda()))
            y2, none = pool_strided.pool133_s2_pair_fwd(x.cuda(), want_idx=False)
            assert none is None and torch.equal(y2, y)
            dy = torch.randn(b, t, h // 2, w // 2, c, generator=gen).to(dtype)
            dx = pool_strided.pool133_s2_pair_bwd(idx, dy.cuda())
            assert torch.equal(dx.cpu(), pool_strided.pool133_s2_pair_bwd_plain(widx, dy))
            dyi = torch.randint(-8, 9, dy.shape, generator=gen).to(dtype)
            assert torch.equal(pool_strided.pool133_s2_pair_bwd(idx, dyi.cuda()),
                               pool_strided.pool133_s2_bwd(x.cuda(), dyi.cuda()))
            xg = x.cuda().requires_grad_(True)
            pool_strided.max_pool_133_s2_pair(xg).backward(dy.cuda())
            assert torch.equal(xg.grad, dx)
        nan = torch.zeros(1, 1, 4, 4, 1, dtype=dtype)
        nan[0, 0, 0, 1, 0] = float("nan")
        nan[0, 0, 2:, 2:, 0] = float("-inf")
        y, idx = pool_strided.pool133_s2_pair_fwd(nan.cuda())
        wy, widx = pool_strided.pool133_s2_pair_fwd_plain(nan)
        assert torch.equal(idx.cpu(), widx) and torch.equal(y.cpu().isnan(), wy.isnan())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [
        (8, 32, 112, 112, 64),  # MaxPool3d_2a of a B=8, T=64 step
        (8, 32, 56, 56, 192),   # MaxPool3d_3a
        (1, 45, 112, 112, 64),  # the single-video clip's 2a and 3a
        (1, 45, 56, 56, 192),
        (1, 3, 2, 2, 8),        # one window: the pads in both axes
        (2, 3, 6, 10, 40),      # 3 window rows, 5 columns
        (2, 1, 4, 6, 13),       # C takes the scalar tail
        (2, 3, 10, 2, 8),       # W' = 1
        (1, 1, 34, 8, 8),       # H' = 17 in runs of window rows
        (1, 3, 8, 224, 40),     # C = 40 over 112 window columns: groups of channel vectors
    ])
    def test_pool_pair_backward_b9_bit_equal(self, dtype, shape):
        """B9's backward is bit-equal to its plain version on the index of
        B9's forward (random values, an integer tie grid, a tie grid with
        NaNs and a -inf block; NaN where NaN), and to B6 on the same (x, dy)
        where x holds no NaN (B6 routes a NaN window by select-and-scatter)."""
        gen = torch.Generator(device="cuda").manual_seed(9)
        b, t, h, w, c = shape
        pooled = (b, t, h // 2, w // 2, c)
        nan = torch.randint(0, 3, shape, generator=gen, device="cuda").float()
        spots = torch.randint(0, nan.numel(), (max(1, nan.numel() // 64),), generator=gen,
                              device="cuda")
        nan.view(-1)[spots] = float("nan")
        nan[:, :, h // 2:, w // 2:] = float("-inf")
        for x, dy, has_nan in (
            (torch.randn(shape, generator=gen, device="cuda"),
             torch.randn(pooled, generator=gen, device="cuda"), False),
            (torch.randint(0, 3, shape, generator=gen, device="cuda").float(),
             torch.randint(-8, 9, pooled, generator=gen, device="cuda").float(), False),
            (nan, torch.randint(1, 9, pooled, generator=gen, device="cuda").float(), True),
        ):
            x, dy = x.to(dtype), dy.to(dtype)
            idx = pool_strided.pool133_s2_pair_fwd(x)[1]
            got = pool_strided.pool133_s2_pair_bwd(idx, dy)
            want = pool_strided.pool133_s2_pair_bwd_plain(idx, dy)
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got.nan_to_num(), want.nan_to_num())
            if not has_nan:
                assert torch.equal(got, pool_strided.pool133_s2_bwd(x, dy))
            del x, dy, idx, got, want

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(2, 4, 6, 8, 24), (1, 3, 5, 3, 24)])  # whole vectors / with a tail
    def test_emit_b7_bit_equal(self, dtype, shape):
        gen = torch.Generator().manual_seed(1)
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        u8[0, 0, 0, 0, 0] = 0
        dl = (torch.rand(shape[1], 24, generator=gen) - 0.5) * 0.6
        dl[:, 0] = 0.0
        for want_mask in (True, False):
            adv, mask = packed_apply.emit_adv_mask(u8.cuda(), dl.cuda(), -1.0, 1.0, dtype, want_mask)
            wadv, wmask = packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, dtype, want_mask)
            assert torch.equal(adv.cpu(), wadv)
            assert (mask is None and wmask is None) or torch.equal(mask.cpu(), wmask)
        # the engineered boundary hit landed: u8 0 under dl 0 is exactly lo
        assert (packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, dtype)[1] == 1).any()

    @pytest.mark.parametrize("shape", [(2, 4, 8, 16, 3), (1, 3, 5, 5, 3), (1, 2, 80, 80, 3)])
    def test_fused_apply_b8(self, shape):
        gen = torch.Generator().manual_seed(2)
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        u8[0, 1, 2, 3, 1] = 0
        delta = torch.randn(shape[1], 1, 1, 3, generator=gen) * 0.3
        delta[1] = 0.0  # frame 1: the black pixel sits exactly on -1
        g = torch.randn(shape, generator=gen)
        flag = torch.tensor(1.0)
        cu = [t.cuda() for t in (u8, delta, flag)]
        assert torch.equal(fused_apply.fused_apply_fwd(*cu).cpu(),
                           fused_apply.fused_apply_fwd_plain(u8, delta, flag))
        got = fused_apply.fused_apply_bwd(*cu, g.cuda())
        again = fused_apply.fused_apply_bwd(*cu, g.cuda())
        assert torch.equal(got, again)  # deterministic
        want = fused_apply.fused_apply_bwd_plain(u8, delta, flag, g)
        _close(got.cpu().numpy(), want.numpy(), 1e-5)
        ones = torch.ones_like(g)
        for strict in (True, False):  # each clip rule; on g = 1 the sums are exact
            assert torch.equal(
                fused_apply.fused_apply_bwd(*cu, ones.cuda(), strict=strict).cpu(),
                fused_apply.fused_apply_bwd_plain(u8, delta, flag, ones, strict=strict))
        big = torch.full_like(delta, 5.0).cuda()
        assert fused_apply.fused_apply_bwd(cu[0], big, cu[2], g.cuda()).abs().max().item() == 0.0
        d = delta.cuda().requires_grad_(True)
        fused_apply.fused_normalize_perturb(cu[0], d, cu[2]).backward(g.cuda())
        assert torch.equal(d.grad, got)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    # whole vectors in every clip / clips of 3*5*3*24 elements: one at a time
    @pytest.mark.parametrize("shape", [(3, 4, 6, 8, 24), (2, 3, 5, 3, 24)])
    def test_emit_b7_per_clip_bit_equal(self, dtype, shape):
        """B7's per-clip form (dl [B,T',CH]) against its plain version, with
        a bound hit in the second clip, and against the shared form where
        every clip has one dl."""
        gen = torch.Generator().manual_seed(2)
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        u8[1, 0, 0, 0, 0] = 0
        dl = (torch.rand(shape[0], shape[1], 24, generator=gen) - 0.5) * 0.6
        dl[1, :, 0] = 0.0
        for want_mask in (True, False):
            n = packed_apply.emit_adv_mask.clip_launches
            adv, mask = packed_apply.emit_adv_mask(u8.cuda(), dl.cuda(), -1.0, 1.0, dtype,
                                                   want_mask)
            assert packed_apply.emit_adv_mask.clip_launches == n + 1
            wadv, wmask = packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, dtype, want_mask)
            assert torch.equal(adv.cpu(), wadv)
            assert (mask is None and wmask is None) or torch.equal(mask.cpu(), wmask)
        assert (packed_apply.emit_adv_mask_plain(u8, dl, -1.0, 1.0, dtype)[1][1] == 1).any()
        shared = packed_apply.emit_adv_mask(u8.cuda(), dl[0].cuda(), -1.0, 1.0, dtype)
        clips = packed_apply.emit_adv_mask(u8.cuda(), dl[:1].expand_as(dl).cuda(), -1.0, 1.0,
                                           dtype)
        assert torch.equal(shared[0], clips[0]) and torch.equal(shared[1], clips[1])

    # whole vectors in every clip / clips of 3*5*7*3 elements: one at a time;
    # a row of 80*80*3 elements: two backward slices
    @pytest.mark.parametrize("shape", [(3, 8, 16, 16, 3), (2, 3, 5, 7, 3), (2, 2, 80, 80, 3)])
    def test_fused_apply_b8_per_clip(self, shape):
        """B8c (delta [B,T,1,1,C]): each clip's forward and d(delta) bit-equal
        to the shared-delta B8 launched on that clip alone; against the plain
        version (forward bit-equal, d(delta) to f32 sum order); its launches
        counted apart from B8's."""
        gen = torch.Generator().manual_seed(3)
        u8 = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
        u8[1, 1, 2, 3, 1] = 0
        delta = torch.randn(shape[0], shape[1], 1, 1, 3, generator=gen) * 0.3
        delta[1, 1] = 0.0  # clip 1, frame 1: the black pixel sits exactly on -1
        g = torch.randn(shape, generator=gen)
        flag = torch.tensor(0.7)
        cu = [t.cuda() for t in (u8, delta, flag)]
        fwd, bwd = fused_apply.fused_apply_fwd, fused_apply.fused_apply_bwd
        n = (fwd.launches, fwd.clip_launches, bwd.launches, bwd.clip_launches)
        out = fwd(*cu)
        dd = bwd(*cu, g.cuda())
        assert (fwd.launches, fwd.clip_launches, bwd.launches, bwd.clip_launches) == (
            n[0], n[1] + 1, n[2], n[3] + 1)
        assert dd.shape == delta.shape and torch.equal(dd, bwd(*cu, g.cuda()))
        for i in range(shape[0]):  # each clip on its own, 16-byte aligned
            one = (cu[0][i:i + 1].clone(), cu[1][i], cu[2])
            assert torch.equal(out[i:i + 1], fwd(*one))
            assert torch.equal(dd[i], bwd(*one, g[i:i + 1].cuda()))
        assert torch.equal(out.cpu(), fused_apply.fused_apply_fwd_plain(u8, delta, flag))
        _close(dd.cpu().numpy(), fused_apply.fused_apply_bwd_plain(u8, delta, flag, g).numpy(),
               1e-5)
        d = delta.cuda().requires_grad_(True)
        fused_apply.fused_normalize_perturb(cu[0], d, cu[2]).backward(g.cuda())
        assert torch.equal(d.grad, dd)


# the graphed train step at a small I3D: B=2, T=8, 32x32, 11 classes, bf16
G_CLASSES, G_FRAMES = 11, 8
G_STEPS = ("packed", "fused", "float")  # input head B7 + B1 / kernel B8 / a float clip


@pytest.mark.cuda
class TestSlotGraph:
    """The vectorized sweep's slot loop as a CUDA graph against the same
    iterations run eagerly, bit for bit: the state and every output."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("stop,fused", [("escalate", False), ("reference", False),
                                            ("escalate", True)])
    def test_graphed_chunk_equals_eager_chunk(self, stop, fused):
        """The packed head (B7c), or with USE_PALLAS_FUSED the fused kernel
        with a delta a clip (B8c)."""
        from flickering_adversarial_video_tpu_torch.engine.vector_sweep import VectorSweepEngine

        model = InceptionI3D(G_CLASSES, torch.bfloat16, device="cuda")
        model.load_state_dict(init_i3d_state(3, G_CLASSES))
        engine = AttackEngine(model, FlickerSpec(frames=G_FRAMES),
                              AttackConfig(use_pallas_fused=fused), track_probs=False)
        rng = np.random.default_rng(4)
        video = torch.from_numpy(rng.integers(0, 256, (3, G_FRAMES, 32, 32, 3),
                                              dtype=np.uint8)).cuda()
        videos, packed, labels = engine.prepare_batch(
            {"video": video, "labels": torch.tensor([1, 2, 3]).cuda()})
        assert packed is not fused
        seeds = torch.tensor([0, 1, 2], device="cuda")
        runs = []
        for eager in (False, True):
            vse = VectorSweepEngine(engine, 3, n_iter=2, stop=stop)
            state = vse.init_slots()
            for i, s in enumerate((0, 1)):
                vse.refill_slot(state, i, s, 0.2)
            vse.park_slot(state, 2)
            ops.reset_launch_counts()
            ys = []
            for _ in range(2):  # a refill between two chunks
                state, y = vse.run_chunk(state, videos, labels, seeds, RuntimeFlags(), 3,
                                         packed=packed, eager=eager)
                ys.append({k: v.clone() for k, v in y.items()})
                vse.refill_slot(state, 1, 5, 0.2)
            runs.append((tuple(t.clone() for t in state.tensors()), ys, ops.launch_counts()))
        (gs, gys, gn), (es, eys, en) = runs
        for a, b in zip(gs, es):
            assert torch.equal(a, b)
        for a, b in zip(gys, eys):
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), k
        assert gn == en
        b7c, b7 = gn["B7c emit_adv_mask, a delta a clip"], gn["B7 emit_adv_mask"]
        b8c = (gn["B8cf fused_apply_fwd, a delta a clip"], gn["B8cb fused_apply_bwd, a delta a clip"])
        assert (b7c, b7, b8c) == ((0, 0, (6, 6)) if fused else (6, 6, (0, 0)))
        assert gn["B8f fused_apply_fwd"] == gn["B8b fused_apply_bwd"] == 0


@pytest.mark.cuda
class TestGraphedStep:
    """The train step as a CUDA graph against the same step run eagerly
    (``_train_step``), bit for bit: delta, mu, nu and every metric."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _engine(path, pair=()):
        model = InceptionI3D(G_CLASSES, torch.bfloat16, device="cuda", pair_pools=pair)
        model.load_state_dict(init_i3d_state(3, G_CLASSES))
        cfg = AttackConfig(use_pallas_fused=path == "fused")
        return AttackEngine(model, FlickerSpec(frames=G_FRAMES), cfg)

    @staticmethod
    def _eager(engine, state, batch, flags=RuntimeFlags()):
        return engine._train_step(state, *engine.prepare_batch(batch), flags)

    @staticmethod
    def _batch(path, seed=0):
        rng = np.random.default_rng(seed)
        shape = (2, G_FRAMES, 32, 32, 3)
        video = (rng.uniform(-1, 1, shape).astype(np.float32) if path == "float"
                 else rng.integers(0, 256, shape, dtype=np.uint8))
        return {"video": torch.from_numpy(video).cuda(),
                "labels": torch.from_numpy(rng.integers(0, G_CLASSES, (2,))).cuda()}

    @staticmethod
    def _same_state(a, b):
        assert a.step == b.step
        for k in ("delta", "mu", "nu"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k

    @staticmethod
    def _same_metrics(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k].nan_to_num(), b[k].nan_to_num()) and torch.equal(
                    a[k].isnan(), b[k].isnan()), k
            else:
                assert a[k] == b[k], k

    @pytest.mark.parametrize("path", G_STEPS)
    def test_graphed_steps_equal_eager_steps(self, path):
        """train_steps(n=3) and three train_step calls, graphed, against three
        eager steps; the returned state holds the graph's static tensors."""
        engine = self._engine(path)
        batch = self._batch(path)
        chained = engine.train_steps(engine.init_state(), batch, RuntimeFlags(), 3)
        chained = type(chained)(*(t.clone() for t in (chained.delta, chained.mu, chained.nu)),
                                chained.step)
        gs, es = engine.init_state(), engine.init_state()
        for _ in range(3):
            gs, gm = engine.train_step(gs, batch)
            es, em = self._eager(engine, es, batch)
            self._same_state(gs, es)
            self._same_metrics(gm, em)
        self._same_state(chained, es)
        assert gs.delta is engine._graphs.delta  # donated: the static state
        assert float(es.delta.abs().max()) > 0
        assert len(engine.graph_stats()) == 1

    def test_changed_flags_take_effect(self):
        """A new learning rate, adv_flag or beta0 between replays reaches the
        graph (the eager steps see the same flags): equal to eager, and not
        equal to the steps with the first flags."""
        engine = self._engine("packed")
        batch = self._batch("packed")
        plan = (RuntimeFlags(), RuntimeFlags(learning_rate=1e-2),
                RuntimeFlags(adv_flag=0.0, beta0=0.3), RuntimeFlags())
        gs, es, fixed = engine.init_state(), engine.init_state(), engine.init_state()
        for flags in plan:
            gs, gm = engine.train_step(gs, batch, flags)
            es, em = self._eager(engine, es, batch, flags)
            self._same_state(gs, es)
            self._same_metrics(gm, em)
            fixed, _ = self._eager(engine, fixed, batch)
        assert not torch.equal(gs.delta, fixed.delta)

    @pytest.mark.parametrize("pair", [(), ("MaxPool3d_2a_3x3",)])
    def test_launch_counts_are_exact_after_replays(self, pair):
        """After a capture and k replays the counts are k times an eager
        step's, and a second batch shape (a short last batch) captures its
        own graph without moving the counts of the first."""
        engine = self._engine("packed", pair)
        batch = self._batch("packed")
        ops.reset_launch_counts()
        self._eager(engine, engine.init_state(), batch)
        one = ops.launch_counts()
        assert all(one[name] > 0 for name in ("B1 stem_conv_bn_relu", "B2 temporal_combine"))
        assert (one["B9b pool133_s2_pair_bwd"] > 0) == bool(pair)
        ops.reset_launch_counts()
        state = engine.init_state()
        for k in (1, 3, 2):
            state = engine.train_steps(state, batch, RuntimeFlags(), k)
        state, _ = engine.train_step(state, batch)
        assert ops.launch_counts() == {name: 7 * n for name, n in one.items()}
        short = {k: v[:1] for k, v in batch.items()}
        ops.reset_launch_counts()
        state = engine.train_steps(state, short, RuntimeFlags(), 2)
        graphed_short = ops.launch_counts()
        assert len(engine.graph_stats()) == 2 and state.step == 9
        ops.reset_launch_counts()
        eager_state = self._eager(engine, engine.init_state(), short)[0]
        self._eager(engine, eager_state, short)
        assert ops.launch_counts() == graphed_short


@pytest.mark.cuda
class TestPinnedPipeline:
    """The runners' input path on the card: the native reader fills each
    batch in pinned memory and ``engine.loops._to_device`` copies it with a
    non-blocking copy on the producer thread.  A pinned buffer refilled
    while a copy still reads it would hand the engine a wrong batch: over
    more than 20 batches, each on a stream kept busy so that the copies
    queue, every device batch equals the Python reader's host batch."""

    def test_device_batches_equal_the_host_batches(self, tmp_path):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        from flickering_adversarial_video_tpu_torch.data import (
            PrefetchIterator, TFRecordWriter, make_uint8_example, tfrecord_batches)
        from flickering_adversarial_video_tpu_torch.engine.loops import _to_device

        rng = np.random.default_rng(4)
        for s in range(2):
            with TFRecordWriter(str(tmp_path / f"s{s}.tfrecords")) as w:
                for i in range(21):
                    clip = rng.integers(0, 256, (8 + i % 3, 32, 32, 3), dtype=np.uint8)
                    w.write(make_uint8_example(clip, i))
        shards = sorted(str(p) for p in tmp_path.glob("*.tfrecords"))
        for prepack in (True, False):
            kw = dict(frames=8, height=32, width=32, prepack=prepack)
            want = list(tfrecord_batches(shards, 2, use_native=False, **kw))
            produce = (_to_device(b, torch.device("cuda"))
                       for b in tfrecord_batches(shards, 2, pin_memory=True, **kw))
            got = []
            for batch in PrefetchIterator(produce, depth=2):
                torch.cuda._sleep(2_000_000)  # the next copies queue behind this
                got.append(batch)
            torch.cuda.synchronize()
            assert len(got) == len(want) == 21
            key = "video_packed" if prepack else "video"
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[key].cpu().numpy(), w[key])
                np.testing.assert_array_equal(g["labels"].cpu().numpy(), w["labels"])


def _bn_t(gen, c):
    return (
        torch.randn(c, generator=gen),
        torch.rand(c, generator=gen) * 1.5 + 0.5,
        torch.randn(c, generator=gen),
    )


# every channel count of the four video ResNets' batch-norms
BN_CHANNELS = (45, 64, 128, 144, 230, 256, 288, 460, 512, 576, 921, 1152)
# (residual added, ReLU); a residual is added only before a ReLU
BN_EPILOGUES = ((False, True), (False, False), (True, True))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
class TestBNEpilogueOnCard:
    """B12 (``ops/bn_epilogue``) against its plain path on the card, bit for
    bit, forward and backward, each epilogue, on grids holding NaN, +-inf and
    -0; the plain backward against autograd through the plain forward; and
    the graphed r2plus1d_18 step, which runs B12, against the eager one."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _inputs(shape, dtype, seed=0, offset=0):
        """x, residual, g of `shape` (starting `offset` elements into their
        buffers: offset 1 leaves them unaligned), mean, mul, bias [C]."""
        from flickering_adversarial_video_tpu_torch.models.video_resnet import BN_EPS

        gen = torch.Generator().manual_seed(seed)
        c, n = shape[-1], int(np.prod(shape))

        def special(t):
            idx = torch.randperm(n, generator=gen)[:max(4, n // 50)]
            for k, v in enumerate((float("nan"), float("inf"), float("-inf"), -0.0)):
                t[idx[k::4]] = v
            return t

        def field():
            buf = special(torch.randn(n, generator=gen) * 3).to(dtype).cuda()
            return torch.cat([buf.new_zeros(offset), buf])[offset:].view(shape)

        x, res, g = field(), field(), field()
        x[..., 0].view(-1)[:5] = -0.0  # channel 0: mean 0, bias -0, so -0 reaches the ReLU
        weight = torch.rand(c, generator=gen) * 1.5 + 0.5
        weight[min(1, c - 1)] = 0.0
        bias, mean = torch.randn(c, generator=gen) * 0.1, torch.randn(c, generator=gen) * 0.1
        bias[0], mean[0] = -0.0, 0.0
        var = torch.rand(c, generator=gen) + 0.5
        weight, bias, mean, var = (t.cuda() for t in (weight, bias, mean, var))
        mul = torch.rsqrt(var + BN_EPS) * weight
        return x, res, g, mean, mul, bias

    def _check(self, x, res, g, mean, mul, bias):
        from flickering_adversarial_video_tpu_torch.ops import bn_epilogue as be

        for residual, relu in BN_EPILOGUES:
            r = res if residual else None
            before = (be.bn_epilogue_fwd.launches, be.bn_epilogue_bwd.launches)
            y = be.bn_epilogue_fwd(x, mean, mul, bias, r, relu)
            assert torch.equal(_bits(y), _bits(be.bn_epilogue_fwd_plain(x, mean, mul, bias, r,
                                                                         relu)))
            saved = y if relu else None
            dx, dres = be.bn_epilogue_bwd(g, mul, saved, residual)
            want_dx, want_dres = be.bn_epilogue_bwd_plain(g, mul, saved, residual)
            assert (be.bn_epilogue_fwd.launches, be.bn_epilogue_bwd.launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(_bits(dx), _bits(want_dx))
            assert (dres is None) == (not residual)
            if residual:
                assert torch.equal(_bits(dres), _bits(want_dres))
            # the plain backward is autograd's through the plain forward
            xa = x.detach().clone().requires_grad_(True)
            ra = res.detach().clone().requires_grad_(True) if residual else None
            be.bn_epilogue_fwd_plain(xa, mean, mul, bias, ra, relu).backward(g)
            assert torch.equal(_bits(xa.grad), _bits(want_dx))
            if residual:
                assert torch.equal(_bits(ra.grad), _bits(want_dres))
        torch.cuda.synchronize()

    @pytest.mark.parametrize("c", BN_CHANNELS)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_bit_equal_at_every_channel_count(self, dtype, c):
        """105 positions: for every C that is not a multiple of 8 the
        element count is not either, so the tail runs."""
        self._check(*self._inputs((1, 3, 5, 7, c), dtype, seed=c))

    @pytest.mark.parametrize("shape", [(2, 16, 56, 56, 45), (4, 16, 56, 56, 144),
                                       (1, 1, 1, 1, 921), (1, 1, 7), (3, 5, 45)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_bit_equal_at_step_shapes_tiny_and_unaligned(self, dtype, shape, offset):
        """Layer shapes of many vectors a thread (the unrolled loop), counts
        below one vector, and tensors one element off 16-byte alignment
        (the element-wise loads and stores)."""
        x, res, g, mean, mul, bias = self._inputs(shape, dtype, seed=len(shape), offset=offset)
        assert (x.data_ptr() % 16 == 0) == (offset == 0)
        self._check(x, res, g, mean, mul, bias)

    def test_launchers_refuse_a_residual_without_relu(self):
        """The launchers refuse what the wrappers refuse: a residual without
        ReLU forward, d residual without the saved y backward."""
        from flickering_adversarial_video_tpu_torch.ops import kernels

        x, res, g, mean, mul, bias = self._inputs((2, 3, 5, 45), torch.bfloat16)
        y = torch.empty_like(x)
        code, n, c = kernels.DTYPE_CODE[x.dtype], x.numel(), x.shape[-1]
        with pytest.raises(RuntimeError, match="fav_bn_epilogue_fwd"):
            kernels.launch("fav_bn_epilogue_fwd", x.data_ptr(), res.data_ptr(), mean.data_ptr(),
                           mul.data_ptr(), bias.data_ptr(), y.data_ptr(), n, c, 0, code,
                           kernels.stream())
        with pytest.raises(RuntimeError, match="fav_bn_epilogue_bwd"):
            kernels.launch("fav_bn_epilogue_bwd", g.data_ptr(), 0, mul.data_ptr(), y.data_ptr(),
                           res.data_ptr(), n, c, code, kernels.stream())
        torch.cuda.synchronize()

    def test_graphed_resnet_step_equals_eager_and_the_library_loads_first(self, monkeypatch):
        """Three graphed r2plus1d_18 steps against three eager ones, bit for
        bit; 37 epilogues each way a step; the kernel library is loaded by
        the capture's eager warm-up, never inside a capture."""
        from flickering_adversarial_video_tpu_torch.attack import TorchStyleFlickerSpec
        from flickering_adversarial_video_tpu_torch.convert import video_resnet_state_dict
        from flickering_adversarial_video_tpu_torch.models.video_resnet import VideoResNet
        from flickering_adversarial_video_tpu_torch.ops import kernels

        real, loads = kernels.library, []
        real.cache_clear()

        def spy():
            if not real.cache_info().currsize:
                loads.append(torch.cuda.is_current_stream_capturing())
            return real()

        monkeypatch.setattr(kernels, "library", spy)
        model = VideoResNet("r2plus1d_18", G_CLASSES, torch.bfloat16, device="cuda")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               video_resnet_state_dict("r2plus1d_18", G_CLASSES, 3).items()})
        engine = AttackEngine(model, TorchStyleFlickerSpec(G_FRAMES),
                              AttackConfig(norm_world="meanstd", reg_weighting="torch"),
                              track_probs=True)
        rng = np.random.default_rng(5)
        batch = {"video": torch.from_numpy(rng.integers(0, 256, (2, G_FRAMES, 32, 32, 3),
                                                        dtype=np.uint8)).cuda(),
                 "labels": torch.from_numpy(rng.integers(0, G_CLASSES, (2,))).cuda()}
        ops.reset_launch_counts()
        gs, es = engine.init_state(), engine.init_state()
        for _ in range(3):
            gs, gm = engine.train_step(gs, batch)
            es, em = TestGraphedStep._eager(engine, es, batch)
            TestGraphedStep._same_state(gs, es)
            TestGraphedStep._same_metrics(gm, em)
        assert float(es.delta.abs().max()) > 0 and len(engine.graph_stats()) == 1
        assert loads == [False]
        counts = ops.launch_counts()
        assert counts["B12f bn_epilogue_fwd"] == counts["B12b bn_epilogue_bwd"] == 6 * 37

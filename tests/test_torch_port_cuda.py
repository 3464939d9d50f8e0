"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes (the full-size comparison is chip_smoke.py's).  Skipped
without a GPU.  This file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

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
        _close(pool_s1.pool333_bwd(p, dy).float().cpu().numpy(),
               pool_s1.pool333_bwd_plain(p, dy).float().cpu().numpy(), 1e-2)
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_fwd(p).cpu().float().numpy(),
            pool_strided.pool133_s2_fwd_plain(p).cpu().float().numpy(),
        )
        # B6 on a tie grid whose H, W are not multiples of its 8x8 tile
        q = torch.randint(0, 3, (2, 3, 10, 14, 40), generator=gen).to("cuda", dtype)
        dq = torch.randint(-8, 9, (2, 3, 5, 7, 40), generator=gen).to("cuda", dtype)
        np.testing.assert_array_equal(
            pool_strided.pool133_s2_bwd(q, dq).float().cpu().numpy(),
            pool_strided.pool133_s2_bwd_plain(q, dq).float().cpu().numpy(),
        )


def _bn_t(gen, c):
    return (
        torch.randn(c, generator=gen),
        torch.rand(c, generator=gen) * 1.5 + 0.5,
        torch.randn(c, generator=gen),
    )

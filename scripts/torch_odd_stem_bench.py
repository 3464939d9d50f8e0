"""Time the unpacked I3D stem of an odd geometry on the card.

    python3 scripts/torch_odd_stem_bench.py

At an odd T, H or W the port's I3D runs the 7x7x7 stride-2 SAME stem as one
cuDNN conv with frozen BN and relu (``ops/conv_unit.conv_bn_relu(stride=)``,
the JAX package's ``Unit3D`` stem), with autograd's input gradient.  This
script times that forward and input gradient at the odd cell of
``chip_smoke.py`` (B=8 uint8 clips of 63x220x220, bf16), against the same
conv on an NCDHW input and on inputs whose 3 channels are zero-padded to 4,
8 and 16 (the kernel too; the outputs must not change), and prints which
cuDNN kernels the current route runs (torch.profiler).  Needs one CUDA card;
builds no kernel of the port.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flickering_adversarial_video_tpu_torch.ops import conv_unit  # noqa: E402

B, T, SIZE = 8, 63, 220


def cuda_ms(fn, iters=5, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(B, T, SIZE, SIZE, 3, generator=gen, device=dev).mul(2).sub(1).bfloat16()
    w = torch.randn(64, 3, 7, 7, 7, generator=gen, device=dev) * 0.03
    mean, var, bias = (torch.zeros(64, device=dev), torch.ones(64, device=dev),
                       torch.zeros(64, device=dev))
    out = [(s + 1) // 2 for s in (T, SIZE, SIZE)]
    g = torch.randn(B, *out, 64, generator=gen, device=dev).bfloat16()

    def stem(cpad: int = 3):
        """The stem's forward and input gradient, C_in zero-padded to cpad."""
        wp = F.pad(w, (0, 0, 0, 0, 0, 0, 0, cpad - 3))

        def run():
            xx = x.detach().requires_grad_(True)
            y = conv_unit.conv_bn_relu(F.pad(xx, (0, cpad - 3)), wp, mean, var, bias,
                                       stride=(2, 2, 2))
            y.backward(g)
            return y, xx.grad
        return run

    xc = x.permute(0, 4, 1, 2, 3).contiguous()

    def ncdhw():
        xx = xc.detach().requires_grad_(True)
        # SAME pads: (3,3) on the odd T, (2,3) on the even H and W
        y = F.conv3d(F.pad(xx, (2, 3, 2, 3, 3, 3)), w.bfloat16(), stride=2)
        y.backward(g.permute(0, 4, 1, 2, 3))

    def forward_only(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    y0, dx0 = stem()()
    for cpad in (4, 8, 16):
        y1, dx1 = stem(cpad)()
        print(f"[odd stem] C_in padded to {cpad}: output bit-equal {torch.equal(y0, y1)}, input "
              f"gradient bit-equal {torch.equal(dx0, dx1)}", flush=True)
    print(f"[odd stem] x {list(x.shape)} bf16 -> {list(y0.shape)}", flush=True)
    print(f"[odd stem] channels_last_3d (the port's route): forward and input gradient "
          f"{cuda_ms(stem()):.2f} ms; forward alone "
          f"{cuda_ms(forward_only(lambda: conv_unit.conv_bn_relu(x, w, mean, var, bias, stride=(2, 2, 2)))):.2f} ms",
          flush=True)
    print(f"[odd stem] NCDHW: forward and input gradient {cuda_ms(ncdhw):.2f} ms", flush=True)
    for cpad in (4, 8, 16):
        print(f"[odd stem] C_in padded to {cpad}: forward and input gradient "
              f"{cuda_ms(stem(cpad)):.2f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stem()()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6, max_name_column_width=90))


if __name__ == "__main__":
    main()

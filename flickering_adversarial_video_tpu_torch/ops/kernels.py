"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together, then one link) into a shared library with a
plain C interface under ``build/torch_kernels/<hash of the sources>/`` at the
root of the checkout, and loaded with ``ctypes``.  Nothing is built or loaded
when a module is imported: the CPU tests import every module.

Each op module keeps a wrapper per kernel that checks its tensors, allocates
the outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
through :func:`launch` (which raises if ``cudaGetLastError`` is not 0) and
adds one to its ``launches`` count.  On a CPU tensor the wrapper computes the
kernel's plain PyTorch version instead; on a CUDA tensor it launches or
raises, never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libfav_kernels.so"
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _D, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # x, k, mean, mul, bias, y, B, T, H, W, dtype, stream
    "fav_stem_conv_bn_relu": (_P,) * 6 + (_I,) * 4 + (_D, _P),
    # part, out, B, T, S, cin, n_taps, t_plo, dtype, stream
    "fav_temporal_combine": (_P,) * 2 + (_I,) * 6 + (_D, _P),
    # x, y, B, T, H, W, C, dtype, stream
    "fav_pool_s1_fwd": (_P,) * 2 + (_I,) * 5 + (_D, _P),
    # x, dy, dx, B, T, H, W, C, dtype, stream
    "fav_pool_s1_bwd": (_P,) * 3 + (_I,) * 5 + (_D, _P),
    # x, y, N, H, W, C, dtype, stream
    "fav_pool_s2_fwd": (_P,) * 2 + (_I,) * 4 + (_D, _P),
    # x, dy, dx, N, H, W, C, dtype, stream
    "fav_pool_s2_bwd": (_P,) * 3 + (_I,) * 4 + (_D, _P),
    # x, y, idx (or null), N, H, W, C, dtype, stream
    "fav_pool_pair_fwd": (_P,) * 3 + (_I,) * 4 + (_D, _P),
    # idx, dy, dx, N, Ho, Wo, C, dtype, stream
    "fav_pool_pair_bwd": (_P,) * 3 + (_I,) * 4 + (_D, _P),
    # u8, dl, adv, mask2 (or null), n, row_len, T, CH, clips (0: dl shared), lo, hi,
    # dtype, stream
    "fav_emit_adv_mask": (_P,) * 4 + (_I,) * 5 + (_F, _F, _D, _P),
    # u8, delta, flag, out, B, T, row_len, C, stream
    "fav_fused_apply_fwd": (_P,) * 4 + (_I,) * 4 + (_P,),
    # u8, delta, flag, g, partial, dd, B, T, row_len, C, slices, strict, stream
    "fav_fused_apply_bwd": (_P,) * 6 + (_I,) * 6 + (_P,),
    # B8c, delta [B,T,C]: as fav_fused_apply_fwd / _bwd (dd [B,T,C])
    "fav_fused_apply_clips_fwd": (_P,) * 4 + (_I,) * 4 + (_P,),
    "fav_fused_apply_clips_bwd": (_P,) * 6 + (_I,) * 6 + (_P,),
    # x, residual (or null; then relu is 1), mean, mul, bias, y, n, C, relu, dtype, stream
    "fav_bn_epilogue_fwd": (_P,) * 6 + (_I,) * 2 + (_D, _D, _P),
    # g, y (or null: no ReLU), mul, dx, dres (or null: no residual; else y too), n, C, dtype,
    # stream
    "fav_bn_epilogue_bwd": (_P,) * 5 + (_I,) * 2 + (_D, _P),
}
# the __global__ functions of csrc/ that each launcher starts, as a profiler
# names them; tests/test_torch_port_kernels.py holds this against csrc/
KERNEL_SYMBOLS = {
    "fav_stem_conv_bn_relu": ("stem_conv_bf16_kernel", "stem_conv_f32_kernel"),
    "fav_temporal_combine": ("temporal_combine_kernel",),
    "fav_pool_s1_fwd": ("pool_s1_fwd_kernel",),
    "fav_pool_s1_bwd": ("pool_s1_bwd_kernel",),
    "fav_pool_s2_fwd": ("pool_s2_fwd_kernel",),
    "fav_pool_s2_bwd": ("pool_s2_bwd_kernel",),
    "fav_pool_pair_fwd": ("pool_pair_fwd_kernel",),
    "fav_pool_pair_bwd": ("pool_pair_bwd_kernel",),
    "fav_emit_adv_mask": ("emit_adv_mask_kernel",),
    "fav_fused_apply_fwd": ("fused_apply_fwd_kernel",),
    "fav_fused_apply_bwd": ("fused_apply_bwd_partial_kernel", "fused_apply_bwd_final_kernel"),
    "fav_fused_apply_clips_fwd": ("fused_apply_clips_fwd_kernel",),
    "fav_fused_apply_clips_bwd": ("fused_apply_clips_bwd_partial_kernel",
                                  "fused_apply_clips_bwd_final_kernel"),
    "fav_bn_epilogue_fwd": ("bn_epilogue_fwd_kernel",),
    "fav_bn_epilogue_bwd": ("bn_epilogue_bwd_kernel",),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _run_all(cmds: Iterable[list[str]], log: Path) -> None:
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for cmd in cmds
    ]
    failed = []
    with open(log, "ab") as fh:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            fh.write(b"$ " + " ".join(cmd).encode() + b"\n" + out)
            if proc.returncode:
                failed.append((cmd, out.decode(errors="replace")))
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile csrc/ into the shared library (once per source hash)."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = out_dir / "nvcc.log"
    tag = f"{os.getpid()}"
    objs = []
    cmds = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)])
    _run_all(cmds, log)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    _run_all(
        [[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
          *map(str, objs), "-o", str(tmp)]],
        log,
    )
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return lib


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fav_error_string.argtypes = [ctypes.c_int]
    lib.fav_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call one exported launcher on the current stream's arguments; raise
    if the launch was refused."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}: {lib.fav_error_string(code).decode()}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(*tensors: torch.Tensor, dtype: torch.dtype | None = None) -> int:
    """Validate kernel operands (same CUDA device, contiguous, one supported
    dtype unless `dtype` pins it); return the dtype code of the first."""
    dev = tensors[0].device
    want = tensors[0].dtype if dtype is None else dtype
    if want not in DTYPE_CODE:
        raise TypeError(f"kernel dtype {want} not supported (float32, bfloat16)")
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError("kernel operands must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.dtype != want:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected {want}")
    return DTYPE_CODE[want]

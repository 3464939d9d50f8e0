"""System / device introspection (the reference's common/gpu.py role:
torch_device, num_devices, system_info -- utils_cv/common/gpu.py:43-80).

The port's own copy of the JAX package's ``utils/system.py`` on torch: the
device count and name come from ``torch.cuda``, the process index and count
from ``torch.distributed`` when a group is up.
"""

from __future__ import annotations

import os
import platform
import sys
from typing import Dict

import torch


def num_devices() -> int:
    """The CUDA cards this process sees; 1 on a host without CUDA (the CPU),
    as JAX's ``local_device_count`` counts its CPU backend."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_kind() -> str:
    """The first card's name, or "cpu"."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def db_num_workers(non_windows: int = 16) -> int:
    """Host-pipeline worker count (common/gpu.py:57-67 semantics)."""
    if platform.system() == "Windows":
        return 0
    return min(non_windows, os.cpu_count() or 1)


def system_info() -> Dict[str, object]:
    cuda = torch.cuda.is_available()
    dist = torch.distributed.is_available() and torch.distributed.is_initialized()
    return {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "process_index": torch.distributed.get_rank() if dist else 0,
        "process_count": torch.distributed.get_world_size() if dist else 1,
        "cpu_count": os.cpu_count(),
    }


def print_system_info() -> None:
    for k, v in system_info().items():
        print(f"{k}: {v}")

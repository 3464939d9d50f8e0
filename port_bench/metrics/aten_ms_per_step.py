"""Device time a step (a slot iteration in a sweep) in kernels that are neither
cuDNN/cuBLAS nor the port's own: PyTorch's elementwise, reduction and copy
kernels."""


def read(rec):
    return rec["group_s"].get("aten", 0.0) * 1e3 / rec["steps"] if rec["steps"] else None

"""Device time a step (a slot iteration in a sweep) in cuDNN and cuBLAS
kernels."""


def read(rec):
    if not rec["steps"] or "library" not in rec["group_s"]:
        return None
    return rec["group_s"]["library"] * 1e3 / rec["steps"]

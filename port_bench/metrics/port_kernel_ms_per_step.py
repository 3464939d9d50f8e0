"""Device time a step (a slot iteration in a sweep) in the port's own CUDA
kernels; nothing in a cell that runs none."""


def read(rec):
    if not rec["port_bound_s"] or not rec["steps"]:
        return None
    return rec["group_s"].get("port", 0.0) * 1e3 / rec["steps"]

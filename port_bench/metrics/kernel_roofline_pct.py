"""The port's kernels' share of their roofline: the sum of their bounds (the
frozen work of ``work/kernels.py`` at the cell's shapes, each launch's least
time at 3.35 TB/s or the type's peak FLOP/s) over the sum of their device
times.  A tag with work and no traced time, or traced time and no work,
fails the run; a cell that runs
no port kernel reads nothing."""


def read(rec):
    bounds = rec["port_bound_s"]
    if not bounds:
        return None
    missing = sorted(tag for tag, s in bounds.items() if s > 0 and not rec["tag_s"].get(tag))
    if missing:
        raise RuntimeError(f"kernel tags with work and no traced time: {missing}")
    extra = sorted(set(rec["tag_s"]) - set(bounds))
    if extra:
        raise RuntimeError(f"kernel tags traced that the cell's work does not count: {extra}")
    return 100.0 * sum(bounds.values()) / sum(rec["tag_s"][t] for t in bounds)

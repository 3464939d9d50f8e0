"""``torch.cuda.max_memory_allocated`` over the whole run, before the
reference runs, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30

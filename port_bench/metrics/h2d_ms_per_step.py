"""Host-to-device copy time a train step in the trace: the batches' copies from
pinned memory.  Batched cells only."""


def read(rec):
    if rec["mix"] != "universal" or not rec["steps"]:
        return None
    return rec["h2d_s"] * 1e3 / rec["steps"]

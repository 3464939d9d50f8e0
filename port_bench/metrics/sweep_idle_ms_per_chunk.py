"""Device idle time a chunk of the vectorized sweep: the idle time from the
slot graph's instantiation to the window's end over the chunks replayed.  It
is the host's work a chunk: the chunk's read of its outputs, the history and
the results.  Sweep cells only."""


def read(rec):
    if rec["mix"] != "sweep" or not rec["chunks"]:
        return None
    return rec["idle_after_capture_s"] * 1e3 / rec["chunks"]

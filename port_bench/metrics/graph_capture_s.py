"""Host seconds of the warm-up and capture of the window's step graph
(``StepGraphs.stats()`` / the slot graph's ``capture_s``)."""


def read(rec):
    return rec.get("capture_s")

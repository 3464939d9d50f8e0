"""The share of the traced window in which no kernel or copy runs on the
card."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"]) if rec["window_s"] else None

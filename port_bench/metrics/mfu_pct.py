"""The model FLOPs of every clip-step completed in the traced window (the
benchmark's own count, ``work/<model>.py``: 2 FLOPs a multiply-add, each
conv's forward and input gradient) over the window's seconds times 989
TFLOP/s, the H100's dense bf16 peak."""


def read(rec):
    from ..work.kernels import PEAK_FLOPS

    if not rec["window_s"] or not rec["clip_steps"]:
        return None
    return 100.0 * rec["clip_steps"] * rec["clip_step_flops"] / (rec["window_s"] * PEAK_FLOPS["bf16"])

"""The share of the vectorized sweep's slot iterations that a live slot ran:
the program's own counts (``vector_sweep.sweep_counts``: live slot
iterations over iterations times slots), over every sweep call of the run,
set-up's one-chunk call and the traced call alike.  The rest are iterations
that a finished or parked slot replays (the chunk's tail).  Nothing where
the program keeps no such counts or ran no sweep."""


def read(rec):
    from flickering_adversarial_video_tpu_torch.engine import vector_sweep

    counts = getattr(vector_sweep, "sweep_counts", dict)()
    if rec["mix"] != "sweep" or not counts.get("slot_iterations"):
        return None
    return 100.0 * counts["live_slot_iterations"] / counts["slot_iterations"]

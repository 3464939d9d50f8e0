"""Ops of the port; the CUDA kernels' wrappers and their plain versions."""


def kernel_wrappers():
    """(name, wrapper) of every CUDA kernel that ports a Pallas kernel of the
    JAX package, in order B1..B9; each wrapper carries a `launches` count."""
    from .fused_apply import fused_apply_bwd, fused_apply_fwd
    from .packed_apply import emit_adv_mask
    from .pool_s1 import pool333_bwd, pool333_fwd
    from .pool_strided import (
        pool133_s2_bwd, pool133_s2_fwd, pool133_s2_pair_bwd, pool133_s2_pair_fwd)
    from .stem_combine import temporal_combine
    from .stem_conv import stem_conv_bn_relu

    return (
        ("B1 stem_conv_bn_relu", stem_conv_bn_relu),
        ("B2 temporal_combine", temporal_combine),
        ("B3 pool333_fwd", pool333_fwd),
        ("B4 pool333_bwd", pool333_bwd),
        ("B5 pool133_s2_fwd", pool133_s2_fwd),
        ("B6 pool133_s2_bwd", pool133_s2_bwd),
        ("B7 emit_adv_mask", emit_adv_mask),
        ("B8f fused_apply_fwd", fused_apply_fwd),
        ("B8b fused_apply_bwd", fused_apply_bwd),
        ("B9f pool133_s2_pair_fwd", pool133_s2_pair_fwd),
        ("B9b pool133_s2_pair_bwd", pool133_s2_pair_bwd),
    )


def launch_counters():
    """(name, wrapper, attribute) of every launch count: each wrapper's
    `launches`, then the launches with a delta a clip (the vectorized
    sweep's) of B7 and B8 (their `clip_launches`), then B12's, the video
    ResNets' batch-norm epilogue, which ports no Pallas kernel.  B7's
    `launches` counts B7c's too (one kernel); B8's counts only the shared
    delta's, since B8c has kernels of its own."""
    from .bn_epilogue import bn_epilogue_bwd, bn_epilogue_fwd

    wrappers = kernel_wrappers()
    by_name = dict(wrappers)
    return tuple((name, fn, "launches") for name, fn in wrappers) + (
        ("B7c emit_adv_mask, a delta a clip", by_name["B7 emit_adv_mask"], "clip_launches"),
        ("B8cf fused_apply_fwd, a delta a clip", by_name["B8f fused_apply_fwd"],
         "clip_launches"),
        ("B8cb fused_apply_bwd, a delta a clip", by_name["B8b fused_apply_bwd"],
         "clip_launches"),
        ("B12f bn_epilogue_fwd", bn_epilogue_fwd, "launches"),
        ("B12b bn_epilogue_bwd", bn_epilogue_bwd, "launches"),
    )


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in launch_counters()}


def set_launch_counts(counts: dict) -> None:
    for name, fn, attr in launch_counters():
        setattr(fn, attr, counts[name])


def add_launch_counts(counts: dict, k: int = 1) -> None:
    """k * counts (by name) added to the counts: a graph's k replays."""
    for name, fn, attr in launch_counters():
        setattr(fn, attr, getattr(fn, attr) + k * counts[name])


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(launch_counts(), 0))

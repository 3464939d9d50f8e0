"""Ops of the port; the CUDA kernels' wrappers and their plain versions."""


def kernel_wrappers():
    """(name, wrapper) of every CUDA kernel on the attack step, in order
    B1..B6; each wrapper carries a `launches` count."""
    from .pool_s1 import pool333_bwd, pool333_fwd
    from .pool_strided import pool133_s2_bwd, pool133_s2_fwd
    from .stem_combine import temporal_combine
    from .stem_conv import stem_conv_bn_relu

    return (
        ("B1 stem_conv_bn_relu", stem_conv_bn_relu),
        ("B2 temporal_combine", temporal_combine),
        ("B3 pool333_fwd", pool333_fwd),
        ("B4 pool333_bwd", pool333_bwd),
        ("B5 pool133_s2_fwd", pool133_s2_fwd),
        ("B6 pool133_s2_bwd", pool133_s2_bwd),
    )


def reset_launch_counts() -> None:
    for _, fn in kernel_wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers()}

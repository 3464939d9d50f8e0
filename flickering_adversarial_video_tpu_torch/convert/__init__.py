from .flax_i3d import (
    attack_state_from_jax,
    attack_state_to_jax,
    from_flax_variables,
    init_i3d_state,
)

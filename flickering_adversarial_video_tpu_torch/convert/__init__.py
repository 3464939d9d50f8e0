from .flax_i3d import from_flax_variables, init_i3d_state

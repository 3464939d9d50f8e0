from .cli import load_weights, save_weights
from .fake_assets import i3d_var_map
from .flax_i3d import (
    attack_state_from_jax,
    attack_state_to_jax,
    from_flax_variables,
    init_i3d_state,
)
from .tf_bundle import BundleReader, read_bundle
from .tf_i3d import EVAL_TYPES, convert_i3d_checkpoint, convert_i3d_var_map

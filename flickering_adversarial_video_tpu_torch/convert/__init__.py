from .cli import load_variables, load_weights, save_variables, save_weights
from .fake_assets import i3d_var_map, video_resnet_state_dict, write_torchvision_pth
from .flax_i3d import (
    attack_state_from_jax,
    attack_state_to_jax,
    from_flax_variables,
    init_i3d_state,
    to_flax_variables,
)
from .tf_bundle import BundleReader, read_bundle
from .tf_i3d import EVAL_TYPES, convert_i3d_checkpoint, convert_i3d_var_map
from .torch_video_resnet import convert_video_resnet_state_dict

from .losses import adversarial_loss, ce_attack_loss, improved_hinge_loss, label_and_max_other
from .metrics import fooling_counts, is_adversarial, relative_percent, roughness, thickness
from .perturbation import (
    FlickerSpec,
    SparseSpec,
    TorchStyleFlickerSpec,
    apply_perturbation,
    apply_perturbation_torch_style,
    clip,
    clip_delta,
    frame_mask,
    init_delta,
    roll_shifts,
    roll_time,
)
from .regularizers import (
    first_order_diff_reg,
    flicker_regularizer,
    flicker_regularizer_torch,
    l12_regularizer,
    second_order_diff_reg,
    thinness_reg,
)

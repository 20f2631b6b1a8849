from bdbnn_tpu_torch.losses import kd, kurtosis
from bdbnn_tpu_torch.losses.kd import (
    distribution_loss,
    layer_weight_kl,
    layer_weight_kl_softened,
    loss_kd,
    match_conv_pairs,
    softmax_cross_entropy,
)

# the bare kurtosis() function is not re-exported (as in the reference):
# it would shadow the `bdbnn_tpu_torch.losses.kurtosis` submodule
from bdbnn_tpu_torch.losses.kurtosis import (
    DIFFKURT_TARGETS_CIFAR,
    DIFFKURT_TARGETS_IMAGENET,
    DIFFKURT_TARGETS_TS,
    kurtosis_loss,
    kurtosis_regularization,
    l2_regularization,
    resolve_targets,
    weight_to_pm1_regularization,
)

__all__ = [
    "DIFFKURT_TARGETS_CIFAR",
    "DIFFKURT_TARGETS_IMAGENET",
    "DIFFKURT_TARGETS_TS",
    "distribution_loss",
    "kd",
    "kurtosis",
    "kurtosis_loss",
    "kurtosis_regularization",
    "l2_regularization",
    "layer_weight_kl",
    "layer_weight_kl_softened",
    "loss_kd",
    "match_conv_pairs",
    "resolve_targets",
    "softmax_cross_entropy",
    "weight_to_pm1_regularization",
]

from bdbnn_tpu_torch.models import cifar10, imagenet, registry, resnet
from bdbnn_tpu_torch.models.registry import create_model, list_models
from bdbnn_tpu_torch.models.resnet import (
    BN_EPS,
    BiBasicBlock,
    BiResNet,
    VGGSmallBinary,
    bn_identity_stats,
    conv_weight_paths,
    fold_batch_norm,
    get_by_path,
    module_path_str,
)

__all__ = [
    "cifar10",
    "imagenet",
    "registry",
    "resnet",
    "create_model",
    "list_models",
    "BN_EPS",
    "BiBasicBlock",
    "BiResNet",
    "VGGSmallBinary",
    "bn_identity_stats",
    "conv_weight_paths",
    "fold_batch_norm",
    "get_by_path",
    "module_path_str",
]

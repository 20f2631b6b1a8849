from bdbnn_tpu_torch.models import cifar10, imagenet, registry, resnet, torch_import
from bdbnn_tpu_torch.models.registry import create_model, list_models
from bdbnn_tpu_torch.models.torch_import import (
    convert_torch_state_dict,
    load_state_dict_strict,
    load_torch_checkpoint,
    overlay_state_dict,
)
from bdbnn_tpu_torch.models.resnet import (
    BN_EPS,
    BiBasicBlock,
    BiResNet,
    FloatBottleneck,
    VGGSmallBinary,
    bn_identity_stats,
    conv_weight_hwio,
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
    "torch_import",
    "convert_torch_state_dict",
    "create_model",
    "list_models",
    "BN_EPS",
    "BiBasicBlock",
    "BiResNet",
    "FloatBottleneck",
    "VGGSmallBinary",
    "bn_identity_stats",
    "conv_weight_hwio",
    "conv_weight_paths",
    "fold_batch_norm",
    "get_by_path",
    "load_state_dict_strict",
    "load_torch_checkpoint",
    "module_path_str",
    "overlay_state_dict",
]

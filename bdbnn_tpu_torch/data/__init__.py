from bdbnn_tpu_torch.data.datasets import (
    CIFAR_MEAN,
    CIFAR_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    ArrayDataset,
    load_cifar10,
    load_cifar100,
    synthetic_dataset,
)
from bdbnn_tpu_torch.data.pipeline import Pipeline, cifar_eval_transform, normalize

__all__ = [
    "CIFAR_MEAN",
    "CIFAR_STD",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ArrayDataset",
    "Pipeline",
    "cifar_eval_transform",
    "load_cifar10",
    "load_cifar100",
    "normalize",
    "synthetic_dataset",
]

"""Model registry — constructor-by-name, counterpart of
``bdbnn_tpu/models/registry.py`` with the same arch names.

Every factory accepts ``dtype`` (``float32`` or ``bfloat16``: the compute
dtype, parameters stay f32), ``twoblock``, ``remat`` (the ResNets' blocks
recomputed in the backward; ``vgg_small`` refuses it with the reference's
``ValueError``), ``packed`` (binary convs hold packed ``{sign, alpha}``
buffers instead of ``float_weight``) and ``generator`` (a seeded
``torch.Generator`` for the initial weights).
``resnet50_float`` / ``resnet101_float`` are the bottleneck float teachers.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

from bdbnn_tpu_torch.models.resnet import BiResNet, VGGSmallBinary


def _cifar_classes(dataset: str) -> int:
    return {"cifar10": 10, "cifar100": 100}[dataset]


def _make_cifar(name, stage_sizes, width, variant, act, num_classes,
                dtype=None, twoblock=False, remat=False, packed=False, generator=None):
    return BiResNet(
        stage_sizes, num_classes, width=width, stem="cifar", variant=variant,
        act=act, twoblock=twoblock, dtype=dtype, remat=remat, packed=packed,
        generator=generator,
    )


def _make_imagenet(name, stage_sizes, variant, act, num_classes=1000,
                   pretrained=False, dtype=None, twoblock=False, remat=False,
                   block="basic", packed=False, generator=None):
    del pretrained  # reference-API parity; weights come through the bridge
    return BiResNet(
        stage_sizes, num_classes, width=64, stem="imagenet", variant=variant,
        act=act, twoblock=twoblock, block=block, dtype=dtype, remat=remat,
        packed=packed, generator=generator,
    )


def _make_vgg(num_classes, variant="cifar", dtype=None, twoblock=False,
              remat=False, packed=False, generator=None, image_size=32):
    if twoblock:
        raise ValueError(
            "--twoblock mixes ResNet block types; vgg_small has no blocks"
        )
    if remat:
        raise ValueError(
            "--remat rematerializes ResNet residual blocks; vgg_small "
            "has none (its activations are small — remat buys nothing)"
        )
    return VGGSmallBinary(
        num_classes, variant=variant, image_size=image_size, dtype=dtype,
        packed=packed, generator=generator,
    )


def cifar_model_factories(num_classes: int = 10) -> Dict[str, Callable]:
    f = functools.partial
    return {
        "resnet18": f(_make_cifar, "resnet18", (2, 2, 2, 2), 64, "cifar", "hardtanh", num_classes),
        "resnet20": f(_make_cifar, "resnet20", (3, 3, 3), 16, "cifar", "hardtanh", num_classes),
        "resnet8_tiny": f(_make_cifar, "resnet8_tiny", (1, 1), 8, "cifar", "hardtanh", num_classes),
        "resnet34": f(_make_cifar, "resnet34", (3, 4, 6, 3), 64, "cifar", "hardtanh", num_classes),
        "resnet18_react": f(_make_cifar, "resnet18_react", (2, 2, 2, 2), 64, "react", "rprelu", num_classes),
        "resnet20_react": f(_make_cifar, "resnet20_react", (3, 3, 3), 16, "react", "rprelu", num_classes),
        "resnet18_float": f(_make_cifar, "resnet18_float", (2, 2, 2, 2), 64, "float", "identity", num_classes),
        "resnet20_float": f(_make_cifar, "resnet20_float", (3, 3, 3), 16, "float", "identity", num_classes),
        "resnet34_float": f(_make_cifar, "resnet34_float", (3, 4, 6, 3), 64, "float", "identity", num_classes),
        "vgg_small": f(_make_vgg, num_classes),
        "vgg_small_float": f(_make_vgg, num_classes, variant="float"),
    }


def imagenet_model_factories(num_classes: int = 1000) -> Dict[str, Callable]:
    f = functools.partial
    return {
        "resnet18": f(_make_imagenet, "resnet18", (2, 2, 2, 2), "react", "rprelu", num_classes),
        "resnet34": f(_make_imagenet, "resnet34", (3, 4, 6, 3), "react", "rprelu", num_classes),
        "resnet18_react": f(_make_imagenet, "resnet18_react", (2, 2, 2, 2), "react", "rprelu", num_classes),
        "resnet34_react": f(_make_imagenet, "resnet34_react", (3, 4, 6, 3), "react", "rprelu", num_classes),
        "resnet18_step2": f(_make_imagenet, "resnet18_step2", (2, 2, 2, 2), "step2", "hardtanh", num_classes),
        "resnet34_step2": f(_make_imagenet, "resnet34_step2", (3, 4, 6, 3), "step2", "hardtanh", num_classes),
        "resnet18_float": f(_make_imagenet, "resnet18_float", (2, 2, 2, 2), "float", "identity", num_classes),
        "resnet34_float": f(_make_imagenet, "resnet34_float", (3, 4, 6, 3), "float", "identity", num_classes),
        "resnet50_float": f(_make_imagenet, "resnet50_float", (3, 4, 6, 3), "float", "identity", num_classes, block="bottleneck"),
        "resnet101_float": f(_make_imagenet, "resnet101_float", (3, 4, 23, 3), "float", "identity", num_classes, block="bottleneck"),
    }


def create_model(arch: str, dataset: str = "cifar10", **kwargs):
    """Build a model by (arch, dataset) — the registry front door."""
    if dataset in ("cifar10", "cifar100"):
        factories = cifar_model_factories(_cifar_classes(dataset))
    elif dataset == "imagenet":
        factories = imagenet_model_factories(kwargs.pop("num_classes", 1000))
    else:
        raise ValueError(f"unknown dataset: {dataset!r}")
    if arch not in factories:
        raise ValueError(
            f"unknown arch {arch!r} for {dataset}; have {sorted(factories)}"
        )
    return factories[arch](**kwargs)


def list_models(dataset: str = "cifar10"):
    if dataset == "imagenet":
        return sorted(imagenet_model_factories())
    return sorted(cifar_model_factories())

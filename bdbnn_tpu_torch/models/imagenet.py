"""ImageNet model namespace — constructor-by-name over the registry
(counterpart of ``bdbnn_tpu/models/imagenet.py``)."""

from bdbnn_tpu_torch.models.registry import imagenet_model_factories

_factories = imagenet_model_factories(num_classes=1000)


def __getattr__(name: str):
    if name in _factories:
        return _factories[name]
    raise AttributeError(name)


def __dir__():
    return sorted(_factories)


globals().update(_factories)

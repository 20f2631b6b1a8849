"""Binarization primitives, the binarizer families and the layers.

The names below are imported on first use, as ``obs`` and ``serve`` do:
a process that only parses family specs (the recipe-search harness)
reads :mod:`bdbnn_tpu_torch.nn.families` without loading torch."""

from __future__ import annotations

import importlib

_BINARIZE = "bdbnn_tpu_torch.nn.binarize"
_FAMILIES = "bdbnn_tpu_torch.nn.families"
_LAYERS = "bdbnn_tpu_torch.nn.layers"

# each public name and the module that defines it, imported on first use
# (a submodule's own name maps to the submodule)
_EXPORTS = {
    "binarize": _BINARIZE,
    "families": _FAMILIES,
    "layers": _LAYERS,
    "packed": "bdbnn_tpu_torch.nn.packed",
    "ste_sign": _BINARIZE,
    "approx_sign": _BINARIZE,
    "ede_sign": _BINARIZE,
    "prox_sign": _BINARIZE,
    "stoch_sign": _BINARIZE,
    "StepDraws": _BINARIZE,
    "binarize_weight": _BINARIZE,
    "BinarizerFamily": _BINARIZE,
    "FAMILY_NAMES": _FAMILIES,
    "active_family": _BINARIZE,
    "get_active_family": _BINARIZE,
    "make_family": _BINARIZE,
    "parse_binarizer": _FAMILIES,
    "resolve_family": _BINARIZE,
    "set_active_family": _BINARIZE,
    "BatchNorm": _LAYERS,
    "BinaryConv": _LAYERS,
    "BinaryConvCifar": _LAYERS,
    "BinaryConvReact": _LAYERS,
    "FloatConv": _LAYERS,
    "LearnableBias": _LAYERS,
    "RPReLU": _LAYERS,
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(module)
    value = mod if module == f"{__name__}.{name}" else getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

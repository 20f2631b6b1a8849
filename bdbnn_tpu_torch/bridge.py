"""The weight bridge: flax variable trees ↔ the port's ``state_dict``.

A flax tree is ``{"params": ..., "batch_stats": ..., ["packed": ...]}``
as nested dicts of numpy arrays; module paths are the same on both sides
(the port's submodules carry the flax module names). Per leaf:

- conv ``weight`` HWIO (flax ``FloatConv``) ↔ OIHW;
- Dense ``kernel (in, out)`` ↔ Linear ``weight (out, in)``;
- BatchNorm ``params.scale/bias`` + ``batch_stats.mean/var`` ↔
  ``weight/bias`` + ``running_mean/running_var``;
- packed ``{sign, alpha}`` (the engine's packed collection) ↔ a packed
  binary conv's ``sign``/``alpha`` buffers;
- everything else (``float_weight`` in HWIO, ``act_shift``, RPReLU
  ``gamma/zeta/slope``, biases) unchanged.

Both directions are permutations of the same values, so a round trip is
exact. This module imports torch and numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _set(tree: Dict[str, Any], path, leaf) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.asarray(t)


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax-layout variable tree → the port's ``state_dict`` (CPU
    tensors, contiguous)."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, arr) -> None:
        out[key] = torch.from_numpy(np.ascontiguousarray(_np(arr)))

    def rec(pnode, snode, prefix: str) -> None:
        if "scale" in pnode and not isinstance(pnode["scale"], dict):
            # a BatchNorm: params {scale, bias} + batch_stats {mean, var}
            put(prefix + "weight", pnode["scale"])
            put(prefix + "bias", pnode["bias"])
            put(prefix + "running_mean", snode["mean"])
            put(prefix + "running_var", snode["var"])
            return
        for k, v in pnode.items():
            if isinstance(v, dict):
                rec(v, (snode or {}).get(k, {}), prefix + k + ".")
            elif k == "kernel":
                put(prefix + "weight", _np(v).T)
            elif k == "weight" and _np(v).ndim == 4:
                put(prefix + "weight", _np(v).transpose(3, 2, 0, 1))
            else:
                put(prefix + k, v)

    rec(variables.get("params", {}), variables.get("batch_stats", {}), "")

    def rec_packed(node, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                rec_packed(v, prefix + k + ".")
            else:
                put(prefix + k, v)

    rec_packed(variables.get("packed", {}) or {}, "")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` → a flax-layout variable tree of numpy
    arrays (``packed`` only when the model holds packed convs)."""
    modules: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        modules.setdefault(prefix, {})[leaf] = _np(t)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    packed: Dict[str, Any] = {}
    for prefix, leaves in modules.items():
        path = tuple(prefix.split(".")) if prefix else ()
        if "running_mean" in leaves:
            _set(params, path + ("scale",), leaves["weight"])
            _set(params, path + ("bias",), leaves["bias"])
            _set(stats, path + ("mean",), leaves["running_mean"])
            _set(stats, path + ("var",), leaves["running_var"])
            continue
        is_packed = "sign" in leaves and "alpha" in leaves
        for name, arr in leaves.items():
            if is_packed and name in ("sign", "alpha"):
                _set(packed, path + (name,), arr)
            elif name == "weight" and arr.ndim == 4:
                _set(params, path + ("weight",), np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
            elif name == "weight" and arr.ndim == 2:
                _set(params, path + ("kernel",), np.ascontiguousarray(arr.T))
            else:
                _set(params, path + (name,), arr)
    tree: Dict[str, Any] = {"params": params, "batch_stats": stats}
    if packed:
        tree["packed"] = packed
    return tree


__all__ = ["flax_to_state_dict", "state_dict_to_flax"]

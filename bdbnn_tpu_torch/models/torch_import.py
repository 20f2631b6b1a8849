"""Torch checkpoints of float teachers → the port's models — the port's own
copy of ``bdbnn_tpu/models/torch_import.py``.

The reference loads its full-precision teachers from torchvision or
``DataParallel`` checkpoints, whose keys may carry a ``module.`` prefix.
The port's float models are torchvision's layout already (conv weights
OIHW, Linear ``(out, in)``, BN ``weight``/``bias``/``running_mean``/
``running_var``), so a key is renamed and no tensor is transposed:

- the ``module.`` prefix is stripped;
- ``layer{S}.{B}.rest`` → ``layer{S}_{B}.rest``;
- ``downsample.0`` → ``downsample_conv``, ``downsample.1`` →
  ``downsample_bn``;
- ``num_batches_tracked`` is skipped.

:func:`overlay_state_dict` loads the result as the reference's
``_overlay`` does: a shape mismatch or a checkpoint key the model does
not consume raises, and so does a model key the checkpoint lacks unless
missing keys are allowed; ``alias_float_weight`` puts a float conv's
OIHW ``weight`` on a binary conv's HWIO ``float_weight``.
:func:`load_state_dict_strict` is the strict case.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def translate_key(key: str) -> Optional[str]:
    """torchvision/DataParallel key → the port's key (``None``: skipped)."""
    if key.startswith("module."):
        key = key[len("module."):]
    parts = key.split(".")
    if parts[0].startswith("layer") and len(parts) > 2 and parts[1].isdigit():
        parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
    if "downsample" in parts:
        i = parts.index("downsample")
        sub = parts[i + 1] if i + 1 < len(parts) else ""
        parts = parts[:i] + ["downsample_conv" if sub == "0" else "downsample_bn"] + parts[i + 2:]
    if parts[-1] == "num_batches_tracked":
        return None
    return ".".join(parts)


def convert_torch_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` (tensors or arrays) → the port's keys, as
    CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        new = translate_key(key)
        if new is None:
            continue
        if new in out:
            raise ValueError(f"checkpoint keys collide on {new!r} (at {key!r})")
        t = val.detach().cpu() if isinstance(val, torch.Tensor) else torch.from_numpy(np.asarray(val))
        out[new] = t
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pth.tar`` (a dict with a ``state_dict``
    entry) or a bare state dict, converted. Read with
    ``weights_only=True``: a teacher file comes from outside the program."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_torch_state_dict(state_dict)


def overlay_state_dict(
    model: torch.nn.Module,
    state_dict: Mapping[str, torch.Tensor],
    *,
    scope: str = "checkpoint",
    allow_missing: bool = False,
    alias_float_weight: bool = False,
) -> torch.nn.Module:
    """Load ``state_dict`` into ``model`` as the reference's ``_overlay``
    does: every entry onto a model entry of the same shape (cast to its
    dtype and device); a checkpoint key the model does not consume
    raises; a model key the checkpoint lacks raises unless
    ``allow_missing``. ``alias_float_weight`` puts a checkpoint conv
    ``weight`` (OIHW, torchvision's layout) on the model's binary
    ``float_weight`` (HWIO) when the model has no ``weight`` there — a
    binary student initialized from a float checkpoint; its binary
    extras (act_shift, RPReLU) then keep their initial values."""
    own = model.state_dict()
    merged: Dict[str, torch.Tensor] = {}
    unconsumed = []
    for key, val in state_dict.items():
        target = key
        if key not in own and alias_float_weight and key.endswith(".weight"):
            alias = key[: -len("weight")] + "float_weight"
            if alias in own:
                target = alias
                if val.dim() == 4:  # OIHW -> HWIO
                    val = val.permute(2, 3, 1, 0)
        if target not in own:
            unconsumed.append(key)
            continue
        if tuple(val.shape) != tuple(own[target].shape):
            raise ValueError(
                f"{scope}: shape mismatch at {target}: checkpoint {tuple(val.shape)} vs "
                f"model {tuple(own[target].shape)}"
            )
        merged[target] = val.to(device=own[target].device, dtype=own[target].dtype).contiguous()
    if unconsumed:
        unconsumed.sort()
        raise ValueError(
            f"{scope}: checkpoint keys not consumed by the model (arch mismatch?): "
            f"{unconsumed[:8]}" + ("..." if len(unconsumed) > 8 else "")
        )
    missing = sorted(set(own) - set(merged))
    if missing and not allow_missing:
        raise ValueError(
            f"{scope}: model params missing from checkpoint: {missing[:8]}"
            + ("..." if len(missing) > 8 else "")
        )
    model.load_state_dict(merged, strict=not missing)
    return model


def load_state_dict_strict(
    model: torch.nn.Module, state_dict: Mapping[str, torch.Tensor], *, scope: str = "checkpoint"
) -> torch.nn.Module:
    """Load ``state_dict`` into ``model``: every entry onto a model entry
    of the same shape, every model entry covered, cast to its dtype."""
    return overlay_state_dict(model, state_dict, scope=scope)


__all__ = [
    "convert_torch_state_dict",
    "load_state_dict_strict",
    "load_torch_checkpoint",
    "overlay_state_dict",
    "translate_key",
]

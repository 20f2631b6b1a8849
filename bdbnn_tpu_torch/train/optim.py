"""Optimizer / LR-schedule policy — counterpart of
``bdbnn_tpu/train/optim.py`` on ``torch.optim`` (the optimizer update is
no hand-written kernel in either package).

- CIFAR: SGD(lr, momentum 0.9, weight decay on every parameter) with
  ``CosineAnnealingLR(T_max=epochs)`` stepped per epoch;
- ImageNet: Adam(0.9, 0.999, eps 1e-8) with weight decay only on the
  "weight parameters" — 4-D or any dotted-name part containing 'conv'
  (the port's module names mirror the flax paths, so
  ``layer1_0.conv1.act_shift`` is decayed, as in the reference) — and
  ``LambdaLR(1 - epoch/epochs)`` stepped per epoch.

torch's decay is the coupled L2 form (added to the gradient before
momentum / Adam), as the reference chains ``add_decayed_weights``
first. The schedules are functions of ``step // steps_per_epoch`` in
float32 arithmetic, as the reference evaluates them; the train step sets
each group's ``lr`` from ``optimizer.lr_schedule(step)`` before the
update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

_F = np.float32


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """name -> in the Adam weight-decay group (↔ ``conv_weight_mask``)."""
    return {
        name: (p.dim() == 4 or any("conv" in part for part in name.split(".")))
        for name, p in named_params
    }


def cosine_epoch_schedule(
    base_lr: float, epochs: int, steps_per_epoch: int, eta_min: float = 0.0
) -> Callable[[int], float]:
    """torch CosineAnnealingLR(T_max=epochs) stepped per epoch."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        cos = np.cos(_F(math.pi) * _F(epoch) / _F(epochs), dtype=np.float32)
        return float(_F(eta_min) + (_F(base_lr) - _F(eta_min)) * _F(0.5) * (_F(1.0) + cos))

    return schedule


def linear_epoch_schedule(
    base_lr: float, epochs: int, steps_per_epoch: int
) -> Callable[[int], float]:
    """torch LambdaLR(lambda e: 1 - e/epochs) stepped per epoch."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return float(_F(base_lr) * (_F(1.0) - _F(epoch) / _F(epochs)))

    return schedule


def make_optimizer(
    model: torch.nn.Module,
    *,
    dataset: str,
    lr: float,
    epochs: int,
    steps_per_epoch: int,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    policy: str = "",
) -> torch.optim.Optimizer:
    """The reference policy keyed on dataset, or ``policy`` ("sgd-cosine"
    / "adam-linear"). The returned optimizer carries ``lr_schedule``
    (step -> lr) and ``policy``."""
    if policy and policy not in ("sgd-cosine", "adam-linear"):
        raise ValueError(f"unknown opt policy {policy!r}")
    adam = policy == "adam-linear" if policy else dataset == "imagenet"
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if adam:
        mask = decay_mask(named)
        groups = [
            {"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
        ]
        opt = torch.optim.Adam(
            [g for g in groups if g["params"]], lr=lr, betas=(0.9, 0.999), eps=1e-8
        )
        opt.lr_schedule = linear_epoch_schedule(lr, epochs, steps_per_epoch)
        opt.policy = "adam-linear"
    else:
        opt = torch.optim.SGD(
            [p for _, p in named], lr=lr, momentum=momentum, dampening=0.0,
            weight_decay=weight_decay, nesterov=False,
        )
        opt.lr_schedule = cosine_epoch_schedule(lr, epochs, steps_per_epoch)
        opt.policy = "sgd-cosine"
    return opt


def set_lr(opt: torch.optim.Optimizer, step: int) -> float:
    """Set every group's LR to the schedule's value at ``step``."""
    lr = opt.lr_schedule(step)
    for group in opt.param_groups:
        group["lr"] = lr
    return lr


__all__ = [
    "cosine_epoch_schedule",
    "decay_mask",
    "linear_epoch_schedule",
    "make_optimizer",
    "set_lr",
]

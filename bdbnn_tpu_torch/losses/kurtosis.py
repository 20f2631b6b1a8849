"""Kurtosis ("bimodal") weight regularization — counterpart of
``bdbnn_tpu/losses/kurtosis.py``.

``kurtosis`` / ``kurtosis_loss`` / ``kurtosis_regularization`` run on K7
(:mod:`bdbnn_tpu_torch.nn.kernels.kurtosis`): one grouped call computes
every hooked tensor's centered two-pass kurtosis (Bessel-corrected
variance, as the reference's ``torch.std``), the avg/sum/max reduction
and, for the differentiable entries, the gradient of the reduced loss in
closed form — the autograd backward only scales it by the upstream
gradient. On CPU tensors the same functions run K7's plain version.

``l2_regularization`` and ``weight_to_pm1_regularization`` are plain
PyTorch, as in the reference (no hand-written primitive there).
"""

from __future__ import annotations

from typing import Sequence

import torch

from bdbnn_tpu_torch.nn.kernels.kurtosis import kurtosis_grouped

Tensor = torch.Tensor

# Per-layer target tables for ``--diffkurt`` (19 binarized convs of the
# ResNet-18-shaped flagship), copied verbatim from the reference
# (bdbnn_tpu/losses/kurtosis.py:31-48).
DIFFKURT_TARGETS_IMAGENET: tuple = (
    1.8, 1.4, 1.4, 1.4,
    1.4, 1.2, 1.4, 1.2, 1.2,
    1.4, 1.4, 1.4, 1.2, 1.2,
    1.2, 1.2, 1.4, 1.0, 1.0,
)
DIFFKURT_TARGETS_CIFAR: tuple = (
    1.4, 1.4, 1.4, 1.4,
    1.4, 1.4, 1.4, 1.4, 1.4,
    1.4, 1.4, 1.4, 1.4, 1.4,
    1.8, 1.8, 1.8, 1.8, 2.2,
)
DIFFKURT_TARGETS_TS: tuple = (
    1.8, 1.8, 1.8, 1.8,
    1.8, 1.8, 1.4, 1.8, 1.8,
    1.8, 1.4, 1.4, 1.4, 1.4,
    1.8, 1.2, 1.4, 1.2, 1.2,
)


class _KurtosisRegFn(torch.autograd.Function):
    """The reduced kurtosis loss of ``weights``; K7 computes its gradient
    with the loss, so the backward is one scaling by the upstream
    gradient."""

    @staticmethod
    def forward(ctx, targets, mode, *weights):
        loss, _, grads = kurtosis_grouped(
            [w.contiguous() for w in weights], targets, mode,
            with_grad=any(ctx.needs_input_grad[2:]),
        )
        ctx.grads = grads
        return loss

    @staticmethod
    def backward(ctx, g):
        grads, ctx.grads = ctx.grads, None
        return (None, None, *[gw * g for gw in grads])


def kurtosis_regularization(
    weights: Sequence[Tensor],
    targets: Sequence[float],
    mode: str = "avg",
) -> Tensor:
    """Cross-layer reduction (``mode`` ∈ {sum, avg, max}, the reference's
    ``--kurtosis-mode``) of per-layer ``(kurt(W) - target)²``;
    differentiable in every weight."""
    if len(weights) != len(targets):
        raise ValueError(f"{len(weights)} weight tensors but {len(targets)} targets")
    return _KurtosisRegFn.apply(tuple(float(t) for t in targets), mode, *weights)


def kurtosis_loss(w: Tensor, target) -> Tensor:
    """``(kurt(W) - target)²`` for a single weight tensor."""
    return kurtosis_regularization([w], [float(target)], "sum")


def kurtosis(w: Tensor) -> Tensor:
    """kurt(W) = mean(((W - mean) / std)⁴) with Bessel-corrected std —
    a value (no gradient: differentiate :func:`kurtosis_loss`)."""
    _, kurt, _ = kurtosis_grouped([w.detach().contiguous()], (0.0,), "sum", with_grad=False)
    return kurt[0]


def l2_regularization(weights: Sequence[Tensor]) -> Tensor:
    """Sum of squared weights (the reference's ``RidgeRegularization``)."""
    return sum(torch.sum(w**2) for w in weights)


def weight_to_pm1_regularization(weights: Sequence[Tensor]) -> Tensor:
    """``‖|W| − 1‖₂`` summed over tensors: pulls latent weights toward ±1
    (the reference's ``WeightRegularization``)."""
    return sum(torch.sqrt(torch.sum((torch.abs(w) - 1.0) ** 2)) for w in weights)


def resolve_targets(
    num_layers: int,
    *,
    scalar_target: float = 1.8,
    diffkurt: bool = False,
    dataset: str = "cifar10",
    teacher_student: bool = False,
) -> tuple:
    """Per-layer target vector (the reference's target selection)."""
    if not diffkurt:
        return (float(scalar_target),) * num_layers
    if teacher_student:
        table = DIFFKURT_TARGETS_TS
    elif dataset == "imagenet":
        table = DIFFKURT_TARGETS_IMAGENET
    else:
        table = DIFFKURT_TARGETS_CIFAR
    if num_layers != len(table):
        raise ValueError(
            f"--diffkurt tables are defined for {len(table)} hooked layers; "
            f"model hooks {num_layers}. Pass explicit targets instead."
        )
    return table


__all__ = [
    "DIFFKURT_TARGETS_CIFAR",
    "DIFFKURT_TARGETS_IMAGENET",
    "DIFFKURT_TARGETS_TS",
    "kurtosis",
    "kurtosis_loss",
    "kurtosis_regularization",
    "l2_regularization",
    "resolve_targets",
    "weight_to_pm1_regularization",
]

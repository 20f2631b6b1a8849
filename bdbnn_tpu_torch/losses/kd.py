"""Distillation losses — counterpart of ``bdbnn_tpu/losses/kd.py``.

The same functions with the same reductions: the batch CE, the logit
distillation of the teacher–student step, the per-layer weight "KL"
(torch's ``KLDivLoss(log_target=True)`` on raw weights,
``mean(exp(w_t)·(w_t − w_s))``), its temperature-softened variant, Hinton's
logit KD and the one-time pairing of student and teacher convs. The teacher
side of every loss is detached (the reference's ``stop_gradient``).

Layout: the weight losses are elementwise, so both lists must hold their
tensors in one layout. The reference holds every conv kernel in HWIO; the
port's ``FloatConv.weight`` is OIHW, so callers pass weights through
:func:`~bdbnn_tpu_torch.models.resnet.conv_weight_hwio` first. The softened
variant takes its softmax over axis 1 of HWIO (the kernel width), as the
reference does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from bdbnn_tpu_torch.obs.trace import span

Tensor = torch.Tensor


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over the batch with integer labels (↔ nn.CrossEntropyLoss):
    ``-mean(log_softmax(logits)[label])``, the reference's order."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.reshape(-1, 1).to(torch.int64))[:, 0]
    return nll.mean()


def distribution_loss(stud_logits: Tensor, teacher_logits: Tensor) -> Tensor:
    """Logit distillation: batch mean of −softmax(teacher)·log_softmax(student)."""
    with span("kd_logit_loss"):
        logp_s = torch.log_softmax(stud_logits, dim=1)
        p_t = torch.softmax(teacher_logits.detach(), dim=1)
        return torch.mean(-torch.sum(p_t * logp_s, dim=1))


def _check_pairs(stud_weights: Sequence[Tensor], teacher_weights: Sequence[Tensor]) -> Tensor:
    """A float32 zero on the weights' device, after checking that the
    pairs match one for one in shape."""
    if len(stud_weights) != len(teacher_weights):
        raise ValueError(
            f"{len(stud_weights)} student weights against {len(teacher_weights)} teacher weights"
        )
    for i, (ws, wt) in enumerate(zip(stud_weights, teacher_weights)):
        if ws.shape != wt.shape:
            raise ValueError(
                f"pair {i}: student {tuple(ws.shape)} vs teacher {tuple(wt.shape)}; the weight "
                "losses are elementwise and need both in one layout (HWIO)"
            )
    device = stud_weights[0].device if stud_weights else None
    return torch.zeros((), dtype=torch.float32, device=device)


def layer_weight_kl(stud_weights: Sequence[Tensor], teacher_weights: Sequence[Tensor]) -> Tensor:
    """Σ over pairs of ``mean(exp(w_t)·(w_t − w_s))`` (student as input,
    teacher as log-target)."""
    total = _check_pairs(stud_weights, teacher_weights)
    with span("kd_weight_loss"):
        for ws, wt in zip(stud_weights, teacher_weights):
            wt = wt.detach()
            total = total + torch.mean(torch.exp(wt) * (wt - ws))
        return total


def layer_weight_kl_softened(
    stud_weights: Sequence[Tensor], teacher_weights: Sequence[Tensor], temperature: float = 6.0
) -> Tensor:
    """Σ over pairs of the elementwise-mean KL(softmax(w_t/T) ‖
    softmax(w_s/T)) · T², the softmax over axis 1 of HWIO; ``xlogy``
    keeps 0·log 0 = 0 where a teacher probability underflows."""
    T = temperature
    total = _check_pairs(stud_weights, teacher_weights)
    for ws, wt in zip(stud_weights, teacher_weights):
        logp_s = torch.log_softmax(ws / T, dim=1)
        p_t = torch.softmax(wt.detach() / T, dim=1)
        kl = torch.mean(torch.special.xlogy(p_t, p_t) - p_t * logp_s)
        total = total + kl * (T * T)
    return total


def loss_kd(stud_logits: Tensor, teacher_logits: Tensor, temperature: float = 6.0) -> Tensor:
    """Hinton logit KD with T² scaling and the elementwise-mean reduction."""
    T = temperature
    logp_s = torch.log_softmax(stud_logits / T, dim=1)
    p_t = torch.softmax(teacher_logits.detach() / T, dim=1)
    kl = torch.mean(torch.special.xlogy(p_t, p_t) - p_t * logp_s)
    return kl * (T * T)


def match_conv_pairs(
    stud_paths: Sequence[str],
    teacher_paths: Sequence[str],
    *,
    skip_stem: bool = True,
    skip_downsample: bool = True,
) -> List[Tuple[str, str]]:
    """Name-equal (student, teacher) conv pairs for the layer KL, in the
    student's order: the stem (index 0) and every 'downsample' path
    skipped by default, as the reference's ``DistributionLoss_layer``;
    the softened CIFAR variant pairs with ``skip_downsample=False``."""
    teacher_set = set(teacher_paths)
    pairs = []
    for i, p in enumerate(stud_paths):
        if skip_stem and i == 0:
            continue
        if skip_downsample and "downsample" in p:
            continue
        if p in teacher_set:
            pairs.append((p, p))
    return pairs


__all__ = [
    "distribution_loss",
    "layer_weight_kl",
    "layer_weight_kl_softened",
    "loss_kd",
    "match_conv_pairs",
    "softmax_cross_entropy",
]

"""Distillation losses — counterpart of ``bdbnn_tpu/losses/kd.py``.

Only the plain step's cross entropy is ported with the training slice;
the teacher–student losses (``distribution_loss``, ``layer_weight_kl``,
``match_conv_pairs``) come with the teacher–student step (ROADMAP A,
"Later" 1).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def softmax_cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean CE over the batch with integer labels (↔ nn.CrossEntropyLoss):
    ``-mean(log_softmax(logits)[label])``, the reference's order."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.reshape(-1, 1).to(torch.int64))[:, 0]
    return nll.mean()


__all__ = ["softmax_cross_entropy"]

"""Binarization health probes — counterpart of ``bdbnn_tpu/obs/probes.py``
(same metric keys).

- ``flips/<layer>`` — latent weights whose sign changed in this update;
- ``kurt/<layer>``  — Bessel-corrected kurtosis of the layer's latent
  weights after the update: one grouped K7 forward over every probed
  layer (:func:`bdbnn_tpu_torch.nn.kernels.kurtosis.kurtosis_grouped`);
- ``nonfinite``     — 1 when the step's loss is not finite.

Every value stays a device tensor; the train loop drains them with the
other metrics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from bdbnn_tpu_torch.nn.kernels.kurtosis import kurtosis_grouped

FLIP_PREFIX = "flips/"
KURT_PREFIX = "kurt/"


class NonFiniteLossError(RuntimeError):
    """Raised (policy 'raise') when a drained interval held a non-finite
    train loss."""


def probe_signs(weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The signs (``torch.sign``, 0 at 0 — the reference's ``jnp.sign``)
    of the probed weights before the update."""
    return [torch.sign(w.detach()) for w in weights]


def probe_metrics(
    old_signs: Sequence[torch.Tensor],
    new_weights: Sequence[torch.Tensor],
    probe_names: Sequence[str],
) -> Dict[str, torch.Tensor]:
    """Per-layer sign-flip counts and kurtosis after the update."""
    out: Dict[str, torch.Tensor] = {}
    if not probe_names:
        return out
    _, kurt, _ = kurtosis_grouped(
        [w.detach() for w in new_weights], (0.0,) * len(new_weights), "sum", with_grad=False
    )
    for i, (old, w, name) in enumerate(zip(old_signs, new_weights, probe_names)):
        out[FLIP_PREFIX + name] = (old != torch.sign(w.detach())).sum().to(torch.float32)
        out[KURT_PREFIX + name] = kurt[i]
    return out


def nonfinite_flag(loss: torch.Tensor) -> torch.Tensor:
    """1 iff the step's loss is NaN/Inf (int32, summable)."""
    return torch.logical_not(torch.isfinite(loss)).to(torch.int32)


def drain_probe_report(
    sums: Dict[str, float], probe_sizes: Dict[str, int], interval_steps: int
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Drained probe SUMS → per-layer per-step flip rates and
    interval-mean kurtosis."""
    steps = max(interval_steps, 1)
    flip_rate, kurt = {}, {}
    for name, size in probe_sizes.items():
        f = sums.get(FLIP_PREFIX + name)
        if f is not None:
            flip_rate[name] = f / (max(size, 1) * steps)
        k = sums.get(KURT_PREFIX + name)
        if k is not None:
            kurt[name] = k / steps
    return flip_rate, kurt


__all__ = [
    "FLIP_PREFIX",
    "KURT_PREFIX",
    "NonFiniteLossError",
    "drain_probe_report",
    "nonfinite_flag",
    "probe_metrics",
    "probe_signs",
]

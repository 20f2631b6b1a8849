"""Train state + step configuration — counterparts of
``bdbnn_tpu/train/state.py``.

:class:`StepConfig` has the reference's fields and ``resolved()``; the
step reads them when it runs (PyTorch has no trace time). Everything that
varies per epoch (the binarizer family's schedule ``tk``, the kurtosis
gate) is a per-call argument of the step, as in the reference.
:class:`TrainState` is the mutable torch counterpart of the reference's
pure pytree: the model (parameters and BN running statistics), the
optimizer (its state and epoch-keyed LR schedule) and the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class TrainState:
    """Model + optimizer + completed optimizer steps."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Configuration of a train step (the reference's fields; see
    ``bdbnn_tpu/train/state.py`` for each one's meaning). Total loss =
    ``beta·layerKL + alpha·logitKL + w_lambda_ce·CE + λ·kurt [+ λ_l2·L2
    + λ_wr·WR]``; the plain step is the special case alpha = beta = 0,
    w_lambda_ce = 1."""

    # kurtosis
    w_kurtosis: bool = False
    kurt_paths: Tuple[Tuple[str, ...], ...] = ()
    kurt_targets: Tuple[float, ...] = ()
    kurtosis_mode: str = "avg"
    w_lambda_kurtosis: float = 1.0
    # auxiliary regularizers
    w_l2_reg: bool = False
    w_lambda_l2: float = 0.0
    w_wr_reg: bool = False
    w_lambda_wr: float = 0.0
    # distillation (the teacher-student step)
    teacher_student: bool = False
    react: bool = False
    alpha: float = 0.9
    beta: float = 200.0
    temperature: float = 4.0
    w_lambda_ce: float = 1.0
    kd_pairs: Tuple[Tuple[Tuple[str, ...], Tuple[str, ...]], ...] = ()
    # binarizer family: legacy EDE flag, resolved family name, whether
    # its schedule reaches the convs as ``tk``, whether it samples
    ede: bool = False
    binarizer: str = "ste"
    binarizer_schedule: bool = False
    binarizer_stochastic: bool = False
    rng_seed: int = 0
    # observability
    log_grad_norm: bool = False
    probe_paths: Tuple[Tuple[str, ...], ...] = ()
    probe_names: Tuple[str, ...] = ()
    track_nonfinite: bool = False
    # device-side input normalization: ((mean,...), (std,...)) in 0-1
    # scale; the step then takes raw uint8 NHWC batches
    input_norm: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None

    def resolved(self) -> "StepConfig":
        """The reference's react-mode overrides (beta = 0, w_lambda_ce = 0
        under teacher-student + react)."""
        if self.teacher_student and self.react:
            return dataclasses.replace(self, beta=0.0, w_lambda_ce=0.0)
        return self


__all__ = ["StepConfig", "TrainState"]

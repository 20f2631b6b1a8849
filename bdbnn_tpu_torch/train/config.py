"""Typed run configuration — the port's copy of the reference's
``RunConfig`` (``bdbnn_tpu/configs/config.py``): the same fields, names
and defaults, plus ``device``.

:meth:`RunConfig.validate` raises ``NotImplementedError`` for every option
the port does not run yet, naming the ROADMAP item that brings it — an
option is never silently ignored. An option counts as asked for when its
value differs from the default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from bdbnn_tpu_torch.nn.binarize import resolve_family

# ROADMAP A "Later" items, by number
TS = "item 1: teacher-student step (kd losses, teacher, FloatBottleneck)"
CKPT = "item 2: checkpoint/resume/events"
REMAT_BF16 = "item 4: remat and bf16"
DDP = "item 6: DDP"
OBS = "item 7: obs, scripts"
DATA = "ImageNet from an image folder (ROADMAP A 7, the ImageFolder pipelines)"

# field -> ROADMAP item; asked for when the value differs from the default
UNSUPPORTED = {
    "imagenet_setting_step_2_ts": TS,
    "arch_teacher": TS,
    "custom_resnet_teacher": TS,
    "resume_teacher": TS,
    "allow_random_teacher": TS,
    "react": TS,
    "alpha": TS,
    "temperature": TS,
    "beta": TS,
    "w_lambda_ce": TS,
    "pretrained": CKPT,
    "pretrained_path": CKPT,
    "resume": CKPT,
    "reset_resume": CKPT,
    "save_every_steps": CKPT,
    "save_every_mins": CKPT,
    "log_path": CKPT,
    "events_max_mb": CKPT,
    "remat": REMAT_BF16,
    "dtype": REMAT_BF16,
    "model_parallel": DDP,
    "distributed_init": DDP,
    "profile_dir": OBS,
    "profile_at": OBS,
    "health_forensics_steps": OBS,
    "health_max_forensics": OBS,
    "health_thresholds": OBS,
    "workers": DATA,
    "input_backend": DATA,
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    # data
    data: str = ""
    dataset: str = "cifar10"  # cifar10 | cifar100 | imagenet
    workers: Optional[int] = None
    input_backend: str = "auto"
    synthetic: bool = False
    synthetic_train_size: int = 2048
    synthetic_val_size: int = 512
    # model
    arch: str = "resnet18"
    custom_resnet: bool = True
    pretrained: bool = False
    pretrained_path: str = ""
    twoblock: bool = False
    remat: bool = False
    # schedule
    opt_policy: str = ""
    epochs: int = 90
    start_epoch: int = 0
    batch_size: int = 256
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # logging / checkpoint
    print_freq: int = 10
    log_path: str = "log"
    resume: str = ""
    reset_resume: bool = False
    save_every_steps: int = 0
    save_every_mins: float = 0.0
    evaluate: bool = False
    seed: Optional[int] = None
    # binarizer
    ede: bool = False
    binarizer: str = ""
    # kurtosis
    w_kurtosis: bool = False
    w_kurtosis_target: float = 1.8
    w_lambda_kurtosis: float = 1.0
    weight_name: Tuple[str, ...] = ("all",)
    remove_weight_name: Tuple[str, ...] = ()
    kurtosis_mode: str = "avg"
    diffkurt: bool = False
    kurtepoch: int = 0
    # aux regularizers
    w_l2_reg: bool = False
    w_lambda_l2: float = 0.0
    w_wr_reg: bool = False
    w_lambda_wr: float = 0.0
    # teacher-student
    imagenet_setting_step_2_ts: bool = False
    arch_teacher: str = "resnet18_float"
    custom_resnet_teacher: bool = False
    resume_teacher: str = ""
    allow_random_teacher: bool = False
    react: bool = False
    alpha: float = 0.9
    temperature: float = 4.0
    beta: float = 200.0
    w_lambda_ce: float = 1.0
    # parallelism
    model_parallel: int = 1
    distributed_init: bool = False
    # compute
    dtype: str = "float32"
    device_normalize: bool = False
    target_acc: float = 0.0
    # observability
    profile_dir: str = ""
    profile_start: int = 5
    profile_steps: int = 5
    profile_at: Tuple[str, ...] = ()
    probe_binarization: bool = True
    nonfinite_policy: str = "raise"
    health: bool = True
    health_forensics: bool = True
    health_forensics_steps: int = 4
    health_max_forensics: int = 2
    health_thresholds: Tuple[str, ...] = ()
    events_max_mb: float = 256.0
    # the port's own: the torch device ("" = the CUDA card)
    device: str = ""

    @property
    def num_classes(self) -> int:
        return {"cifar10": 10, "cifar100": 100, "imagenet": 1000}[self.dataset]

    @property
    def teacher_student(self) -> bool:
        return self.imagenet_setting_step_2_ts

    def unsupported(self):
        """(field, ROADMAP item) of every option asked for that the port
        does not run yet."""
        defaults = RunConfig()
        out = [(f, item) for f, item in UNSUPPORTED.items()
               if getattr(self, f) != getattr(defaults, f)]
        if self.dataset == "imagenet" and not self.synthetic and not self.evaluate:
            out.append(("data", DATA))
        return out

    def validate(self) -> "RunConfig":
        if self.dataset not in ("cifar10", "cifar100", "imagenet"):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.kurtosis_mode not in ("avg", "sum", "max"):
            raise ValueError(f"unknown kurtosis mode {self.kurtosis_mode!r}")
        if self.batch_size <= 0 or self.epochs <= 0:
            raise ValueError("batch_size and epochs must be positive")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.opt_policy not in ("", "sgd-cosine", "adam-linear"):
            raise ValueError(f"unknown opt_policy {self.opt_policy!r}")
        if self.nonfinite_policy not in ("raise", "warn", "ignore"):
            raise ValueError(f"unknown nonfinite_policy {self.nonfinite_policy!r} (raise | warn | ignore)")
        if not 0.0 <= self.target_acc < 100.0:
            raise ValueError(f"target_acc is a top-1 PERCENTAGE in [0, 100), got {self.target_acc!r}")
        if self.device_normalize and self.synthetic:
            raise ValueError(
                "--device-normalize needs uint8 pipelines; the synthetic "
                "smoke pipeline emits pre-normalized floats"
            )
        missing = self.unsupported()
        if missing:
            f, item = missing[0]
            raise NotImplementedError(
                f"option {f!r} is not ported yet: ROADMAP A 'Later' {item}"
                if item != DATA else f"option {f!r}: {item} is not ported yet; use --synthetic"
            )
        fam = resolve_family(self.binarizer, ede=self.ede)
        return dataclasses.replace(self, binarizer=fam.spec, ede=fam.name == "ede")


__all__ = ["RunConfig", "UNSUPPORTED"]

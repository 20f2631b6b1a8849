"""Typed run configuration — the port's copy of the reference's
``RunConfig`` (``bdbnn_tpu/configs/config.py``): the same fields, names
and defaults, plus ``device``.

:meth:`RunConfig.validate` refuses what the reference refuses, and
``--input-backend tfdata``, whose TensorFlow pipeline the port does not
run (``RuntimeError``): an option is never silently ignored. Every other
training option of the reference is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from bdbnn_tpu_torch.nn.binarize import resolve_family
from bdbnn_tpu_torch.obs.health import HealthConfig, apply_overrides
from bdbnn_tpu_torch.obs.trace import parse_profile_at

# the reference's tf.data input engine (``TFDataImageFolderPipeline``,
# bdbnn_tpu/data/pipeline.py:695) runs on TensorFlow, which the GPU
# machine does not have; the port runs without it
TFDATA_UNPORTED = (
    "--input-backend tfdata: the TensorFlow input pipeline (TFDataImageFolderPipeline) is "
    "not ported, since the port runs without TensorFlow; use --input-backend mp or threads"
)


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
    # teacher-student (custom_resnet_teacher and temperature are carried
    # and unused, as in the reference)
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
    # parallelism: --distributed-init joins torchrun's process group;
    # model_parallel ranks of it shard the wide layers over 'model', the
    # rest of the world is the 'data' axis (parallel/mesh.py)
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

    def input_engine(self) -> Tuple[str, int]:
        """(backend, workers) of the image-folder pipelines, chosen as the
        reference chooses where TensorFlow is absent: ``-j`` defaults to 4;
        ``auto`` and ``mp`` take worker processes when ``-j`` > 0, else
        threads. ``tfdata`` raises ``RuntimeError``."""
        if self.input_backend == "tfdata":
            raise RuntimeError(TFDATA_UNPORTED)
        workers = 4 if self.workers is None else self.workers
        if self.input_backend in ("auto", "mp"):
            return ("mp" if workers > 0 else "threads"), workers
        return self.input_backend, workers

    def validate(self) -> "RunConfig":
        if self.dataset not in ("cifar10", "cifar100", "imagenet"):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.kurtosis_mode not in ("avg", "sum", "max"):
            raise ValueError(f"unknown kurtosis mode {self.kurtosis_mode!r}")
        if self.batch_size <= 0 or self.epochs <= 0:
            raise ValueError("batch_size and epochs must be positive")
        if self.model_parallel < 1:
            raise ValueError(f"--model-parallel must be >= 1, got {self.model_parallel}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.opt_policy not in ("", "sgd-cosine", "adam-linear"):
            raise ValueError(f"unknown opt_policy {self.opt_policy!r}")
        if self.input_backend not in ("auto", "tfdata", "mp", "threads"):
            raise ValueError(f"unknown input_backend {self.input_backend!r}")
        if self.nonfinite_policy not in ("raise", "warn", "ignore"):
            raise ValueError(f"unknown nonfinite_policy {self.nonfinite_policy!r} (raise | warn | ignore)")
        if self.profile_at:
            # fail at config time, not at the target epoch hours in
            for spec in self.profile_at:
                parse_profile_at(spec, default_steps=self.profile_steps)
        if self.health_thresholds:
            # unknown detector-threshold names fail at config time, not
            # at the first drain hours into the run
            apply_overrides(HealthConfig(), self.health_thresholds)
        if self.health_forensics_steps < 1:
            raise ValueError("--health-forensics-steps must be >= 1")
        if self.health_max_forensics < 0:
            raise ValueError("--health-max-forensics must be >= 0")
        if not 0.0 <= self.target_acc < 100.0:
            raise ValueError(f"target_acc is a top-1 PERCENTAGE in [0, 100), got {self.target_acc!r}")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0 (0 disables rotation)")
        if self.save_every_steps < 0 or self.save_every_mins < 0:
            raise ValueError(
                "--save-every-steps / --save-every-mins must be >= 0 (0 disables the cadence)"
            )
        if self.pretrained and not self.pretrained_path:
            raise ValueError(
                "--pretrained needs --pretrained-path (a local torchvision-layout .pth file)"
            )
        if self.device_normalize and self.synthetic:
            raise ValueError(
                "--device-normalize needs uint8 pipelines; the synthetic "
                "smoke pipeline emits pre-normalized floats"
            )
        self.input_engine()  # tfdata raises before anything is built
        fam = resolve_family(self.binarizer, ede=self.ede)
        return dataclasses.replace(self, binarizer=fam.spec, ede=fam.name == "ede")


__all__ = ["RunConfig", "TFDATA_UNPORTED"]

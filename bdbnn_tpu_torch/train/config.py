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
from bdbnn_tpu_torch.parallel.mesh import TENSOR_PARALLEL

# ROADMAP A "Later" items, by number
OBS = "item 7: obs, scripts"

# the reference's tf.data input engine (``TFDataImageFolderPipeline``,
# bdbnn_tpu/data/pipeline.py:695) runs on TensorFlow, which the GPU
# machine does not have; the port runs without it
TFDATA_UNPORTED = (
    "--input-backend tfdata: the TensorFlow input pipeline (TFDataImageFolderPipeline) is "
    "not ported, since the port runs without TensorFlow; use --input-backend mp or threads"
)

# field -> ROADMAP item; asked for when the value differs from the default
UNSUPPORTED = {
    "model_parallel": TENSOR_PARALLEL,
    "profile_dir": OBS,
    "profile_at": OBS,
    "health_forensics_steps": OBS,
    "health_max_forensics": OBS,
    "health_thresholds": OBS,
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
    # parallelism: --distributed-init joins torchrun's process group (a
    # data-parallel job); model_parallel > 1 is not ported
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
        return [(f, item) for f, item in UNSUPPORTED.items()
                if getattr(self, f) != getattr(defaults, f)]

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
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.opt_policy not in ("", "sgd-cosine", "adam-linear"):
            raise ValueError(f"unknown opt_policy {self.opt_policy!r}")
        if self.input_backend not in ("auto", "tfdata", "mp", "threads"):
            raise ValueError(f"unknown input_backend {self.input_backend!r}")
        if self.nonfinite_policy not in ("raise", "warn", "ignore"):
            raise ValueError(f"unknown nonfinite_policy {self.nonfinite_policy!r} (raise | warn | ignore)")
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
        missing = self.unsupported()
        if missing:
            f, item = missing[0]
            raise NotImplementedError(f"option {f!r} is not ported yet: ROADMAP A 'Later' {item}")
        self.input_engine()  # tfdata raises before anything is built
        fam = resolve_family(self.binarizer, ede=self.ede)
        return dataclasses.replace(self, binarizer=fam.spec, ede=fam.name == "ede")


__all__ = ["RunConfig", "TFDATA_UNPORTED", "UNSUPPORTED"]

"""Run-dir utilities: ``checkpoint`` (save, commit, restore),
``logging_utils`` (run dir, logger, scalars) and ``meters``."""

from bdbnn_tpu_torch.utils import checkpoint, logging_utils, meters
from bdbnn_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_export_payload,
    load_variables,
    save_checkpoint,
)
from bdbnn_tpu_torch.utils.logging_utils import ScalarWriter, make_log_dir, setup_logger
from bdbnn_tpu_torch.utils.meters import DeviceMetrics, Mean, ProgressLog, Throughput, format_eta

__all__ = [
    "checkpoint",
    "logging_utils",
    "meters",
    "load_checkpoint",
    "load_export_payload",
    "load_variables",
    "save_checkpoint",
    "ScalarWriter",
    "make_log_dir",
    "setup_logger",
    "DeviceMetrics",
    "Mean",
    "ProgressLog",
    "Throughput",
    "format_eta",
]

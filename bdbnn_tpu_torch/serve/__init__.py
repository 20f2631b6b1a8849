"""Serving: export artifacts and the bucketed inference engine."""

from bdbnn_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    evaluate_split,
    max_abs_logit_drift,
)
from bdbnn_tpu_torch.serve.export import (
    load_artifact_packed,
    load_artifact_variables,
    read_artifact,
    write_artifact,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "InferenceEngine",
    "evaluate_split",
    "load_artifact_packed",
    "load_artifact_variables",
    "max_abs_logit_drift",
    "read_artifact",
    "write_artifact",
]

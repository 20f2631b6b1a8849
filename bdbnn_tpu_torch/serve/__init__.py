"""Serving: export artifacts, the bucketed inference engine, and the
``serve-bench`` stack — micro-batcher, replica pool, load generator and
SLO verdict."""

from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher
from bdbnn_tpu_torch.serve.config import ServeBenchConfig
from bdbnn_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    evaluate_split,
    max_abs_logit_drift,
    percentile,
)
from bdbnn_tpu_torch.serve.export import (
    load_artifact_packed,
    load_artifact_variables,
    read_artifact,
    write_artifact,
)
from bdbnn_tpu_torch.serve.loadgen import (
    VERDICT_NAME,
    VERDICT_SCHEMA_VERSION,
    LoadGenerator,
    run_serve_bench,
    slo_verdict,
    write_verdict_files,
)
from bdbnn_tpu_torch.serve.pool import (
    DEFAULT_MODEL,
    Replica,
    ReplicaPool,
    ResidentModelCache,
    make_engine_runner_factory,
    resident_block,
    single_engine_resident_block,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_MODEL",
    "VERDICT_NAME",
    "VERDICT_SCHEMA_VERSION",
    "InferenceEngine",
    "LoadGenerator",
    "LoadShedError",
    "MicroBatcher",
    "Replica",
    "ReplicaPool",
    "ResidentModelCache",
    "ServeBenchConfig",
    "evaluate_split",
    "load_artifact_packed",
    "load_artifact_variables",
    "make_engine_runner_factory",
    "max_abs_logit_drift",
    "percentile",
    "read_artifact",
    "resident_block",
    "run_serve_bench",
    "single_engine_resident_block",
    "slo_verdict",
    "write_artifact",
    "write_verdict_files",
]

"""Serving: export artifacts, the bucketed inference engine, the
``serve-bench`` stack — micro-batcher, replica pool, load generator and
SLO verdict — and the ``serve-http`` front end with its admission
control, artifact registry, scenario load generator and rollouts
(blue/green swap, canary, shadow)."""

from bdbnn_tpu_torch.serve.admission import (
    AdmissionController,
    TokenBucket,
    parse_quota,
    parse_tenant_quotas,
)
from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher
from bdbnn_tpu_torch.serve.canary import (
    CanaryConfig,
    CanaryMonitor,
    apply_canary_overrides,
    assign_canary,
)
from bdbnn_tpu_torch.serve.config import ServeBenchConfig, ServeHttpConfig
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
from bdbnn_tpu_torch.serve.http import PREDICT_PATH, HttpFrontEnd, run_serve_http
from bdbnn_tpu_torch.serve.loadgen import (
    SCENARIOS,
    VERDICT_NAME,
    VERDICT_SCHEMA_VERSION,
    Arrival,
    HttpLoadGenerator,
    LoadGenerator,
    build_schedule,
    fairness_ratio,
    http_slo_verdict,
    run_serve_bench,
    slo_verdict,
    write_verdict_files,
)
from bdbnn_tpu_torch.serve.pool import (
    DEFAULT_MODEL,
    PoolAdmin,
    Replica,
    ReplicaPool,
    ResidentModelCache,
    make_engine_runner_factory,
    resident_block,
    single_engine_resident_block,
)
from bdbnn_tpu_torch.serve.registry import (
    ArtifactRegistry,
    looks_like_version,
    parse_version,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DEFAULT_MODEL",
    "PREDICT_PATH",
    "SCENARIOS",
    "VERDICT_NAME",
    "VERDICT_SCHEMA_VERSION",
    "AdmissionController",
    "ArtifactRegistry",
    "Arrival",
    "CanaryConfig",
    "CanaryMonitor",
    "HttpFrontEnd",
    "HttpLoadGenerator",
    "InferenceEngine",
    "LoadGenerator",
    "LoadShedError",
    "MicroBatcher",
    "PoolAdmin",
    "Replica",
    "ReplicaPool",
    "ResidentModelCache",
    "ServeBenchConfig",
    "ServeHttpConfig",
    "TokenBucket",
    "apply_canary_overrides",
    "assign_canary",
    "build_schedule",
    "evaluate_split",
    "fairness_ratio",
    "http_slo_verdict",
    "load_artifact_packed",
    "load_artifact_variables",
    "looks_like_version",
    "make_engine_runner_factory",
    "max_abs_logit_drift",
    "parse_quota",
    "parse_tenant_quotas",
    "parse_version",
    "percentile",
    "read_artifact",
    "resident_block",
    "run_serve_bench",
    "run_serve_http",
    "single_engine_resident_block",
    "slo_verdict",
    "write_artifact",
    "write_verdict_files",
]

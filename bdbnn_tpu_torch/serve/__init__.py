"""Serving: export artifacts, the bucketed inference engine, the
``serve-bench`` stack — micro-batcher, replica pool, load generator and
SLO verdict — and the ``serve-http`` front end with its admission
control, artifact registry, scenario load generator and rollouts
(blue/green swap, canary, shadow), and the ``serve-fleet`` router in front
of several ``serve-http`` hosts.

The names below are imported on first use, so a process that needs only
part of the package loads only that part: the fleet router imports its
own modules and the HTTP wire helpers, never the engine or torch.
"""

from __future__ import annotations

import importlib

# each public name and the module that defines it, imported on first use
_EXPORTS = {
    "AdmissionController": "bdbnn_tpu_torch.serve.admission",
    "TokenBucket": "bdbnn_tpu_torch.serve.admission",
    "parse_quota": "bdbnn_tpu_torch.serve.admission",
    "parse_tenant_quotas": "bdbnn_tpu_torch.serve.admission",
    "LoadShedError": "bdbnn_tpu_torch.serve.batching",
    "MicroBatcher": "bdbnn_tpu_torch.serve.batching",
    "CanaryConfig": "bdbnn_tpu_torch.serve.canary",
    "CanaryMonitor": "bdbnn_tpu_torch.serve.canary",
    "apply_canary_overrides": "bdbnn_tpu_torch.serve.canary",
    "assign_canary": "bdbnn_tpu_torch.serve.canary",
    "ServeBenchConfig": "bdbnn_tpu_torch.serve.config",
    "ServeFleetConfig": "bdbnn_tpu_torch.serve.config",
    "ServeHttpConfig": "bdbnn_tpu_torch.serve.config",
    "DEFAULT_BUCKETS": "bdbnn_tpu_torch.serve.engine",
    "InferenceEngine": "bdbnn_tpu_torch.serve.engine",
    "evaluate_split": "bdbnn_tpu_torch.serve.engine",
    "max_abs_logit_drift": "bdbnn_tpu_torch.serve.engine",
    "load_artifact_packed": "bdbnn_tpu_torch.serve.export",
    "load_artifact_variables": "bdbnn_tpu_torch.serve.export",
    "read_artifact": "bdbnn_tpu_torch.serve.export",
    "write_artifact": "bdbnn_tpu_torch.serve.export",
    "FleetRouter": "bdbnn_tpu_torch.serve.fleet",
    "RETRY_CAUSES": "bdbnn_tpu_torch.serve.fleet",
    "backoff_s": "bdbnn_tpu_torch.serve.fleet",
    "fleet_slo_verdict": "bdbnn_tpu_torch.serve.fleet",
    "parse_hosts": "bdbnn_tpu_torch.serve.fleet",
    "run_serve_fleet": "bdbnn_tpu_torch.serve.fleet",
    "HttpFrontEnd": "bdbnn_tpu_torch.serve.http",
    "PREDICT_PATH": "bdbnn_tpu_torch.serve.http",
    "run_serve_http": "bdbnn_tpu_torch.serve.http",
    "Arrival": "bdbnn_tpu_torch.serve.loadgen",
    "HttpLoadGenerator": "bdbnn_tpu_torch.serve.loadgen",
    "LoadGenerator": "bdbnn_tpu_torch.serve.loadgen",
    "SCENARIOS": "bdbnn_tpu_torch.serve.loadgen",
    "VERDICT_NAME": "bdbnn_tpu_torch.serve.loadgen",
    "VERDICT_SCHEMA_VERSION": "bdbnn_tpu_torch.serve.loadgen",
    "build_schedule": "bdbnn_tpu_torch.serve.loadgen",
    "fairness_ratio": "bdbnn_tpu_torch.serve.loadgen",
    "http_slo_verdict": "bdbnn_tpu_torch.serve.loadgen",
    "percentile": "bdbnn_tpu_torch.serve.loadgen",
    "run_serve_bench": "bdbnn_tpu_torch.serve.loadgen",
    "slo_verdict": "bdbnn_tpu_torch.serve.loadgen",
    "write_verdict_files": "bdbnn_tpu_torch.serve.loadgen",
    "DEFAULT_MODEL": "bdbnn_tpu_torch.serve.pool",
    "PoolAdmin": "bdbnn_tpu_torch.serve.pool",
    "Replica": "bdbnn_tpu_torch.serve.pool",
    "ReplicaPool": "bdbnn_tpu_torch.serve.pool",
    "ResidentModelCache": "bdbnn_tpu_torch.serve.pool",
    "make_engine_runner_factory": "bdbnn_tpu_torch.serve.pool",
    "resident_block": "bdbnn_tpu_torch.serve.pool",
    "single_engine_resident_block": "bdbnn_tpu_torch.serve.pool",
    "ArtifactRegistry": "bdbnn_tpu_torch.serve.registry",
    "looks_like_version": "bdbnn_tpu_torch.serve.registry",
    "parse_version": "bdbnn_tpu_torch.serve.registry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

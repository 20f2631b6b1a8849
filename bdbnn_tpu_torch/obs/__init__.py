from bdbnn_tpu_torch.obs.health import (
    DETECTORS,
    RUN_ENDING_SEVERITY,
    SEVERITIES,
    DetectorState,
    HealthConfig,
    HealthMonitor,
    apply_overrides,
)
from bdbnn_tpu_torch.obs.memory import emit_memory_event, hbm_watermark
from bdbnn_tpu_torch.obs.probes import (
    FLIP_PREFIX,
    KURT_PREFIX,
    NonFiniteLossError,
    drain_probe_report,
    nonfinite_flag,
    probe_metrics,
    probe_signs,
)
from bdbnn_tpu_torch.obs.trace import TraceCapture, find_trace_file, parse_profile_at

__all__ = [
    "DETECTORS",
    "FLIP_PREFIX",
    "KURT_PREFIX",
    "RUN_ENDING_SEVERITY",
    "SEVERITIES",
    "DetectorState",
    "HealthConfig",
    "HealthMonitor",
    "NonFiniteLossError",
    "TraceCapture",
    "apply_overrides",
    "drain_probe_report",
    "emit_memory_event",
    "find_trace_file",
    "hbm_watermark",
    "nonfinite_flag",
    "parse_profile_at",
    "probe_metrics",
    "probe_signs",
]

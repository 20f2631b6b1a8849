"""Observability: the health monitor and its detectors, the memory
watermarks, the step probes, the trace spans, profiler windows and trace
attribution, and the run-dir readers (``summarize``, ``compare``) by name;
the request tracer, the capacity plane, the roofline, ``watch``, the event
channel, the run manifest, the step and card timers (``timing``) and the
kernel launch counters (``launches``) as modules of their own.

The names below are imported on first use: a host-only process (the
fleet router) reads the capacity, trace and event modules without
loading torch."""

from __future__ import annotations

import importlib

# each public name and the module that defines it, imported on first use
_EXPORTS = {
    "DETECTORS": "bdbnn_tpu_torch.obs.health",
    "DetectorState": "bdbnn_tpu_torch.obs.health",
    "HealthConfig": "bdbnn_tpu_torch.obs.health",
    "HealthMonitor": "bdbnn_tpu_torch.obs.health",
    "RUN_ENDING_SEVERITY": "bdbnn_tpu_torch.obs.health",
    "SEVERITIES": "bdbnn_tpu_torch.obs.health",
    "apply_overrides": "bdbnn_tpu_torch.obs.health",
    "emit_memory_event": "bdbnn_tpu_torch.obs.memory",
    "hbm_watermark": "bdbnn_tpu_torch.obs.memory",
    "FLIP_PREFIX": "bdbnn_tpu_torch.obs.probes",
    "KURT_PREFIX": "bdbnn_tpu_torch.obs.probes",
    "NonFiniteLossError": "bdbnn_tpu_torch.obs.probes",
    "drain_probe_report": "bdbnn_tpu_torch.obs.probes",
    "nonfinite_flag": "bdbnn_tpu_torch.obs.probes",
    "probe_metrics": "bdbnn_tpu_torch.obs.probes",
    "probe_signs": "bdbnn_tpu_torch.obs.probes",
    "DEVICE_SPANS": "bdbnn_tpu_torch.obs.trace",
    "HOST_PHASES": "bdbnn_tpu_torch.obs.trace",
    "TraceCapture": "bdbnn_tpu_torch.obs.trace",
    "attribute_trace": "bdbnn_tpu_torch.obs.trace",
    "find_trace_file": "bdbnn_tpu_torch.obs.trace",
    "parse_profile_at": "bdbnn_tpu_torch.obs.trace",
    "span": "bdbnn_tpu_torch.obs.trace",
    "compare_runs": "bdbnn_tpu_torch.obs.compare",
    "extract_run": "bdbnn_tpu_torch.obs.compare",
    "render_comparison": "bdbnn_tpu_torch.obs.compare",
    "resolve_run_dir": "bdbnn_tpu_torch.obs.summarize",
    "summarize_run": "bdbnn_tpu_torch.obs.summarize",
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

from bdbnn_tpu_torch.obs.probes import (
    FLIP_PREFIX,
    KURT_PREFIX,
    NonFiniteLossError,
    drain_probe_report,
    nonfinite_flag,
    probe_metrics,
    probe_signs,
)

__all__ = [
    "FLIP_PREFIX",
    "KURT_PREFIX",
    "NonFiniteLossError",
    "drain_probe_report",
    "nonfinite_flag",
    "probe_metrics",
    "probe_signs",
]

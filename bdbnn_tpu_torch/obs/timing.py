"""Host-side step-phase timing of the hot loop — the port's copy of
``bdbnn_tpu/obs/timing.py``: seconds spent waiting on the input
pipeline (``data_wait``), dispatching the step (``dispatch``) and in the
one metric fetch an interval (``drain``), as ``perf_counter`` deltas
around calls the loop already makes; no device synchronisation is
added. A starved run shows ``data_wait`` dominating an interval."""

from __future__ import annotations

import time
from typing import Dict, Optional

PHASES = ("data_wait", "dispatch", "drain")


class StepPhaseTimer:
    """Accumulates per-phase host seconds between interval snapshots."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self._t_interval = time.perf_counter()
        self.compile_s: Optional[float] = None

    def add(self, phase: str, seconds: float) -> None:
        self._acc[phase] += seconds

    def record_compile(self, seconds: float) -> None:
        """The first step's seconds (first call wins), backed out of the
        dispatch accumulator and the interval wall, as the reference
        does."""
        if self.compile_s is None:
            self.compile_s = seconds
            self._acc["dispatch"] -= seconds
            self._t_interval += seconds

    def reset(self) -> None:
        """Start a fresh interval (at each epoch's first batch)."""
        self._acc = dict.fromkeys(PHASES, 0.0)
        self._t_interval = time.perf_counter()

    def snapshot(self) -> Dict[str, float]:
        """Per-phase seconds and the data-wait share since the previous
        snapshot; resets the accumulators."""
        now = time.perf_counter()
        wall = max(now - self._t_interval, 1e-9)
        out: Dict[str, float] = {f"{k}_s": round(v, 6) for k, v in self._acc.items()}
        out["interval_s"] = round(wall, 6)
        out["data_wait_share"] = round(self._acc["data_wait"] / wall, 4)
        self._acc = dict.fromkeys(PHASES, 0.0)
        self._t_interval = now
        return out


__all__ = ["PHASES", "StepPhaseTimer"]

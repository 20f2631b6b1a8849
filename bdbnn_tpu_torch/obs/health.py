"""Detector discipline of the health stack — the port's copy of
``DetectorState`` from ``bdbnn_tpu/obs/health.py`` (stdlib only).

A detector fires only after ``warmup`` observations, then only when a
breach persists for ``debounce`` consecutive observations, and then
latches (hysteresis) until it is told the signal recovered. The serving
capacity plane (obs/capacity.py) builds its per-(priority, objective)
burn-rate detectors on it. The training ``HealthMonitor`` and its
detectors wait for ROADMAP A, Later 7, which extends this file.
"""

from __future__ import annotations


class DetectorState:
    """The warmup + debounce + hysteresis state machine one detector
    runs per drain. ``update`` returns True exactly when an alert
    should fire.

    The capacity plane's burn-rate detectors (obs/capacity.py) run it
    over live request windows; the training health monitor will run the
    same machine, so "a breach must persist, then latch" means one thing
    in both stacks."""

    __slots__ = ("warmup", "debounce", "seen", "streak", "latched", "fired")

    def __init__(self, warmup: int, debounce: int) -> None:
        self.warmup = max(warmup, 0)
        self.debounce = max(debounce, 1)
        self.seen = 0
        self.streak = 0
        self.latched = False  # hysteresis: fired, waiting for recovery
        self.fired = 0

    def update(self, breach: bool, recovered: bool = False) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        if self.latched:
            if recovered:
                self.latched = False
                self.streak = 0
            return False
        if not breach:
            self.streak = 0
            return False
        self.streak += 1
        if self.streak < self.debounce:
            return False
        self.fired += 1
        self.latched = True
        self.streak = 0
        return True


__all__ = ["DetectorState"]

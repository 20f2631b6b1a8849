"""Training meters — the port's copy of ``bdbnn_tpu/utils/meters.py``.

:class:`DeviceMetrics` sums each step's metric dict on the device and
fetches the sums once per print interval (:meth:`DeviceMetrics.drain`,
the one host sync of an interval); :class:`Mean`, :class:`Throughput`
and :class:`ProgressLog` are host aggregators fed from the drained
sums."""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch


class DeviceMetrics:
    """Sums of per-step device scalars (in float64); :meth:`drain` is the
    one host sync per interval."""

    def __init__(self) -> None:
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self.pending_steps = 0
        # lifetime count of drains that fetched
        self.drain_count = 0

    def add(self, metrics: Dict[str, torch.Tensor]) -> None:
        m = {k: v.to(torch.float64) for k, v in metrics.items()}
        self._acc = m if self._acc is None else {k: self._acc[k] + v for k, v in m.items()}
        self.pending_steps += 1

    def drain(self) -> Dict[str, float]:
        if self._acc is None:
            return {}
        keys = sorted(self._acc)
        vals = torch.stack([self._acc[k] for k in keys]).cpu().tolist()
        self._acc, self.pending_steps = None, 0
        self.drain_count += 1
        return dict(zip(keys, vals))


class Mean:
    """Weighted streaming mean with a last-drained display value."""

    def __init__(self, label: str, spec: str = "{:.4f}") -> None:
        self.label = label
        self.spec = spec
        self.total = 0.0
        self.weight = 0.0
        self.last = 0.0

    def add(self, value: float, weight: float = 1.0) -> None:
        self.last = value
        self.total += value * weight
        self.weight += weight

    @property
    def mean(self) -> float:
        return self.total / self.weight if self.weight else 0.0

    def render(self) -> str:
        return f"{self.label} {self.spec.format(self.last)} (avg {self.spec.format(self.mean)})"


class Throughput:
    """Examples/s over drain intervals and cumulatively."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.mark = self.t0
        self.examples = 0.0
        self.rate = 0.0

    def tick(self, n_examples: float) -> float:
        """Record n examples since the last tick; returns the interval's rate."""
        now = time.perf_counter()
        dt = max(now - self.mark, 1e-9)
        self.mark = now
        self.examples += n_examples
        self.rate = n_examples / dt
        return self.rate

    @property
    def cumulative(self) -> float:
        return self.examples / max(time.perf_counter() - self.t0, 1e-9)


class ProgressLog:
    """Renders 'Epoch: [e][ step/total ]' lines of metric parts."""

    def __init__(self, total_steps: int, logger=None, prefix: str = "") -> None:
        self.total_steps = total_steps
        self.logger = logger
        self.prefix = prefix

    def emit(self, step: int, parts: Iterable[str]) -> str:
        width = len(str(max(self.total_steps, 1)))
        line = "\t".join([f"{self.prefix}[{step:>{width}d}/{self.total_steps}]", *parts])
        if self.logger is not None:
            self.logger.info(line)
        return line


def format_eta(remain_seconds: float) -> str:
    """Compact remaining time: '2d 03:14:07' / '03:14:07'."""
    s = max(int(remain_seconds), 0)
    days, s = divmod(s, 86400)
    hours, s = divmod(s, 3600)
    minutes, seconds = divmod(s, 60)
    hms = f"{hours:02d}:{minutes:02d}:{seconds:02d}"
    return f"{days}d {hms}" if days else hms


__all__ = ["DeviceMetrics", "Mean", "ProgressLog", "Throughput", "format_eta"]

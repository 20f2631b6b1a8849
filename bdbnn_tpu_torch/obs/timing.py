"""Host-side step-phase timing of the hot loop — the port's copy of
``bdbnn_tpu/obs/timing.py``: seconds spent waiting on the input
pipeline (``data_wait``), dispatching the step (``dispatch``) and in the
one metric fetch an interval (``drain``), as ``perf_counter`` deltas
around calls the loop already makes; no device synchronisation is
added. A starved run shows ``data_wait`` dominating an interval.

The card's timers live here too, for ``chip_smoke.py`` and the bench
scripts (``scripts/``): :func:`cuda_ms` (CUDA events around many calls)
and :func:`graph_ms` (the calls captured in one CUDA graph and replayed,
device time alone). torch loads inside them only."""

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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 10) -> float:
    """Mean device ms per call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so no host time between launches counts."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, 5, 1) / calls
    del graph
    return ms


__all__ = ["PHASES", "StepPhaseTimer", "cuda_ms", "graph_ms"]

"""Preemption tolerance: signal handling and checkpoint cadence — the
port's copy of ``bdbnn_tpu/train/resilience.py`` (stdlib only).

A scheduler reclaiming a card delivers SIGTERM and the process has
seconds to make its work durable. The policy pieces live here; what a
checkpoint holds and how it commits is
:mod:`bdbnn_tpu_torch.utils.checkpoint`.

- :class:`PreemptionHandler` latches SIGTERM / SIGINT into a flag the
  epoch loop polls at step boundaries, where the train state is
  consistent and saveable; a signal never interrupts a step.
- :class:`CheckpointPolicy` is the step-interval (``--save-every-steps``)
  and wallclock-interval (``--save-every-mins``) cadence.
- :class:`PreemptedError` + :data:`PREEMPT_EXIT_CODE`: the loop raises
  after the preemption checkpoint landed; the CLI maps it to exit code
  75 (``EX_TEMPFAIL``), which supervisors key a restart with
  ``--resume`` on.

In a data-parallel job the train loop agrees on these flags across the
ranks at every step boundary (``_Resilience._agree`` over
:func:`~bdbnn_tpu_torch.parallel.coordinate_flags`), with rank 0's clock
the only one that decides the wallclock cadence; a single process is its
own agreement.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional, Tuple

# 75 = EX_TEMPFAIL ("temporary failure; the user is invited to retry").
# Distinct from 0 (done), 1 (crash) and 128+signum (killed without
# cleanup) — a supervisor seeing 75 knows the run checkpointed itself
# and wants to be restarted with --resume.
PREEMPT_EXIT_CODE = 75


class PreemptedError(RuntimeError):
    """Raised by the train loop AFTER the preemption checkpoint landed."""

    def __init__(self, signum: int, epoch: int, step_in_epoch: int):
        self.signum = signum
        self.epoch = epoch
        self.step_in_epoch = step_in_epoch
        super().__init__(
            f"preempted by signal {signum} at epoch {epoch} step "
            f"{step_in_epoch} (mid-epoch checkpoint saved)"
        )


class PreemptionHandler:
    """Latch SIGTERM/SIGINT into a flag polled at step boundaries.

    Use as a context manager around the epoch loop; previous handlers
    are restored on exit. A SECOND SIGINT raises ``KeyboardInterrupt``
    immediately — a human hammering ctrl-C must always be able to kill
    a run that is stuck inside a save.

    Installing signal handlers is only legal from the main thread;
    elsewhere (fit() called from a worker thread) the handler degrades
    to an inert no-op with ``installed = False`` instead of crashing.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self.installed = False
        self.signum: Optional[int] = None
        self._prev: dict = {}
        self._sigint_count = 0

    @property
    def preempted(self) -> bool:
        return self.signum is not None

    def _handle(self, signum, frame):
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count > 1:
                raise KeyboardInterrupt
        self.signum = signum

    def __enter__(self) -> "PreemptionHandler":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handle)
            self.installed = True
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False
        return None


class CheckpointPolicy:
    """When to checkpoint, beyond the epoch boundary.

    ``every_steps`` triggers after N completed steps since the last
    save (deterministic across hosts); ``every_mins`` triggers once the
    wallclock interval elapses. On multi-process runs only process 0's
    clock feeds the wallclock decision (``due(clock_leader=False)`` on
    the others) and the train loop's coordination all-reduce broadcasts
    it, so pods get wallclock cadence without trusting per-host clocks.
    Either can be 0 (off); with both 0 the policy is inert (``active``
    False) and the loop skips the per-step bookkeeping entirely.
    """

    def __init__(
        self,
        every_steps: int = 0,
        every_mins: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.every_steps = max(int(every_steps), 0)
        self.every_secs = max(float(every_mins), 0.0) * 60.0
        self._clock = clock
        self._steps_since = 0
        self._last_save = clock()

    @property
    def active(self) -> bool:
        return bool(self.every_steps or self.every_secs)

    def tick(self) -> None:
        """Record one completed step."""
        self._steps_since += 1

    def due(self, clock_leader: bool = True) -> bool:
        """True when a save is due. ``clock_leader``: whether THIS
        process's wallclock may decide (process 0 on pods; the
        coordination all-reduce carries the decision to the rest)."""
        if self.every_steps and self._steps_since >= self.every_steps:
            return True
        if (
            clock_leader
            and self.every_secs
            and (self._clock() - self._last_save) >= self.every_secs
        ):
            return True
        return False

    def step(self) -> bool:
        """Record one completed step; True when a save is due (the
        single-process convenience wrapper over tick + due)."""
        self.tick()
        return self.due()

    def note_saved(self) -> None:
        """Reset both cadences (call after ANY save, incl. epoch-end)."""
        self._steps_since = 0
        self._last_save = self._clock()


__all__ = [
    "PREEMPT_EXIT_CODE",
    "CheckpointPolicy",
    "PreemptedError",
    "PreemptionHandler",
]

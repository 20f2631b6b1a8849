"""Profiler capture windows — the port's copy of the window half of
``bdbnn_tpu/obs/trace.py`` (``parse_profile_at``, ``find_trace_file``,
``TraceCapture``), on ``torch.profiler``.

A window starts and stops the profiler at arbitrary ``EPOCH:STEP[:NSTEPS]``
points (``--profile-at``, ``--profile-dir``, and the windows the health
monitor's auto-forensics schedules), records host (CPU) and device (CUDA,
where the card is there) activity, and writes one gzipped Chrome trace
where the reference's :func:`find_trace_file` looks:
``<trace_dir>/plugins/profile/<stamp>/<host>.<pid>.trace.json.gz``. The device
kernels appear in it by their ``__global__`` names.

On a card, a window opens in two steps: the profiler's device activities
are enabled first, then a burst of :data:`ABSORB_LAUNCHES` tiny kernels
runs and is waited for, and only then does the capture window start. A
profiler session can lose a prefix of its first device records (on an
H100, up to about 30 kernels of the window's first step in 3 to 4 windows
of 10, see ``chip_smoke.py --trace-prefix``); the burst takes that loss,
and runs before the capture window, so it is not in the trace.

Exception-safe: ``_stop`` clears :attr:`TraceCapture.active` before it
stops the profiler, so a raise anywhere between start and stop leads to
exactly one stop. ``torch`` is imported inside the capture methods only.
Attribution over these traces (the reference's ``attribute_trace``) is
not ported.
"""

from __future__ import annotations

import glob
import os
import socket
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Sequence, Tuple

# tiny kernels launched between enabling the device activities and
# opening the capture window (see the module docstring); 0 turns it off
ABSORB_LAUNCHES = 256


def parse_profile_at(spec: str, default_steps: int = 5) -> Tuple[int, int, int]:
    """``"EPOCH:STEP[:NSTEPS]"`` → ``(epoch, start_step, n_steps)``."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(f"bad --profile-at spec {spec!r}: want EPOCH:STEP[:NSTEPS]")
    try:
        nums = [int(p) for p in parts]
    except ValueError as e:
        raise ValueError(f"bad --profile-at spec {spec!r}: {e}") from None
    epoch, step = nums[0], nums[1]
    n_steps = nums[2] if len(nums) == 3 else default_steps
    if epoch < 0 or step < 0 or n_steps < 1:
        raise ValueError(
            f"bad --profile-at spec {spec!r}: epoch/step must be >= 0 and NSTEPS >= 1"
        )
    return epoch, step, n_steps


def find_trace_file(root: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under ``root``."""
    hits = sorted(glob.glob(os.path.join(root, "**", "*.trace.json.gz"), recursive=True))
    return hits[-1] if hits else None


class TraceCapture:
    """Profiler windows at arbitrary ``(epoch, step)`` points.

    ``_stop`` clears :attr:`active` before it stops the profiler, so a
    raise between start and stop leads to exactly one stop: the loop's
    ``finally`` calls :meth:`stop_if_active`, a no-op once a normal-path
    :meth:`maybe_stop` has run, and a failure inside the stop itself
    cannot re-enter it."""

    def __init__(self, trace_dir: str, windows: Sequence[Tuple[int, int, int]],
                 device=None) -> None:
        self.trace_dir = trace_dir
        # the training device: a CUDA one takes the absorbing burst
        self.device = device
        self._pending = sorted(windows)
        # user-requested (--profile-at) specs; unfired() reports only
        # these: a forensics window left pending (the run ended before
        # its start) is not a user error worth a warning
        self._static = set(self._pending)
        self.active: Optional[Dict[str, int]] = None
        self._prof = None

    def schedule(self, epoch: int, start_step: int, n_steps: int) -> None:
        """Add a window mid-run (auto-forensics: an alert schedules the
        next ``n_steps`` steps). Callers must target a step the loop
        will run (``start_step < steps_per_epoch``): a window opening on
        the loop's final ``maybe_start`` would trace nothing."""
        self._pending.append((int(epoch), int(start_step), max(int(n_steps), 1)))
        self._pending.sort()

    def maybe_start(self, epoch: int, step: int) -> bool:
        """Open the window scheduled at this epoch with start step
        ``<= step``, if any (``<=`` tolerates a caller that skips step
        indices). A window whose epoch is never visited or whose start
        is beyond the epoch's length cannot fire: :meth:`unfired`
        reports those."""
        if self.active is not None:
            return False
        for i, (e, s, n) in enumerate(self._pending):
            if e == epoch and step >= s:
                import torch

                del self._pending[i]
                os.makedirs(self.trace_dir, exist_ok=True)
                prof = torch.profiler.profile(
                    activities=sorted(torch.profiler.supported_activities(), key=str))
                prof.prepare_trace()
                if ABSORB_LAUNCHES and self.device is not None and self.device.type == "cuda":
                    _absorb_lost_prefix(torch, self.device)
                prof.start_trace()
                self._prof = prof
                self.active = {"epoch": epoch, "start_step": step, "steps": n}
                return True
        return False

    def unfired(self) -> List[Tuple[int, int, int]]:
        """User-requested windows still pending (dynamic forensics
        windows excluded)."""
        return [w for w in self._pending if w in self._static]

    def maybe_stop(self, epoch: int, step: int, fence=None):
        """Close the window once its step budget is traced. Returns the
        window info dict when a stop happened, else None."""
        if self.active is None:
            return None
        if step >= self.active["start_step"] + self.active["steps"] - 1:
            return self._stop(fence)
        return None

    def stop_if_active(self, fence=None, last_step: Optional[int] = None):
        """Failure / epoch-end path: flush an open window exactly once.
        ``last_step`` trims the window's reported step count when the
        epoch ended short of the budget."""
        if self.active is None:
            return None
        if last_step is not None:
            traced = max(last_step - self.active["start_step"] + 1, 1)
            self.active["steps"] = min(self.active["steps"], traced)
        return self._stop(fence)

    def annotate(self, name: str):
        """``torch.profiler.record_function(name)`` while a window is
        open (host phase attribution), else a free nullcontext."""
        if self.active is None:
            return nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def _trace_path(self) -> str:
        """``<trace_dir>/plugins/profile/<stamp>/<host>.<pid>.trace.json.gz``:
        the ranks of a job share a trace dir and a host, and may stop a
        window within one second; a second window of one process within
        one second takes the next ``<stamp>_<n>`` dir."""
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        name = f"{socket.gethostname()}.{os.getpid()}.trace.json.gz"
        n = 0
        while True:
            d = os.path.join(self.trace_dir, "plugins", "profile",
                             f"{stamp}_{n}" if n else stamp)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, name)
            if not os.path.exists(path):
                return path
            n += 1

    def _stop(self, fence) -> Dict[str, Any]:
        info = dict(self.active)
        prof, self._prof = self._prof, None
        # clear FIRST: if fence() or the stop raises, no later
        # finally-path call may stop a second time
        self.active = None
        try:
            if fence is not None:
                fence()  # the queued device work lands in the trace
        finally:
            if prof is not None:
                prof.stop()
        if prof is not None:
            prof.export_chrome_trace(self._trace_path())
        info["trace_dir"] = self.trace_dir
        return info


def _absorb_lost_prefix(torch, device) -> None:
    """ABSORB_LAUNCHES one-element adds on ``device``, waited for: the
    records a fresh profiler session may lose are these."""
    z = torch.zeros(1, device=device)
    for _ in range(ABSORB_LAUNCHES):
        z.add_(1)
    torch.cuda.synchronize(device)


__all__ = ["ABSORB_LAUNCHES", "TraceCapture", "find_trace_file", "parse_profile_at"]

"""``events.jsonl`` — the structured event channel of a run dir, the
port's copy of the reader/writer half of ``bdbnn_tpu/obs/events.py``.

One append-only JSONL stream per run dir. Each record is
``{"t": unix seconds, "kind": ..., **fields}`` with the reference's kind
names and field names, so the reference's ``summarize``, ``watch`` and
``compare`` read a port run's timeline unchanged. Kinds the port emits:

- ``run_start``   — config hash, start epoch/step, epochs, steps_per_epoch
- ``compile``     — the process's first train step, host seconds (on the
  card: the kernels' first load and launch)
- ``train_interval`` — per print interval: loss/top1/img_per_s,
  grad_norm, data_wait/dispatch/drain seconds, per-layer ``flip_rate``
  and ``kurtosis``
- ``epoch``       — epoch train means and wall seconds
- ``eval``        — acc1/acc5/loss and the example count
- ``nonfinite``   — a drained interval or an eval held non-finite losses
- ``checkpoint``  — a checkpoint committed (epoch end, interval,
  preemption), with the schedule state it froze (LR step, EDE t/k,
  kurtosis gate, the family's schedule), its seconds and bytes
- ``restore``     — a resume restored state: source dir, integrity
  verdict, ``fallback`` (``checkpoint.old`` used), what was and was not
  restored, and the schedule state it resumes with — bitwise what the
  matching ``checkpoint`` event recorded
- ``preempt``     — a preemption signal latched and the checkpoint
  landed; the process exits with code 75 next
- ``data_error``  — an undecodable image was replaced by its next
  decodable neighbour (the folder pipelines): ``index``, ``substitute``,
  ``path``, ``error``, with ``epoch`` (train) or ``where="eval"``
- ``run_end``     — best acc/epoch, total wall seconds
- ``export``      — a checkpoint was frozen into a serving artifact
  (serve/export.py), appended to the source run's timeline

:meth:`EventWriter.emit` refuses a kind not in :data:`KNOWN_KINDS`
(``ValueError``) and writes no non-finite number: :func:`jsonsafe` puts
``null`` in its place (a bare ``NaN`` token is not JSON; the
``nonfinite`` event carries the incident). ``max_bytes`` > 0 rotates
the live file into ``events.<N>.jsonl`` (``events.1.jsonl`` the oldest);
:func:`read_events` reads the segments and the live file as one
timeline.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

EVENTS_NAME = "events.jsonl"

# every event kind a port EventWriter.emit call may use
KNOWN_KINDS = frozenset(
    {
        "run_start",
        "compile",
        "train_interval",
        "epoch",
        "eval",
        "nonfinite",
        "checkpoint",
        "restore",
        "preempt",
        "data_error",
        "run_end",
        "export",
    }
)


def jsonsafe(obj: Any) -> Any:
    """Recursively coerce a payload to strict RFC-8259 values: non-finite
    floats become None, scalars with ``.item()`` (numpy, 0-d tensors)
    become Python numbers."""
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, (int, str, type(None))):
        return obj
    if isinstance(obj, dict):
        return {k: jsonsafe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonsafe(v) for v in obj]
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            unwrapped = item()
        except Exception:
            return obj
        if type(unwrapped) is not type(obj):
            return jsonsafe(unwrapped)
    return obj


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Tolerant JSONL reader: blank and torn lines are skipped."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def _rotated_segments(path: str) -> List[str]:
    """Rotated segments of ``path``, oldest first (numeric order)."""
    base, ext = os.path.splitext(path)
    d = os.path.dirname(path) or "."
    if not os.path.isdir(d):
        return []
    prefix = os.path.basename(base) + "."
    hits = []
    for name in os.listdir(d):
        if name.startswith(prefix) and name.endswith(ext):
            mid = name[len(prefix):len(name) - len(ext)]
            if mid.isdigit():
                hits.append((int(mid), os.path.join(d, name)))
    return [p for _, p in sorted(hits)]


class EventWriter:
    """Append-only, thread-safe writer of ``<log_path>/events.jsonl``
    (one json.dumps, write and flush an event)."""

    def __init__(self, log_path: str, name: str = EVENTS_NAME, max_bytes: int = 0) -> None:
        os.makedirs(log_path, exist_ok=True)
        self.path = os.path.join(log_path, name)
        self.max_bytes = max(int(max_bytes), 0)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        if kind not in KNOWN_KINDS:
            raise ValueError(f"unknown event kind {kind!r} (known: {sorted(KNOWN_KINDS)})")
        rec = jsonsafe({"t": round(time.time(), 3), "kind": kind, **fields})
        line = json.dumps(rec, allow_nan=False, default=repr) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            if self.max_bytes and self._f.tell() >= self.max_bytes:
                self._rotate()
        return rec

    def _rotate(self) -> None:
        segments = _rotated_segments(self.path)
        base, ext = os.path.splitext(self.path)
        if segments:
            last = os.path.basename(segments[-1])
            idx = int(last[len(os.path.basename(base)) + 1:len(last) - len(ext)]) + 1
        else:
            idx = 1
        self._f.close()
        os.replace(self.path, f"{base}.{idx}{ext}")
        self._f = open(self.path, "a")

    def close(self) -> None:
        """Idempotent: fit() closes on every exit path."""
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_events(run_dir: str, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """A run dir's events — rotated segments, oldest first, then the live
    file — optionally of one kind."""
    path = os.path.join(run_dir, EVENTS_NAME)
    recs: List[Dict[str, Any]] = []
    for seg in _rotated_segments(path):
        recs += read_jsonl(seg)
    recs += read_jsonl(path)
    if kind is None:
        return recs
    return [r for r in recs if r.get("kind") == kind]


__all__ = ["EVENTS_NAME", "KNOWN_KINDS", "EventWriter", "jsonsafe", "read_events", "read_jsonl"]

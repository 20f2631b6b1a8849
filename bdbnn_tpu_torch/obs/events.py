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
- ``profile``     — a profiler capture window closed (obs/trace.py):
  ``epoch``, ``start_step``, ``steps`` traced, ``trace_dir``
- ``memory``      — allocator watermark poll (obs/memory.py), by
  ``phase``: ``post_compile`` (after the first step) and ``epoch`` (at an
  epoch's end): ``available``, per-device rows, ``peak_bytes``,
  ``limit_bytes``
- ``alert``       — a health detector fired (obs/health.py): detector,
  severity (``critical`` is run-ending for ``summarize --strict``),
  epoch/step, the value against its threshold and a message; may be
  followed by auto-forensics (a ``checkpoint`` event with reason
  ``forensics`` and a ``profile`` window)
- ``health``      — run-end health summary: intervals observed, alert
  totals (overall and critical) and per-detector counts
- ``run_end``     — best acc/epoch, total wall seconds
- ``export``      — a checkpoint was frozen into a serving artifact
  (serve/export.py), appended to the source run's timeline

A ``serve-bench`` run dir (serve/loadgen.py) adds four more:

- ``serve``       — by ``phase``: ``start`` (artifact, arch, buckets,
  load mode, rate, requests, queue bound, coalescing deadline, weights
  mode; ``replicas``/``pace_ms`` on the pooled path), ``stats`` (every
  Nth batch: batch size, occupancy, queue depth, rolling p99 of the
  batch's oldest wait + run, completed, shed), ``pass`` (a single-engine
  pass ended: weights mode, packed impl, the engine's ``forwards``),
  ``scaling`` (one pooled pass of a ``--replicas`` sweep: throughput,
  completed, shed, wall seconds) and ``verdict`` (the SLO verdict's
  fields, last)
- ``rtrace``      — request-path tracing (obs/rtrace.py): ``request`` (a
  sampled request's waterfall: seq, priority, total_ms, stages) and
  ``stats`` (per-stage p99 over the rolling windows, end-to-end p99 by
  priority, the queue share, request / aborted / sampled counts)
- ``replica``     — the replica pool (serve/pool.py): ``start`` (replica
  id, device, version), ``unhealthy`` (reason, seconds stuck),
  ``restart`` (requeued and shed batches, restarts), ``monitor_error``,
  ``stats`` (the per-replica heartbeat table), ``model_load`` /
  ``model_evict`` (the resident-model cache)
- ``memory``      — phase ``serve_resident``: the bytes a weights mode
  keeps resident on its device (``resident_bytes``) against the dense
  and packed equivalents and their ``ratio``

A ``serve-http`` run dir (serve/http.py) adds three more, and its
``serve`` stats events carry ``queue_depth_by_priority``:

- ``http``        — the network front end's lifecycle, by ``phase``:
  ``start`` (bind host/port, priority classes, per-class queue bound,
  scenario), ``ready`` (warmup finished — /readyz flipped 200; per-bucket
  first-run seconds), ``stats`` (periodic live state: readiness,
  in-flight count, per-priority queue depths / completed / shed counts,
  per-tenant admission counters), ``drain`` (the SIGTERM latch fired:
  signum, preempted flag) and ``stop`` (the listener closed after the
  verdict)
- ``admission``   — per-tenant admission control (serve/admission.py):
  ``config`` (the default token-bucket quota and every per-tenant
  override) and ``summary`` (final per-tenant admitted / over-quota /
  queue-shed / completed counters at drain)
- ``capacity``    — the capacity & demand plane (obs/capacity.py), by
  ``phase``: ``stats`` (one periodic tick: windowed offered rps,
  in-flight decisions, the max per-key shed ratio, the saturation
  headroom estimate, the last utilization gauges and the per-detector
  burn-rate table), ``breach`` (a per-(priority, objective) error-budget
  detector fired with both burn windows over threshold) and
  ``recovered`` (the latched detector's fast window fell back under
  budget; the episode lands in the verdict's ``capacity`` block)

The rollouts (serve/pool.py, serve/canary.py) add three more:

- ``swap``        — a blue/green rollout, by ``phase``: ``trigger`` (the
  swap-under-load orchestration fired at a schedule position),
  ``start`` (version_from/version_to, replica count; ``canary`` true
  when the rollout runs the canary stage), ``warm`` (one standby runner
  built and warmed), ``shift`` (one replica drained its vN work and now
  serves vN+1), ``done`` (seconds, replicas shifted), ``failed`` (the
  standby build aborted — vN kept serving; the error) and
  ``rolled_back`` (the canary stage rolled the rollout back: trigger,
  seconds)
- ``canary``      — one canary episode, by ``phase``: ``start``,
  ``observing``, ``evaluate`` (the per-detector evidence table, cohort
  served counts, the running decision), ``decision`` (resolved at the
  observation budget), ``rollback`` (one canary replica restored vN) and
  ``promote``; the episode also lands in the verdict's ``canary`` block
- ``shadow``      — the logit-drift probe, phase ``mirror``: one sampled
  incumbent batch also ran on the canary, ``drift`` its max absolute
  logit difference

A ``perf`` run dir (obs/roofline.py) adds one more:

- ``perf``        — the roofline sweep, by ``phase``: ``start`` (artifact,
  arch, dataset, device_kind, buckets, impls, iters), ``bucket`` (one
  traced (impl, bucket) window: wall_ms, attributed_ms, reconciled) and
  ``verdict`` (the whole perf verdict, last)

The fleet router (serve/fleet.py, ``serve-fleet``) adds one more:

- ``fleet``       — the router's lifecycle, by ``phase``: ``start`` (bind
  host/port, the backend host set, scenario), ``ready`` (a backend probed
  ready), ``probe`` (a host's state changed: ``state_from``/``state_to``
  over warming/ready/draining/dead; steady probes emit nothing),
  ``proxy`` (a proxy attempt failed at the transport and the request is
  retried on a peer: host, cause ``connect``/``timeout``/``reset``,
  attempt), ``pull`` (the fleet swap copied a version into one host's
  registry, digest-verified), ``swap`` (``trigger``, one ``shifted`` a
  host as its own swap reaches a terminal state, then ``done`` or
  ``failed``), ``stats`` (the per-host table, the router's ``rtrace``
  windows, the scraped ``host_windows`` with staleness and the merged
  ``capacity``), ``drain`` (the SIGTERM latch fired) and ``stop`` (the
  listener closed after the verdict); the per-host ledgers land in the
  verdict's ``fleet`` block, the cross-host waterfall in its
  ``fleet_attribution`` block

The recipe-search harness (search/harness.py, ``search``) adds two:

- ``search``      — one sweep's lifecycle, by ``phase``: ``start`` /
  ``resume`` (trial count, families, worker fan-out, the sweep config
  hash the ledger pins), ``preempted`` (a SIGTERM/SIGINT was forwarded to
  every in-flight trial worker, each checkpointed and exited 75, the
  ledger recorded their cursors — the harness exits 75 next;
  ``completed`` counts the trials already done, which ``--resume`` never
  re-runs) and ``verdict`` (the final leaderboard: the ranking by
  best/final top-1, winner, time-to-common-accuracy, the per-trial
  status/attempts table — what ``compare`` judges as
  ``search_best_top1``/``search_time_to_common_acc_s`` and ``summarize``
  renders as the leaderboard section)
- ``trial``       — one trial's transitions, by ``phase``: ``start``
  (family spec, lr, attempt), ``resumed`` (a preempted trial relaunched
  with ``--resume`` against its recorded run dir), ``done`` (best/final
  top-1, wall seconds, the resolved run dir), ``preempted`` (the
  forwarded signal landed; a mid-epoch checkpoint exists),
  ``interrupted`` (the signal caught the worker before its first
  checkpoint — the attempt is lost, the trial returns to pending, not a
  failure) and ``failed`` (a nonzero exit that was not a preemption; the
  worker log has the autopsy)

The bench (scripts/bench.py) writes one more into its profile dir's
``events.jsonl``:

- ``bench_result`` — one bench line's fields after each stage of a
  measurement (the fenced rate, then the profiler window's device ms,
  then the f32 comparison): metric, value, unit, vs_baseline, images/s
  by implementation, FLOPs and MFU, the device and its peak

The static analyzer (analysis/, ``check --events-into RUN_DIR``) adds one
more:

- ``analysis``    — one ``check`` run's verdict: checkers run, files
  scanned, open and suppressed finding counts, per-checker counts and
  the open finding records, so ``summarize`` can show the last analysis
  verdict beside a run's telemetry

:meth:`EventWriter.emit` refuses a kind not in :data:`KNOWN_KINDS`
(``ValueError``) and writes no non-finite number: :func:`jsonsafe` puts
``null`` in its place (a bare ``NaN`` token is not JSON; the
``nonfinite`` event carries the incident). ``max_bytes`` > 0 rotates
the live file into ``events.<N>.jsonl`` (``events.1.jsonl`` the oldest);
:func:`read_events` reads the segments and the live file as one
timeline. :func:`serve_digest` and :func:`search_digest` (the reference's;
the harness re-exports the second) digest a timeline's serving and
recipe-search telemetry for ``summarize``, ``watch`` and ``compare``.
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
        "profile",
        "checkpoint",
        "restore",
        "preempt",
        "data_error",
        "alert",
        "health",
        "run_end",
        "export",
        "serve",
        "rtrace",
        "replica",
        "memory",
        "http",
        "admission",
        "capacity",
        "swap",
        "canary",
        "shadow",
        "fleet",
        "perf",
        "search",
        "trial",
        "analysis",
        "bench_result",
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


def serve_digest(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One shared digest of a timeline's serving telemetry — the
    ``export`` events, the ``serve`` phases (``start`` marker, the
    ``stats`` trail, the LAST ``verdict``) and the network front end's
    ``http``/``admission`` trail (serve-http runs). ``summarize``,
    ``watch`` and ``compare`` all consume serving runs through this,
    so a verdict-field change lands in one place instead of three."""
    exports = [e for e in events if e.get("kind") == "export"]
    serves = [e for e in events if e.get("kind") == "serve"]
    https = [e for e in events if e.get("kind") == "http"]
    admissions = [e for e in events if e.get("kind") == "admission"]
    replicas = [e for e in events if e.get("kind") == "replica"]
    swaps = [e for e in events if e.get("kind") == "swap"]
    rtraces = [e for e in events if e.get("kind") == "rtrace"]
    canaries = [e for e in events if e.get("kind") == "canary"]
    shadows = [e for e in events if e.get("kind") == "shadow"]
    fleets = [e for e in events if e.get("kind") == "fleet"]
    capacities = [e for e in events if e.get("kind") == "capacity"]
    return {
        "fleet_start": next(
            (e for e in fleets if e.get("phase") == "start"), None
        ),
        "fleet_stats": next(
            (
                e for e in reversed(fleets)
                if e.get("phase") == "stats"
            ),
            None,
        ),
        "fleet_probes": [
            e for e in fleets if e.get("phase") == "probe"
        ],
        "fleet_drain": next(
            (e for e in reversed(fleets) if e.get("phase") == "drain"),
            None,
        ),
        "canary_events": canaries,
        "canary_last": canaries[-1] if canaries else None,
        "canary_last_evaluate": next(
            (
                e for e in reversed(canaries)
                if e.get("phase") == "evaluate"
            ),
            None,
        ),
        "shadow_mirrors": [
            e for e in shadows if e.get("phase") == "mirror"
        ],
        "rtrace_stats": next(
            (
                e for e in reversed(rtraces)
                if e.get("phase") == "stats"
            ),
            None,
        ),
        "replica_stats": next(
            (
                e for e in reversed(replicas)
                if e.get("phase") == "stats"
            ),
            None,
        ),
        "replica_restarts": [
            e for e in replicas if e.get("phase") == "restart"
        ],
        "swap_events": swaps,
        "swap_last": swaps[-1] if swaps else None,
        "exports": exports,
        "start": next(
            (e for e in serves if e.get("phase") == "start"), None
        ),
        "stats": [e for e in serves if e.get("phase") == "stats"],
        "verdict": next(
            (e for e in reversed(serves) if e.get("phase") == "verdict"),
            None,
        ),
        "http_start": next(
            (e for e in https if e.get("phase") == "start"), None
        ),
        "http_stats": [e for e in https if e.get("phase") == "stats"],
        "http_drain": next(
            (e for e in reversed(https) if e.get("phase") == "drain"),
            None,
        ),
        "admission_config": next(
            (e for e in admissions if e.get("phase") == "config"), None
        ),
        "admission_summary": next(
            (
                e for e in reversed(admissions)
                if e.get("phase") == "summary"
            ),
            None,
        ),
        # the capacity plane (obs/capacity.py): the LAST periodic tick
        # (live headroom/burn gauges), every breach/recovery
        # transition, and the full tick trail (the headroom-over-time
        # timeline the flash-crowd acceptance reads)
        "capacity_stats": next(
            (
                e for e in reversed(capacities)
                if e.get("phase") == "stats"
            ),
            None,
        ),
        "capacity_stats_trail": [
            e for e in capacities if e.get("phase") == "stats"
        ],
        "capacity_breaches": [
            e for e in capacities if e.get("phase") == "breach"
        ],
        "capacity_recoveries": [
            e for e in capacities if e.get("phase") == "recovered"
        ],
    }


def search_digest(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One shared digest of a timeline's recipe-search telemetry (the
    reference harness's pure function; search/harness.py re-exports this
    one copy) — what ``watch`` and ``summarize`` both consume (the
    serve_digest pattern): the sweep start marker, the latest per-trial state, and
    the final verdict when one landed."""
    searches = [e for e in events if e.get("kind") == "search"]
    trials = [e for e in events if e.get("kind") == "trial"]
    latest: Dict[str, Dict[str, Any]] = {}
    for e in trials:
        tid = e.get("trial")
        if tid:
            latest[tid] = e
    best = None
    for e in trials:
        if e.get("phase") == "done" and e.get("best_top1") is not None:
            if best is None or float(e["best_top1"]) > float(
                best["best_top1"]
            ):
                best = e
    return {
        "start": next(
            (
                e for e in searches
                if e.get("phase") in ("start", "resume")
            ),
            None,
        ),
        "trial_latest": latest,
        "best_done": best,
        "preempted": next(
            (
                e for e in reversed(searches)
                if e.get("phase") == "preempted"
            ),
            None,
        ),
        "verdict": next(
            (
                e for e in reversed(searches)
                if e.get("phase") == "verdict"
            ),
            None,
        ),
    }


__all__ = ["EVENTS_NAME", "KNOWN_KINDS", "EventWriter", "jsonsafe", "read_events", "read_jsonl",
           "search_digest", "serve_digest"]

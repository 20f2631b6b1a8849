"""Replica pool: data-parallel serving, one engine per card, and the
rollouts — the port's copy of ``bdbnn_tpu/serve/pool.py``.

One engine on one card serves one card's worth of traffic. This module
fans the serving stack out: one :class:`Replica` per device (each owning
its own warmed engine, bounded work queue and worker thread) behind one
dispatcher, so the front micro-batcher's coalesced batches execute on N
cards concurrently. Four responsibilities:

1. **Dispatch** — :meth:`ReplicaPool.submit` places one coalesced batch
   on the least-loaded READY replica (queue depth + busy flag). The
   batcher already dequeued strict-priority, so batch ARRIVAL order
   preserves priority; least-loaded placement preserves it across
   replicas. Per-replica queues are bounded: when every candidate is
   full, ``submit`` raises :class:`LoadShedError` — the same explicit
   rejection contract as the front batcher, one layer down.
2. **Health** — a monitor thread watches per-replica heartbeats: a
   worker wedged in its runner past ``wedge_timeout_s`` (or a dead
   worker thread) marks the replica UNHEALTHY, its queued (unstarted)
   batches are re-dispatched to healthy peers, and a fresh worker is
   spawned (generation-tagged, so the wedged thread retires itself when
   its stuck call returns, and its in-flight batch is still ANSWERED,
   never dropped). The dispatcher routes around unhealthy replicas.
3. **Blue/green swap** — :meth:`ReplicaPool.swap` rolls the pool onto a
   new artifact version: the new version's runners are ALL built and
   warmed first (the standby set; a failed load aborts with vN still
   serving), then traffic shifts replica-by-replica (the shifting replica
   leaves the dispatch set, its accepted work finishes on vN, its runner
   pointer swaps, it rejoins serving vN+1). Every request is answered by
   exactly one version; the ledger records which
   (``completed_by_version``). With one replica, the batches assembled
   while it shifts (one batch's run) are shed. :meth:`ReplicaPool.canary_swap`
   adds a canary stage (serve/canary.py): a seeded traffic fraction routes
   to vN+1 on a replica subset, sampled incumbent batches mirror onto it
   for an exact logit-drift probe, and the live-verdict monitor decides —
   promote into the full shift, or roll back (vN restored, the registry
   untouched).
4. **Drain** — the latched-flag contract one layer down: after
   :meth:`ReplicaPool.drain` no batch enters a replica queue, every
   queued batch is executed and answered, then workers exit.

Runners are injected callables (the real path binds
:class:`bdbnn_tpu_torch.serve.engine.InferenceEngine` instances placed
on their devices via :func:`make_engine_runner_factory`; each runs on
its replica's worker thread, and the engine binds its card per call), so
the dispatcher, health and swap machinery — and their tests — need no
card. Telemetry flows through an injected ``on_event`` hook
(``replica``, ``swap``, ``canary`` and ``shadow`` events,
obs/events.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

from bdbnn_tpu_torch.obs.rtrace import set_future_answered_by, set_future_timing
from bdbnn_tpu_torch.serve.batching import LoadShedError

# replica states: dispatchable is READY only
WARMING = "warming"
READY = "ready"
SHIFTING = "shifting"  # blue/green: leaving the dispatch set to swap
UNHEALTHY = "unhealthy"
STOPPED = "stopped"

# swap states (the admin endpoint's status machine)
SWAP_IDLE = "idle"
SWAP_WARMING = "warming"
SWAP_SHIFTING = "shifting"
SWAP_DONE = "done"
SWAP_FAILED = "failed"
# the canary stage's additions (serve/canary.py): a rollout may now
# pause in an observation state and resolve to a rollback — a terminal
# state that is NOT a failure (vN kept serving by design, registry
# untouched)
SWAP_CANARY_WARMING = "canary_warming"
SWAP_CANARY = "canary"
SWAP_ROLLING_BACK = "rolling_back"
SWAP_ROLLED_BACK = "rolled_back"

# the states in which a swap is no longer in flight — the fleet
# router's host-by-host shift (serve/fleet.py) polls each host's
# /admin/swap until its state lands here before touching the NEXT
# host, so a rollout never takes two hosts out of dispatch at once.
# One source of truth: a new in-flight state added above must be
# deliberately excluded here or the fleet would shift early.
SWAP_TERMINAL_STATES = frozenset({
    SWAP_IDLE, SWAP_DONE, SWAP_FAILED, SWAP_ROLLED_BACK, "rejected",
})


class _Work:
    __slots__ = ("payloads", "future", "t_enqueue", "shadow")

    def __init__(self, payloads, shadow: bool = False):
        self.payloads = payloads
        self.future: Future = Future()
        # perf_counter, matching the request tracer's clock: the
        # dispatch-wait span (submit -> worker pickup) is handed back
        # on the batch Future (obs/rtrace.py) and must never mix clock
        # bases with the batcher's stamps
        self.t_enqueue = time.perf_counter()
        # a shadow-mirror duplicate (serve/canary.py): executed for the
        # logit-drift probe only — excluded from every serving ledger
        # (batches/completed/answered_by), or the verdict's identity
        # "answered_by sums to requests_completed" would double-count
        self.shadow = shadow


class Replica:
    """One engine's worth of serving capacity: a bounded batch queue and
    a worker thread executing ``runner(payloads) -> results`` — with a
    heartbeat (``busy_since``) the pool's health monitor reads."""

    def __init__(
        self,
        rid: int,
        runner: Callable[[List[Any]], Any],
        *,
        device: str = "",
        version: str = "v0",
        max_queue_batches: int = 8,
    ):
        self.rid = int(rid)
        self.device = str(device)
        self.version = str(version)
        self.max_queue_batches = int(max_queue_batches)
        self._runner = runner  # guarded-by: _lock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # guarded-by: _lock
        self.state = READY  # guarded-by: _lock
        # canary cohort membership (serve/canary.py): while a canary
        # stage is active the dispatcher routes the canary traffic
        # fraction to replicas with this flag set; a health restart
        # preserves it (the runner — and therefore the version — is
        # unchanged by a restart)
        self.canary = False  # guarded-by: _lock
        # monotonic timestamp of the batch currently executing (None =
        # idle) — the wedge detector's heartbeat
        self.busy_since: Optional[float] = None  # guarded-by: _lock
        # generation tag: a restart bumps it; a worker observing a
        # newer generation retires itself instead of double-consuming
        self._gen = 0  # guarded-by: _lock
        # guarded-by: _lock: version, batches, completed, restarts
        self.batches = 0
        self.completed = 0
        self.restarts = 0
        self._stopping = False  # guarded-by: _lock
        # declared guarded so the checker audits every new touch point;
        # the start_worker writes are single-writer by construction
        # (baselined with justification in analysis-baseline.txt)
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        # superseded worker threads that were still alive at restart: a
        # wedged generation may hold an accepted batch Future, and
        # stop() must wait it out (or report unclean) — dropping the
        # reference would let drain() claim clean with the Future
        # unresolved
        self._retired_threads: List[threading.Thread] = []
        self._on_done: Optional[Callable[["Replica", int, str], None]] = None
        # canary-era hooks (both skip shadow work): _on_fail records
        # engine failures per version for the error-rate detector;
        # _on_batch feeds the measured dispatch/compute split to the
        # queue-share detector (serve/canary.py)
        self._on_fail: Optional[Callable[["Replica", int, str], None]] = None
        self._on_batch: Optional[
            Callable[[str, float, float], None]
        ] = None
        self.start_worker()

    # -- worker --------------------------------------------------------

    def start_worker(self) -> None:
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._stopping = False
            # the heartbeat belongs to the NEW generation: a wedged old
            # worker's stale busy_since must not re-trip the monitor
            # (it retires itself when its stuck call returns)
            self.busy_since = None
        if self._thread is not None and self._thread.is_alive():
            self._retired_threads = [
                t for t in self._retired_threads if t.is_alive()
            ]
            self._retired_threads.append(self._thread)
        self._thread = threading.Thread(
            target=self._worker, args=(gen,),
            name=f"replica-{self.rid}", daemon=True,
        )
        self._thread.start()

    def _worker(self, gen: int) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopping and self._gen == gen:
                    self._cv.wait(timeout=0.05)
                if self._gen != gen:
                    return  # superseded by a restart
                if self._stopping and not self._q:
                    return
                work = self._q.popleft()
                self.busy_since = time.monotonic()
                # the version label this batch executes under is fixed
                # at pickup: a concurrent swap must not relabel it
                version = self.version
                runner = self._runner
            # dispatch-wait span: submit -> this pickup (replica-queue
            # time under backpressure); compute span: the engine call
            # itself. Both ride the batch Future so the front batcher
            # can attribute them per request (obs/rtrace.py).
            t_pick = time.perf_counter()
            dispatch_ms = (t_pick - work.t_enqueue) * 1000.0
            try:
                results = runner(work.payloads)
            except Exception as e:
                with self._cv:
                    if self._gen == gen:
                        self.busy_since = None
                if not work.future.done():
                    work.future.set_exception(e)
                if self._on_fail is not None and not work.shadow:
                    try:
                        self._on_fail(self, len(work.payloads), version)
                    except Exception:
                        pass  # ledger hooks must never kill a worker
                continue
            compute_ms = (time.perf_counter() - t_pick) * 1000.0
            retired = False
            with self._cv:
                if self._gen == gen:
                    self.busy_since = None
                else:
                    retired = True
                # a retiring (superseded) worker's answered batch still
                # counts: it WAS served by this replica, and the
                # per-replica table must agree with the
                # completed-by-version ledger _on_done feeds. Shadow
                # duplicates count NOWHERE: they exist only for the
                # logit-drift probe, and every serving ledger must see
                # exactly the client's requests.
                if not work.shadow:
                    self.batches += 1
                    self.completed += len(work.payloads)
            if not work.future.done():
                set_future_timing(work.future, dispatch_ms, compute_ms)
                # the version that ANSWERED rides the batch Future so
                # the front end can attribute each request to its
                # cohort (serve/canary.py) — labeled before set_result
                set_future_answered_by(work.future, version)
                work.future.set_result(results)
            if not work.shadow:
                if self._on_done is not None:
                    try:
                        self._on_done(self, len(work.payloads), version)
                    except Exception:
                        pass  # ledger hooks must never kill a worker
                if self._on_batch is not None:
                    try:
                        self._on_batch(version, dispatch_ms, compute_ms)
                    except Exception:
                        pass
            if retired:
                return  # a wedged worker's last act: answer, then exit

    # -- pool-side surface (all called under pool coordination) --------

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def load(self) -> int:
        with self._lock:
            return len(self._q) + (1 if self.busy_since is not None else 0)

    def try_enqueue(self, work: _Work) -> bool:
        with self._cv:
            if self.state != READY or self._stopping:
                return False
            if len(self._q) >= self.max_queue_batches:
                return False
            self._q.append(work)
            self._cv.notify()
            return True

    def take_queued(self) -> List[_Work]:
        """Strip the UNSTARTED queue (requeue path: unhealthy replica's
        pending work moves to healthy peers)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out

    def idle(self) -> bool:
        with self._lock:
            return not self._q and self.busy_since is None

    def worker_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wedged(self, timeout_s: float) -> bool:
        with self._lock:
            return (
                self.busy_since is not None
                and time.monotonic() - self.busy_since > timeout_s
            )

    def swap_runner(self, runner, version: str) -> None:
        with self._lock:
            self._runner = runner
            self.version = str(version)

    def stop(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        clean = True
        threads = [t for t in [self._thread] if t is not None]
        threads += self._retired_threads
        for t in threads:
            t.join(
                None if deadline is None
                else max(deadline - time.monotonic(), 0.0)
            )
            clean = clean and not t.is_alive()
        return clean

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replica": self.rid,
                "device": self.device,
                "version": self.version,
                "state": self.state,
                "canary": self.canary,
                "queue_depth": len(self._q),
                "busy": self.busy_since is not None,
                "batches": self.batches,
                "completed": self.completed,
                "restarts": self.restarts,
                "max_queue_batches": self.max_queue_batches,
            }


class ReplicaPool:
    """N replicas behind one least-loaded dispatcher, with health
    monitoring and blue/green artifact swap.

    ``runner_factory(artifact_ref, device) -> runner`` builds one
    replica's batch callable (the real factory warms an engine on that
    device — see :func:`make_engine_runner_factory`); ``devices`` names
    one replica per entry (a ``torch.device`` or an opaque label; the
    snapshots carry its string). ``on_event(kind, **fields)`` receives
    ``replica``/``swap`` telemetry when wired.
    """

    def __init__(
        self,
        runner_factory: Callable[[Any, str], Callable[[List[Any]], Any]],
        devices: Sequence[str],
        *,
        artifact_ref: Any = None,
        version: str = "v0001",
        max_queue_batches: int = 8,
        wedge_timeout_s: float = 30.0,
        health_interval_s: float = 0.25,
        on_event: Optional[Callable[..., Any]] = None,
    ):
        if not devices:
            raise ValueError("a replica pool needs at least one device")
        if max_queue_batches <= 0:
            raise ValueError("max_queue_batches must be >= 1")
        self.runner_factory = runner_factory
        self.artifact_ref = artifact_ref
        self.version = str(version)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.on_event = on_event
        self._lock = threading.Lock()
        self._draining = threading.Event()
        # two units on purpose: `shed` counts BATCHES (the thing submit
        # rejects), `shed_requests` the requests inside them — swap
        # reporting and the verdict's request ledger read the latter so
        # they never mix units with the front batcher's per-request
        # counters
        # guarded-by: _lock: shed, shed_requests, dispatched
        self.shed = 0
        self.shed_requests = 0
        self.dispatched = 0
        self.completed_by_version: Dict[str, int] = {}  # guarded-by: _lock
        self.failed_by_version: Dict[str, int] = {}  # guarded-by: _lock
        self._swap_lock = threading.Lock()
        self._swap_status: Dict[str, Any] = {"state": SWAP_IDLE}  # guarded-by: _lock
        # canary stage (serve/canary.py): non-None while a canary is
        # observing — {"seed", "fraction", "version_to", "monitor",
        # "shadow_every"}; submit snapshots it once per batch (a plain
        # attribute read — the non-canary dispatch path pays one `is
        # None` check and nothing else)
        self._canary: Optional[Dict[str, Any]] = None
        self._canary_seq = 0  # guarded-by: _lock
        self._cohort_counts: Optional[Dict[str, Dict[str, int]]] = None  # guarded-by: _lock
        # shadow comparator: mirror pairs queue + the thread that diffs
        # them OFF the hot path (a worker's done-callback only appends).
        # _shadow_queue is deliberately UNguarded: deque append/popleft
        # are atomic under the GIL and the queue is a single-producer/
        # single-consumer channel — annotating it would demand a lock
        # the hot-path callback does not need.
        self._shadow_queue: deque = deque()
        self._shadow_wake = threading.Event()
        self._shadow_stop = threading.Event()
        self._shadow_thread: Optional[threading.Thread] = None
        self._shadow_stats = {"mirrored": 0, "skipped": 0, "failed": 0}  # guarded-by: _lock
        # the factory needs the real device objects (torch.device on the
        # engine path); replica snapshots carry only the string label
        self._device_objs: List[Any] = list(devices)
        self.replicas: List[Replica] = []
        for rid, dev in enumerate(devices):
            r = Replica(
                rid,
                runner_factory(artifact_ref, dev),
                device=str(dev),
                version=self.version,
                max_queue_batches=max_queue_batches,
            )
            r._on_done = self._record_done
            r._on_fail = self._record_fail
            self.replicas.append(r)
            self._emit(
                "replica", phase="start", replica=rid, device=str(dev),
                version=self.version,
            )
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._health_loop, args=(float(health_interval_s),),
            name="replica-health", daemon=True,
        )
        self._monitor.start()

    def _emit(self, kind: str, **fields) -> None:
        if self.on_event is not None:
            try:
                self.on_event(kind, **fields)
            except Exception:
                pass  # telemetry must never take the pool down

    def _record_done(self, replica: Replica, n: int, version: str) -> None:
        with self._lock:
            self.completed_by_version[version] = (
                self.completed_by_version.get(version, 0) + n
            )

    def _record_fail(self, replica: Replica, n: int, version: str) -> None:
        with self._lock:
            self.failed_by_version[version] = (
                self.failed_by_version.get(version, 0) + n
            )
            canary = self._canary
            if canary is not None and self._cohort_counts is not None:
                cohort = (
                    "canary" if version == canary["version_to"]
                    else "incumbent"
                )
                self._cohort_counts[cohort]["failed_requests"] += n

    # -- dispatch ------------------------------------------------------

    def _place(self, work: _Work) -> Optional[bool]:
        """THE dispatch policy, shared by submit and the restart
        requeue path: least-loaded READY replica first, then the rest
        (a candidate can fill between the load read and the enqueue,
        so try in order). True = enqueued; False = every candidate
        full; None = no READY replica at all.

        During a canary stage the restart-requeue path still uses this
        cohort-less placement on purpose: a requeued batch crossing
        cohorts is answered under the version label of whoever runs it
        (the answered-by future channel), so the monitor's windows stay
        truthful either way — availability beats cohort purity for
        work that was already accepted."""
        candidates = sorted(
            (r for r in self.replicas if r.state == READY),
            key=lambda r: r.load(),
        )
        for r in candidates:
            if r.try_enqueue(work):
                return True
        return False if candidates else None

    def _place_cohort(self, work: _Work, to_canary: bool):
        """Cohort-constrained placement while a canary stage is
        active. Returns ``(placed_tristate, fallback)`` with the same
        tri-state as :meth:`_place`. A canary-assigned batch whose
        cohort cannot absorb it FALLS BACK to the incumbent — clients
        never pay for the canary machinery with a shed, the fallback
        is counted (the ``unabsorbed`` detector's evidence), and the
        request is truthfully attributed to the incumbent that
        answered it. Incumbent-assigned batches never touch canary
        replicas: the traffic fraction is the canary's blast-radius
        bound, not a hint."""
        primary = sorted(
            (
                r for r in self.replicas
                if r.state == READY and r.canary == to_canary
            ),
            key=lambda r: r.load(),
        )
        for r in primary:
            if r.try_enqueue(work):
                return True, False
        if to_canary:
            secondary = sorted(
                (
                    r for r in self.replicas
                    if r.state == READY and not r.canary
                ),
                key=lambda r: r.load(),
            )
            for r in secondary:
                if r.try_enqueue(work):
                    return True, True
        any_ready = any(r.state == READY for r in self.replicas)
        return (False if any_ready else None), False

    def submit(self, payloads: List[Any]) -> Future:
        """Place one coalesced batch on the least-loaded READY replica;
        returns the batch Future (one result list for the whole batch —
        exactly what the micro-batcher's async runner contract wants).
        Raises :class:`LoadShedError` when draining, when no replica is
        healthy, or when every healthy replica's queue is full.

        While a canary stage is active (serve/canary.py) the batch is
        first ASSIGNED a cohort — deterministic seeded draw over the
        batch sequence number, so the traffic split is reproducible —
        then placed within it (:meth:`_place_cohort`), and a sampled
        incumbent batch is additionally MIRRORED to the canary for the
        logit-drift probe (:meth:`_mirror`)."""
        if self._draining.is_set():
            with self._lock:
                self.shed += 1
                self.shed_requests += len(payloads)
            raise LoadShedError("draining")
        work = _Work(payloads)
        canary = self._canary
        if canary is None:
            placed = self._place(work)
        else:
            from bdbnn_tpu_torch.serve.canary import assign_canary

            with self._lock:
                seq = self._canary_seq
                self._canary_seq += 1
            to_canary = assign_canary(
                canary["seed"], seq, canary["fraction"]
            )
            placed, fallback = self._place_cohort(work, to_canary)
            with self._lock:
                counts = self._cohort_counts
                if counts is not None:
                    c = counts["canary" if to_canary else "incumbent"]
                    c["assigned_batches"] += 1
                    c["assigned_requests"] += len(payloads)
                    if fallback:
                        counts["canary"]["fallbacks"] += 1
                    if not placed:
                        c["sheds"] += 1
            if (
                placed
                and not to_canary
                and not fallback
                and canary.get("shadow_every", 0) > 0
            ):
                self._maybe_mirror(canary, seq, work, payloads)
        if placed:
            with self._lock:
                self.dispatched += 1
            return work.future
        with self._lock:
            self.shed += 1
            self.shed_requests += len(payloads)
        raise LoadShedError(
            "queue full" if placed is False else "no healthy replica"
        )

    # -- shadow mirroring (the logit-drift probe) ----------------------

    def _maybe_mirror(
        self, canary: Dict[str, Any], seq: int, work: _Work, payloads
    ) -> None:
        """Mirror a sampled incumbent batch onto a canary replica: the
        incumbent's answer goes to the client (its future is the one
        submit returned), the canary executes the SAME payloads as a
        shadow duplicate, and the pair lands on the comparator queue —
        the diff itself runs on the dedicated shadow thread, never a
        replica worker's."""
        from bdbnn_tpu_torch.obs.rtrace import _splitmix64

        if _splitmix64(
            (int(canary["seed"]) + 0x5AD0) ^ int(seq)
        ) % int(canary["shadow_every"]) != 0:
            return
        shadow = _Work(payloads, shadow=True)
        cands = sorted(
            (r for r in self.replicas if r.state == READY and r.canary),
            key=lambda r: r.load(),
        )
        placed = False
        for r in cands:
            if r.try_enqueue(shadow):
                placed = True
                break
        if not placed:
            # a full canary is already visible to the unabsorbed
            # detector; a skipped mirror is only a missed measurement
            with self._lock:
                self._shadow_stats["skipped"] += 1
            return
        with self._lock:
            self._shadow_stats["mirrored"] += 1
        armed: List[bool] = []

        def _arm(_f, armed=armed, work=work, shadow=shadow, seq=seq):
            if not (work.future.done() and shadow.future.done()):
                return
            with self._lock:
                if armed:
                    return  # both callbacks saw both done — once only
                armed.append(True)
            self._shadow_queue.append((seq, work.future, shadow.future))
            self._shadow_wake.set()

        work.future.add_done_callback(_arm)
        shadow.future.add_done_callback(_arm)

    def _start_shadow(self, monitor) -> None:
        # the stats pump may be snapshotting stats() concurrently with
        # a rollout arming the probe — the reset goes under the lock
        with self._lock:
            self._shadow_stats = {"mirrored": 0, "skipped": 0, "failed": 0}
        self._shadow_queue.clear()
        self._shadow_stop.clear()
        self._shadow_thread = threading.Thread(
            target=self._shadow_loop, args=(monitor,),
            name="canary-shadow", daemon=True,
        )
        self._shadow_thread.start()

    def _stop_shadow(self, timeout: float = 5.0) -> None:
        if self._shadow_thread is None:
            return
        self._shadow_stop.set()
        self._shadow_wake.set()
        self._shadow_thread.join(timeout)
        self._shadow_thread = None

    def _shadow_loop(self, monitor) -> None:
        """Drain mirror pairs and diff them — the one place logits are
        compared, off every request path. Runs until stopped AND the
        queue is empty, so in-flight mirrors at decision time still
        land their measurement."""
        from bdbnn_tpu_torch.serve.engine import max_abs_logit_drift

        while True:
            try:
                seq, primary, mirror = self._shadow_queue.popleft()
            except IndexError:
                if self._shadow_stop.is_set():
                    return
                self._shadow_wake.wait(0.05)
                self._shadow_wake.clear()
                continue
            try:
                a, b = primary.result(0), mirror.result(0)
            except Exception:
                # either side shed/failed: not a comparison
                with self._lock:
                    self._shadow_stats["failed"] += 1
                continue
            drift = max_abs_logit_drift(a, b)
            if drift is None:
                with self._lock:
                    self._shadow_stats["failed"] += 1
                continue
            monitor.record_drift(drift)
            self._emit(
                "shadow", phase="mirror", seq=seq, drift=drift,
                version_from=monitor.version_from,
                version_to=monitor.version_to,
            )

    # -- health --------------------------------------------------------

    def _health_loop(self, interval_s: float) -> None:
        while not self._monitor_stop.wait(interval_s):
            for r in self.replicas:
                try:
                    if r.state not in (READY, SHIFTING):
                        continue
                    dead = not r.worker_alive()
                    wedged = r.wedged(self.wedge_timeout_s)
                    if dead or wedged:
                        self._restart_replica(
                            r, "worker died" if dead else "wedged"
                        )
                except Exception as e:
                    # the monitor is the thing that notices broken
                    # replicas — it must never die of one; record the
                    # miss and keep watching
                    self._emit(
                        "replica", phase="monitor_error",
                        replica=r.rid, error=str(e),
                    )

    def _restart_replica(self, r: Replica, reason: str) -> None:
        if self._draining.is_set():
            # drain owns the replicas now: restarting one here would
            # resurrect a worker (start_worker resets _stopping) that
            # drain already stopped and will never join
            return
        # a SHIFTING replica stays out of the dispatch set after its
        # restart (the swap loop owns bringing it back READY) —
        # clobbering it READY would re-admit traffic to the replica the
        # shift is waiting to drain
        with r._lock:
            prior = r.state
            r.state = UNHEALTHY
            busy = r.busy_since
        self._emit(
            "replica", phase="unhealthy", replica=r.rid, device=r.device,
            version=r.version, reason=reason,
            busy_s=(
                round(time.monotonic() - busy, 3)
                if busy is not None else None
            ),
        )
        # unstarted work moves to healthy peers (the wedged batch
        # itself is answered by the retiring worker when it unsticks)
        requeued = shed = 0
        for work in r.take_queued():
            if work.shadow:
                # a queued shadow duplicate is only a probe measurement:
                # it must neither count as shed (no client sent it — the
                # zero-shed swap gate would misfire) nor requeue through
                # the cohort-less _place (executing the mirror on an
                # incumbent replica would record a vN-vs-vN diff as a
                # genuine drift measurement). Fail its future so the
                # comparator files the pair under `failed`, and move on.
                if not work.future.done():
                    work.future.set_exception(
                        LoadShedError("no healthy replica")
                    )
                continue
            placed = self._place(work)
            if placed:
                requeued += 1
            else:
                shed += 1
                with self._lock:
                    self.shed += 1
                    self.shed_requests += len(work.payloads)
                if not work.future.done():
                    # preserve _place's tri-state, same as submit():
                    # False = backpressure (every READY queue full),
                    # None = no READY replica at all — a pool outage
                    # must not be misfiled as queue-full backpressure
                    work.future.set_exception(LoadShedError(
                        "queue full" if placed is False
                        else "no healthy replica"
                    ))
        # fresh generation + worker; the old thread retires itself.
        # restarts is a counter snapshot() reads concurrently — the
        # increment takes the replica lock like every other counter
        with r._lock:
            r.restarts += 1
        r.start_worker()
        with r._lock:
            # re-read under the lock, and overwrite ONLY our own
            # UNHEALTHY mark. Any newer state is someone else's truth:
            # the swap loop marking SHIFTING (it owns the return to
            # READY), the swap loop COMPLETING the shift with READY
            # while this restart ran (restoring prior=SHIFTING over
            # that would exclude a healthy replica from dispatch
            # forever), or drain marking STOPPED.
            if r.state == UNHEALTHY:
                r.state = SHIFTING if prior == SHIFTING else READY
        self._emit(
            "replica", phase="restart", replica=r.rid, device=r.device,
            version=r.version, reason=reason, requeued=requeued,
            shed=shed, restarts=r.restarts,
        )

    # -- blue/green swap -----------------------------------------------

    def swap_status(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._swap_status)

    def _set_swap_status(self, status: Dict[str, Any]) -> None:
        with self._lock:
            self._swap_status = dict(status)

    def _warm_standbys(
        self,
        replicas: Sequence[Replica],
        new_artifact_ref: Any,
        new_version: str,
        status: Dict[str, Any],
        *,
        canary: bool = False,
    ) -> List[Callable]:
        """Build + warm one standby runner per replica BEFORE any
        traffic shifts — a failing factory marks the rollout FAILED
        with vN fully serving and re-raises (the swap contract, shared
        by the full swap and both canary phases)."""
        try:
            standby = []
            for r in replicas:
                t_w = time.monotonic()
                standby.append(
                    self.runner_factory(
                        new_artifact_ref, self._device_objs[r.rid]
                    )
                )
                self._emit(
                    "swap", phase="warm", replica=r.rid,
                    device=r.device, version_to=str(new_version),
                    seconds=round(time.monotonic() - t_w, 3),
                    canary=canary or None,
                )
            return standby
        except Exception as e:
            status.update(state=SWAP_FAILED, error=str(e))
            self._set_swap_status(status)
            self._emit(
                "swap", phase="failed", version_to=str(new_version),
                error=str(e),
            )
            raise

    def _drain_and_swap(
        self, r: Replica, runner: Callable, version: str, *,
        canary: bool,
    ) -> bool:
        """THE runner-replacement protocol, shared by the shift path
        and the canary rollback: leave the dispatch set, let accepted
        work finish (bounded by the wedge timeout), swap the runner,
        rejoin READY with the cohort flag. State writes go under the
        replica's lock (the health monitor also writes state). Returns
        the drain outcome, captured BEFORE the replica rejoins — after
        READY, peers' batches land on it and "queue empty now" no
        longer says anything about how the drain went."""
        with r._lock:
            r.state = SHIFTING
        deadline = time.monotonic() + max(self.wedge_timeout_s, 1.0)
        while not r.idle() and time.monotonic() < deadline:
            time.sleep(0.005)
        drained_clean = r.idle()
        r.swap_runner(runner, str(version))
        with r._lock:
            r.canary = canary
            r.state = READY
        return drained_clean

    def _shift_one(
        self,
        r: Replica,
        runner: Callable,
        new_version: str,
        status: Dict[str, Any],
        *,
        canary: bool = False,
    ) -> None:
        """Shift ONE replica onto ``runner`` (peers absorb the load
        meanwhile), account it in ``status`` and emit the shift event.
        ``canary`` marks the replica's cohort on rejoin."""
        drained_clean = self._drain_and_swap(
            r, runner, new_version, canary=canary
        )
        status["replicas_shifted"] = status.get("replicas_shifted", 0) + 1
        self._set_swap_status(status)
        self._emit(
            "swap", phase="shift", replica=r.rid, device=r.device,
            version_from=status.get("version_from"),
            version_to=str(new_version),
            drained_clean=drained_clean, canary=canary or None,
        )

    def swap(
        self, new_artifact_ref: Any, new_version: str
    ) -> Dict[str, Any]:
        """Roll every replica onto ``new_artifact_ref`` under live
        traffic. Blocking (run it on its own thread — the admin
        endpoint and the CLI orchestration both do); one swap at a
        time. Returns the final status dict; raises RuntimeError when a
        swap is already in progress and propagates a factory failure
        after marking the status FAILED (serving continues on vN —
        a bad artifact must never take the pool down)."""
        if not self._swap_lock.acquire(blocking=False):
            raise RuntimeError("a swap is already in progress")
        try:
            t0 = time.monotonic()
            status = {
                "state": SWAP_WARMING,
                "version_from": self.version,
                "version_to": str(new_version),
                "replicas_total": len(self.replicas),
                "replicas_shifted": 0,
            }
            with self._lock:
                self._swap_status = dict(status)
            self._emit(
                "swap", phase="start", version_from=self.version,
                version_to=str(new_version), replicas=len(self.replicas),
            )
            # 1. standby set: build + warm EVERY new runner before
            #    any traffic shifts — a failed load aborts with vN
            #    fully serving
            standby = self._warm_standbys(
                self.replicas, new_artifact_ref, new_version, status
            )
            # 2. shift traffic replica-by-replica (helper shared with
            #    the canary promote path)
            status["state"] = SWAP_SHIFTING
            self._set_swap_status(status)
            for r, runner in zip(self.replicas, standby):
                if self._draining.is_set():
                    # the pool is being torn down mid-rollout: stop
                    # shifting (drain owns the replicas now) and report
                    # the truth instead of racing restarted states
                    status.update(
                        state=SWAP_FAILED,
                        error="pool drained mid-swap",
                    )
                    self._set_swap_status(status)
                    self._emit(
                        "swap", phase="failed",
                        version_to=str(new_version),
                        error="pool drained mid-swap",
                    )
                    return dict(status)
                self._shift_one(r, runner, new_version, status)
            # 3. vN is drained (no replica runs it anymore); retire it
            old_version = self.version
            self.version = str(new_version)
            self.artifact_ref = new_artifact_ref
            status.update(
                state=SWAP_DONE, seconds=round(time.monotonic() - t0, 3)
            )
            with self._lock:
                self._swap_status = dict(status)
            self._emit(
                "swap", phase="done", version_from=old_version,
                version_to=str(new_version),
                seconds=status["seconds"],
                replicas_shifted=status["replicas_shifted"],
            )
            return dict(status)
        finally:
            self._swap_lock.release()

    # -- canary rollout (serve/canary.py) ------------------------------

    def _cohort_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            counts = self._cohort_counts or {}
            return {c: dict(v) for c, v in counts.items()}

    def _rollback_canaries(
        self,
        cans: Sequence[Replica],
        status: Dict[str, Any],
        old_ref: Any,
        old_version: str,
        old_runners: Dict[int, Callable],
    ) -> None:
        """Drain each canary replica's accepted vN+1 work, restore vN,
        rejoin. The vN runner is REBUILT through the factory when
        possible (keeps the factory's resident-cache accounting
        truthful); when the factory fails, the RETAINED vN runner
        object is restored instead — a rollback must never depend on a
        possibly-broken factory to get back to the version that was
        serving fine a minute ago. The registry is untouched either
        way."""
        for r in cans:
            try:
                runner = self.runner_factory(
                    old_ref, self._device_objs[r.rid]
                )
                restored = "rebuilt"
            except Exception:
                runner = old_runners[r.rid]
                restored = "retained"
            drained_clean = self._drain_and_swap(
                r, runner, old_version, canary=False
            )
            self._emit(
                "canary", phase="rollback", replica=r.rid,
                device=r.device, version_restored=old_version,
                runner=restored, drained_clean=drained_clean,
            )

    def canary_swap(
        self,
        new_artifact_ref: Any,
        new_version: str,
        monitor,
        *,
        fraction: float,
        canary_replicas: int = 1,
        shadow_every: int = 8,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """The self-driving rollout: :meth:`swap` extended with a
        canary stage whose live verdict decides the outcome.

        1. **warm** — standby vN+1 runners for the canary replica
           subset only (the LAST ``canary_replicas`` replicas); a
           failing factory aborts with vN fully serving.
        2. **canary** — the subset shifts to vN+1, the seeded
           ``fraction`` of batches routes to it, sampled incumbent
           batches mirror onto it for the logit-drift probe, and the
           ``monitor`` (serve/canary.py) compares the cohorts' live
           windows every ``eval_interval_s``.
        3. **decision** — ``promote``: the remaining replicas warm and
           shift exactly like :meth:`swap` and the pool retires vN;
           ``rollback``: the canary replicas drain their vN+1 work and
           restore vN — the registry untouched, the pool version
           unchanged, the episode recorded. An expired observation
           budget rolls back as ``inconclusive``.

        Blocking (run on the admin rollout thread, like swap); one
        rollout at a time. Returns the final status dict whose
        ``canary`` key is the monitor's full evidence block."""
        if not self._swap_lock.acquire(blocking=False):
            raise RuntimeError("a swap is already in progress")
        try:
            t0 = time.monotonic()
            n_can = max(int(canary_replicas), 1)
            if n_can >= len(self.replicas):
                raise ValueError(
                    "a canary needs at least one incumbent replica: "
                    f"canary_replicas={n_can} of "
                    f"{len(self.replicas)} total"
                )
            cans = list(self.replicas[-n_can:])
            rest = list(self.replicas[:-n_can])
            old_version = self.version
            old_ref = self.artifact_ref
            old_runners = {r.rid: r._runner for r in cans}
            status: Dict[str, Any] = {
                "state": SWAP_CANARY_WARMING,
                "version_from": old_version,
                "version_to": str(new_version),
                "replicas_total": len(self.replicas),
                "replicas_shifted": 0,
                "canary": None,
            }
            self._set_swap_status(status)
            self._emit(
                "swap", phase="start", version_from=old_version,
                version_to=str(new_version),
                replicas=len(self.replicas), canary=True,
            )
            self._emit(
                "canary", phase="start", version_from=old_version,
                version_to=str(new_version), fraction=float(fraction),
                replicas_canary=[r.rid for r in cans],
                shadow_every=int(shadow_every),
            )
            standby_can = self._warm_standbys(
                cans, new_artifact_ref, new_version, status, canary=True
            )
            # cohort routing activates BEFORE the subset shifts:
            # canary-assigned batches that arrive while the subset is
            # still shifting fall back to the incumbent (counted),
            # never leak unbounded traffic onto vN+1. The MONITOR is
            # armed only at observation start below — every feed from
            # the shift window (queue waits behind the draining
            # replica, fallback floods) is drain physics, not health
            # evidence, and an inactive monitor drops it.
            self._start_shadow(monitor)
            with self._lock:
                self._canary_seq = 0
                self._cohort_counts = {
                    c: {
                        "assigned_batches": 0,
                        "assigned_requests": 0,
                        "sheds": 0,
                        "fallbacks": 0,
                        "failed_requests": 0,
                    }
                    for c in ("incumbent", "canary")
                }
            for r in self.replicas:
                r._on_batch = monitor.record_batch
            self._canary = {
                "seed": int(seed),
                "fraction": float(fraction),
                "version_to": str(new_version),
                "shadow_every": int(shadow_every),
            }
            status["state"] = SWAP_CANARY
            self._set_swap_status(status)
            aborted = False
            try:
                for r, runner in zip(cans, standby_can):
                    if self._draining.is_set():
                        aborted = True
                        break
                    self._shift_one(
                        r, runner, new_version, status, canary=True
                    )
                # the observation loop: the monitor's verdict drives
                # the state machine, no human in it
                decision: Optional[Dict[str, Any]] = None
                if not aborted:
                    # observation starts HERE: zero the cohort
                    # counters and only now arm the monitor. Routing
                    # was live through the subset's shift (by design),
                    # so that window's canary-assigned batches FELL
                    # BACK mechanically and everything queued behind
                    # the draining replica carried drain-sized waits —
                    # left in, a slow subset drain would pin the
                    # unabsorbed ratio near 1.0 (or the queue-share
                    # delta near 1) and roll back a perfectly healthy
                    # canary on its own shift physics.
                    with self._lock:
                        for c in self._cohort_counts.values():
                            for k in c:
                                c[k] = 0
                    monitor.arm(
                        version_from=old_version,
                        version_to=str(new_version),
                        fraction=float(fraction),
                        replicas=[r.rid for r in cans],
                    )
                    self._emit(
                        "canary", phase="observing",
                        version_to=str(new_version),
                        eval_interval_s=monitor.cfg.eval_interval_s,
                        max_wait_s=monitor.cfg.max_wait_s,
                    )
                    deadline = time.monotonic() + monitor.cfg.max_wait_s
                    while True:
                        if self._draining.is_set():
                            aborted = True
                            break
                        res = monitor.evaluate(self._cohort_snapshot())
                        if res["decision"] != "observe":
                            decision = res
                            break
                        if time.monotonic() >= deadline:
                            decision = monitor.conclude("timeout")
                            break
                        time.sleep(monitor.cfg.eval_interval_s)
            finally:
                # cohort routing + feeds off before any resolution
                # path runs: promote/rollback shifts must dispatch
                # freely, and a teardown mid-observation must not
                # leave routing pinned to a half-rolled pool
                self._canary = None
                for r in self.replicas:
                    r._on_batch = None
                self._stop_shadow()
                monitor.disarm()
            if aborted:
                status.update(
                    state=SWAP_FAILED, error="pool drained mid-canary",
                    canary=monitor.report(dict(self._shadow_stats)),
                )
                self._set_swap_status(status)
                self._emit(
                    "swap", phase="failed", version_to=str(new_version),
                    error="pool drained mid-canary",
                )
                return dict(status)
            if decision["decision"] == "promote":
                try:
                    standby_rest = self._warm_standbys(
                        rest, new_artifact_ref, new_version, status
                    )
                except Exception:
                    # promote-warm failed with a mixed fleet: restore
                    # the canary replicas to vN so the pool is whole
                    # on the incumbent again, then report FAILED
                    self._rollback_canaries(
                        cans, status, old_ref, old_version, old_runners
                    )
                    status["canary"] = monitor.report(
                        dict(self._shadow_stats)
                    )
                    self._set_swap_status(status)
                    return dict(status)
                status["state"] = SWAP_SHIFTING
                self._set_swap_status(status)
                for r, runner in zip(rest, standby_rest):
                    if self._draining.is_set():
                        status.update(
                            state=SWAP_FAILED,
                            error="pool drained mid-swap",
                            canary=monitor.report(
                                dict(self._shadow_stats)
                            ),
                        )
                        self._set_swap_status(status)
                        self._emit(
                            "swap", phase="failed",
                            version_to=str(new_version),
                            error="pool drained mid-swap",
                        )
                        return dict(status)
                    self._shift_one(r, runner, new_version, status)
                for r in cans:
                    with r._lock:
                        r.canary = False
                self.version = str(new_version)
                self.artifact_ref = new_artifact_ref
                canary_block = monitor.report(dict(self._shadow_stats))
                canary_block["promote_s"] = round(
                    time.monotonic() - t0, 3
                )
                status.update(
                    state=SWAP_DONE,
                    seconds=round(time.monotonic() - t0, 3),
                    canary=canary_block,
                )
                self._set_swap_status(status)
                self._emit(
                    "canary", phase="promote",
                    version_from=old_version,
                    version_to=str(new_version),
                    seconds=canary_block["promote_s"],
                    evaluations=canary_block["evaluations"],
                )
                self._emit(
                    "swap", phase="done", version_from=old_version,
                    version_to=str(new_version),
                    seconds=status["seconds"],
                    replicas_shifted=status["replicas_shifted"],
                )
                return dict(status)
            # rollback (a fired detector, or inconclusive at budget)
            status["state"] = SWAP_ROLLING_BACK
            self._set_swap_status(status)
            self._rollback_canaries(
                cans, status, old_ref, old_version, old_runners
            )
            canary_block = monitor.report(dict(self._shadow_stats))
            canary_block["promote_s"] = None
            status.update(
                state=SWAP_ROLLED_BACK,
                seconds=round(time.monotonic() - t0, 3),
                canary=canary_block,
                error=None,
            )
            self._set_swap_status(status)
            self._emit(
                "swap", phase="rolled_back",
                version_from=old_version,
                version_to=str(new_version),
                trigger=canary_block["trigger"],
                seconds=status["seconds"],
            )
            return dict(status)
        finally:
            self._canary = None
            self._stop_shadow()
            self._swap_lock.release()

    # -- lifecycle / reporting -----------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Latch the drain flag (submit sheds), execute every queued
        batch, stop the workers and the health monitor. Every accepted
        Future resolves before this returns True."""
        self._draining.set()
        self._monitor_stop.set()
        self._stop_shadow()
        deadline = time.monotonic() + timeout
        clean = True
        # monitor FIRST: a restart racing the replica stops below would
        # resurrect a worker thread drain never joins (start_worker
        # resets _stopping); _restart_replica also bails on _draining,
        # so this join is bounded by one in-flight health pass
        self._monitor.join(timeout=max(deadline - time.monotonic(), 0.1))
        for r in self.replicas:
            clean = r.stop(
                timeout=max(deadline - time.monotonic(), 0.1)
            ) and clean
            # an unclean stop leaves a worker alive reading state under
            # its lock (try_enqueue) — the terminal write takes it too
            with r._lock:
                r.state = STOPPED
        # belt and braces: a worker that failed to stop in time may
        # leave queued work — answer it explicitly, never silently
        for r in self.replicas:
            for work in r.take_queued():
                clean = False
                if not work.future.done():
                    work.future.set_exception(LoadShedError("draining"))
        return clean

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            shed = self.shed
            shed_requests = self.shed_requests
            dispatched = self.dispatched
            by_version = dict(self.completed_by_version)
            failed_by_version = dict(self.failed_by_version)
            swap_status = dict(self._swap_status)
            canary = self._canary
            cohorts = (
                {c: dict(v) for c, v in self._cohort_counts.items()}
                if self._cohort_counts is not None else None
            )
            shadow = dict(self._shadow_stats)
        reps = [r.snapshot() for r in self.replicas]
        batches = sum(r["batches"] for r in reps)
        return {
            "replicas": reps,
            "n_replicas": len(reps),
            "version": self.version,
            "dispatched": dispatched,
            "shed": shed,
            "shed_requests": shed_requests,
            "batches": batches,
            "completed": sum(r["completed"] for r in reps),
            "restarts": sum(r["restarts"] for r in reps),
            "completed_by_version": by_version,
            "failed_by_version": failed_by_version,
            "swap": swap_status,
            # live canary routing state: None outside an observation
            # window; the cohort counters persist past the decision so
            # the verdict's evidence survives the teardown
            "canary_active": canary is not None,
            "cohorts": cohorts,
            "shadow": shadow,
        }


class PoolAdmin:
    """The operator surface the HTTP front end's ``/admin/*`` routes
    call into: the per-replica table, swap status, and the
    ``POST /admin/swap`` trigger — which resolves its target through
    the artifact registry (``{"version": N}``, digest-verified) or a
    raw artifact dir (``{"artifact": "/path"}``), then runs
    :meth:`ReplicaPool.swap` on its own thread so the admin request
    returns 202 immediately while the rollout proceeds under traffic.

    ``shed_counter`` (optional) is polled at swap start/end so the
    swap report can pin "shed caused during the swap window" — the
    number the zero-shed-due-to-swap acceptance gate reads.

    ``canary`` (optional) configures the self-driving rollout
    (serve/canary.py): ``{"monitor": CanaryMonitor, "fraction": f,
    "replicas": n, "shadow_every": k, "seed": s}``. When set, every
    triggered rollout runs :meth:`ReplicaPool.canary_swap` — the
    monitor's live verdict decides promote vs auto-rollback — unless
    the swap body explicitly opts out with ``{"canary": false}``.
    """

    def __init__(
        self,
        pool: ReplicaPool,
        *,
        registry: Any = None,
        shed_counter: Optional[Callable[[], int]] = None,
        canary: Optional[Dict[str, Any]] = None,
    ):
        self.pool = pool
        self.registry = registry
        self.shed_counter = shed_counter
        self.canary = canary
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._last_swap: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        # the target of an ACCEPTED start_swap, recorded before the
        # rollout thread runs: a swap still in flight (or wedged) at
        # verdict time must report an honest not-performed block, not
        # a null that skips every zero-downtime gate
        self._requested: Optional[str] = None  # guarded-by: _lock

    def replicas(self) -> Dict[str, Any]:
        return self.pool.stats()

    def swap_status(self) -> Dict[str, Any]:
        with self._lock:
            last = dict(self._last_swap) if self._last_swap else None
        return {"current": self.pool.swap_status(), "last": last}

    def resolve_target(self, spec: Dict[str, Any]):
        """``{"version": N}`` (registry, verified) or ``{"artifact":
        dir}`` -> (artifact_dir, version_label); raises KeyError /
        ValueError with operator-pointed messages."""
        if "version" in spec:
            if self.registry is None:
                raise ValueError(
                    "no --registry configured: swap by version needs one"
                )
            from bdbnn_tpu_torch.serve.registry import parse_version

            version = parse_version(spec["version"])
            return (
                self.registry.resolve(version),
                self.registry.label(version),
            )
        if "artifact" in spec:
            path = str(spec["artifact"])
            import os as _os

            if not _os.path.isdir(path):
                raise KeyError(f"artifact dir not found: {path!r}")
            return path, _os.path.basename(path.rstrip("/")) or path
        raise ValueError(
            'swap body must carry {"version": N} or {"artifact": dir}'
        )

    def start_swap(self, spec: Dict[str, Any]):
        """Returns ``(http_status, payload)``: 202 accepted, 409 when a
        swap is already running, 400/404 on a bad target. A pool of one
        replica swaps too (one card holds one replica): the batches
        assembled while it shifts are shed, and the report counts them."""
        try:
            artifact_dir, label = self.resolve_target(spec)
        except (KeyError, FileNotFoundError) as e:
            return 404, {"error": str(e)}
        except Exception as e:
            # total by design: ANY resolution failure (bad spec, digest
            # mismatch, a version dir torn after publish, ...) must
            # come back as an HTTP error — an escaped exception would
            # kill the scheduled swap-trigger thread before
            # note_request_failed runs, nulling the verdict's swap
            # block and silently skipping the zero-downtime gate
            return 400, {"error": str(e)}
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return 409, {
                    "error": "a swap is already in progress",
                    "current": self.pool.swap_status(),
                }
            shed_before = (
                self.shed_counter() if self.shed_counter else 0
            )
            self._requested = label

            canary = (
                self.canary
                if self.canary is not None
                and spec.get("canary", True) is not False
                else None
            )

            def _run():
                try:
                    if canary is not None:
                        status = self.pool.canary_swap(
                            artifact_dir,
                            label,
                            canary["monitor"],
                            fraction=canary["fraction"],
                            canary_replicas=canary.get("replicas", 1),
                            shadow_every=canary.get("shadow_every", 8),
                            seed=canary.get("seed", 0),
                        )
                    else:
                        status = self.pool.swap(artifact_dir, label)
                except Exception as e:
                    # the pool records a FULL failed status
                    # (version_from, replicas_total, ...) before
                    # re-raising — prefer it over a minimal rebuild,
                    # as long as it is THIS swap's record
                    status = self.pool.swap_status()
                    if (
                        status.get("version_to") != label
                        or status.get("state") != SWAP_FAILED
                    ):
                        status = {
                            "state": SWAP_FAILED, "version_to": label,
                        }
                    status.setdefault("error", str(e))
                shed_after = (
                    self.shed_counter() if self.shed_counter else 0
                )
                with self._lock:
                    self._last_swap = {
                        **status,
                        # every shed that happened while the swap was
                        # rolling, against any layer — the conservative
                        # upper bound on "shed caused by the swap"
                        "shed": max(shed_after - shed_before, 0),
                    }

            self._thread = threading.Thread(
                target=_run, name="pool-swap", daemon=True
            )
            self._thread.start()
        return 202, {
            "accepted": True,
            "version_to": label,
            "artifact": artifact_dir,
        }

    def note_request_failed(self, target: Any, error: Any) -> None:
        """Record a swap REQUEST that was rejected before any rollout
        could start (bad version, failed digest, missing dir) — the
        scheduled swap-under-load path calls this on a non-202 so the
        verdict reports an honest not-performed swap instead of a null
        that skips every zero-downtime gate. Never overwrites a real
        rollout's report."""
        with self._lock:
            if self._last_swap is None:
                self._requested = str(target)
                self._last_swap = {
                    "state": "rejected",
                    "version_from": self.pool.version,
                    "version_to": str(target),
                    "error": str(error),
                    "shed": 0,
                }

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join an in-flight swap (drain-time tidy-up)."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def swap_report(self) -> Optional[Dict[str, Any]]:
        """The verdict's ``swap`` block: the last completed swap's
        disposition plus the completed-by-version ledger. None only
        when no swap was ever REQUESTED — a rollout still in flight
        (or wedged) at report time yields an explicit not-performed
        block, so the zero-downtime gates fail loudly instead of
        skipping a null."""
        with self._lock:
            last = dict(self._last_swap) if self._last_swap else None
            requested = self._requested
        if last is None:
            if requested is None:
                return None
            stats = self.pool.stats()
            return {
                "performed": False,
                "state": self.pool.swap_status().get("state"),
                "version_from": None,
                "version_to": requested,
                "seconds": None,
                "replicas_shifted": None,
                "shed": None,
                "error": "swap did not complete before the report",
                "answered_by": stats["completed_by_version"],
            }
        stats = self.pool.stats()
        return {
            "performed": last.get("state") == SWAP_DONE,
            "state": last.get("state"),
            "version_from": last.get("version_from"),
            "version_to": last.get("version_to"),
            "seconds": last.get("seconds"),
            "replicas_shifted": last.get("replicas_shifted"),
            "shed": last.get("shed", 0),
            "error": last.get("error"),
            "answered_by": stats["completed_by_version"],
        }

    def canary_report(self) -> Optional[Dict[str, Any]]:
        """The verdict's nullable ``canary`` block (SLO verdict v5):
        the last rollout's canary-episode evidence, or None when no
        canary stage ever ran (plain swaps, pre-canary runs) so
        ``compare``'s canary metrics skip cleanly."""
        with self._lock:
            last = dict(self._last_swap) if self._last_swap else None
        if last is None or last.get("canary") is None:
            return None
        return dict(last["canary"])


def replica_stats_fields(ps: Dict[str, Any]) -> Dict[str, Any]:
    """The ``replica phase=stats`` event payload over a
    :meth:`ReplicaPool.stats` snapshot — one row per replica plus the
    swap state machine's position, the live heartbeat ``watch``
    renders. Shared by both serve CLIs (serve-http's pump and the
    pooled serve-bench passes) so the consumers see ONE shape."""
    return {
        "version": ps["version"],
        "completed": ps["completed"],
        "restarts": ps["restarts"],
        "completed_by_version": ps["completed_by_version"],
        "swap": ps["swap"],
        "canary_active": ps.get("canary_active", False),
        "cohorts": ps.get("cohorts"),
        "replicas": [
            {
                "replica": r["replica"],
                "device": r["device"],
                "version": r["version"],
                "state": r["state"],
                "canary": r.get("canary", False),
                "queue_depth": r["queue_depth"],
                "completed": r["completed"],
            }
            for r in ps["replicas"]
        ],
    }


class ResidentModelCache:
    """N packed artifacts co-resident on ONE replica device, with LRU
    accounting — the multi-tenant unlock the 1-bit residency buys: a
    packed resnet is ~16-32x smaller on the conv weights, so one card
    holds dozens of models, each answered without a reload in the
    request path.

    ``loader(model_key) -> engine`` builds (and warms) one model's
    engine on this replica's device; ``capacity`` bounds how many stay
    resident. ``get`` returns the resident engine, loading on first
    use and evicting the least-recently-used OTHER model when the
    cache is full (the evicted engine's device buffers free when the
    reference drops). Every load/hit/eviction is counted and each
    model's resident bytes recorded — the verdict's ``resident`` block
    and the ``memory`` serve events read :meth:`stats`.

    Thread-safe: one replica worker owns the request path, but stats
    reads and the verdict assembly may look in concurrently."""

    def __init__(
        self,
        loader: Callable[[str], Any],
        *,
        capacity: int = 1,
        device: str = "",
        on_event: Optional[Callable[..., Any]] = None,
    ):
        if capacity < 1:
            raise ValueError("resident-model capacity must be >= 1")
        self.loader = loader
        self.capacity = int(capacity)
        self.device = str(device)
        self.on_event = on_event
        self._lock = threading.Lock()
        # insertion/refresh order IS the LRU order (oldest first)
        self._engines: "dict[str, Any]" = {}  # guarded-by: _lock
        # guarded-by: _lock: hits, misses, evictions, loads,
        # guarded-by: _lock: load_seconds, resident_bytes, dense_equiv_bytes
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.loads = 0
        self.load_seconds: Dict[str, float] = {}
        self.resident_bytes: Dict[str, int] = {}
        self.dense_equiv_bytes: Dict[str, int] = {}

    def get(self, key: str):
        """The resident engine for ``key`` — loading it (and evicting
        the LRU resident if the cache is full) on first use. The load
        happens OUTSIDE the lock: a cold model warming for seconds
        must not block stats reads, and the worst double-load race
        costs one redundant build, never a wrong answer."""
        key = str(key)
        with self._lock:
            engine = self._engines.pop(key, None)
            if engine is not None:
                self._engines[key] = engine  # refresh LRU position
                self.hits += 1
                return engine
            self.misses += 1
        t0 = time.monotonic()
        engine = self.loader(key)
        load_s = round(time.monotonic() - t0, 3)
        report = self._engine_residency(engine)
        nbytes = report.get("resident_bytes") if report else None
        with self._lock:
            if key not in self._engines:
                while len(self._engines) >= self.capacity:
                    old_key = next(iter(self._engines))
                    self._engines.pop(old_key)
                    self.evictions += 1
                    # the byte accounting tracks what is resident NOW
                    # — an evicted model's row must leave with its
                    # engine, or stats()/resident_block report freed
                    # device memory as still occupied
                    evicted_bytes = self.resident_bytes.pop(
                        old_key, None
                    )
                    self.dense_equiv_bytes.pop(old_key, None)
                    self.load_seconds.pop(old_key, None)
                    self._emit(
                        "replica", phase="model_evict", device=self.device,
                        model=old_key,
                        resident_bytes=evicted_bytes,
                    )
                self._engines[key] = engine
                self.loads += 1
                self.load_seconds[key] = load_s
                if nbytes is not None:
                    self.resident_bytes[key] = nbytes
                if report and report.get("dense_equiv_bytes") is not None:
                    self.dense_equiv_bytes[key] = int(
                        report["dense_equiv_bytes"]
                    )
                self._emit(
                    "replica", phase="model_load", device=self.device,
                    model=key, seconds=load_s, resident_bytes=nbytes,
                )
            return self._engines[key]

    @staticmethod
    def _engine_residency(engine) -> Optional[Dict[str, Any]]:
        residency = getattr(engine, "residency", None)
        if callable(residency):
            try:
                return residency()
            except Exception:
                return None
        return None

    def _emit(self, kind: str, **fields) -> None:
        if self.on_event is not None:
            try:
                self.on_event(kind, **fields)
            except Exception:
                pass  # telemetry must never break the request path

    def resident_keys(self) -> List[str]:
        with self._lock:
            return list(self._engines)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "device": self.device,
                "capacity": self.capacity,
                "resident": list(self._engines),
                "hits": self.hits,
                "misses": self.misses,
                "loads": self.loads,
                "evictions": self.evictions,
                "load_seconds": dict(self.load_seconds),
                "resident_bytes": dict(self.resident_bytes),
                "dense_equiv_bytes": dict(self.dense_equiv_bytes),
            }


def resident_block(
    caches: Sequence["ResidentModelCache"],
    *,
    completed_by_model: Optional[Dict[str, int]] = None,
) -> Optional[Dict[str, Any]]:
    """The verdict's ``resident`` block over every replica's model
    cache: per-model resident bytes (max over replicas — the binding
    per-card figure), load/hit/eviction totals, and — when the front
    end tracked it — completed requests per model. None when no cache
    exists (dense single-engine serving), so pre-packed verdicts skip
    cleanly in ``compare``."""
    if not caches:
        return None
    models: Dict[str, Dict[str, Any]] = {}
    hits = misses = evictions = loads = 0

    def _row(key):
        return models.setdefault(
            key,
            {
                "resident_bytes": None,
                "dense_equiv_bytes": None,
                "completed": None,
            },
        )

    for c in caches:
        s = c.stats()
        hits += s["hits"]
        misses += s["misses"]
        evictions += s["evictions"]
        loads += s["loads"]
        for key, nbytes in s["resident_bytes"].items():
            row = _row(key)
            if nbytes is not None:
                row["resident_bytes"] = max(
                    row["resident_bytes"] or 0, int(nbytes)
                )
        for key, nbytes in s["dense_equiv_bytes"].items():
            row = _row(key)
            if nbytes is not None:
                row["dense_equiv_bytes"] = max(
                    row["dense_equiv_bytes"] or 0, int(nbytes)
                )
    for key, n in (completed_by_model or {}).items():
        _row(key)["completed"] = int(n)
    per_model = [
        b for b in (m["resident_bytes"] for m in models.values())
        if b is not None
    ]
    return {
        "capacity": max(c.capacity for c in caches),
        "replicas": len(caches),
        "models": models,
        "hits": hits,
        "misses": misses,
        "loads": loads,
        "evictions": evictions,
        "bytes_per_model_max": max(per_model) if per_model else None,
    }


def first_warm_capture():
    """``(warm_compile, on_engine)`` pair for
    :func:`make_engine_runner_factory`: records only the FIRST replica
    engine's per-bucket first-run seconds — the representative warmup
    figure both orchestrations report — without retaining any engine
    (whole engines are owned by their replicas; keeping them across a
    sweep would pin every pass's device weights alive at once)."""
    warm_compile: Dict[Any, float] = {}

    def on_engine(e, d):
        if not warm_compile:
            warm_compile.update(e.compile_seconds)

    return warm_compile, on_engine


DEFAULT_MODEL = "default"


def single_engine_resident_block(
    residency: Dict[str, Any], *, completed: Optional[int] = None
) -> Dict[str, Any]:
    """The verdict's ``resident`` block for the single-engine serving
    paths (no pool, no cache): ONE model, the engine's own
    :meth:`~bdbnn_tpu_torch.serve.engine.InferenceEngine.residency`
    report, in the shape :func:`resident_block` emits."""
    return {
        "capacity": 1,
        "replicas": 1,
        "models": {
            DEFAULT_MODEL: {
                "resident_bytes": residency["resident_bytes"],
                "dense_equiv_bytes": residency["dense_equiv_bytes"],
                "completed": completed,
            }
        },
        "hits": None,
        "misses": None,
        "loads": 1,
        "evictions": 0,
        "bytes_per_model_max": residency["resident_bytes"],
    }



def _apply_degradation(
    runner: Callable[[List[Any]], Any],
    spec: Optional[Dict[str, Any]],
    artifact_ref: Any,
    device: Any,
) -> Callable[[List[Any]], Any]:
    """Fault-injection wrapper for canary drills and tests: degrade
    ONE version's runners with injectable latency inflation, engine
    failures, or logit perturbation, leaving every other version
    untouched.

    ``spec`` keys (all optional except that at least one fault must be
    nonzero to wrap):

    - ``artifact`` — the artifact ref the degradation targets; a
      runner built for any OTHER ref is returned UNWRAPPED (the
      zero-cost-when-inactive contract: disabled means the plain
      runner object, not a pass-through shim).
    - ``latency_ms`` — sleep this long before answering a batch that
      contains a matched payload.
    - ``error_rate`` — probability (per matched batch, seeded per
      device) of raising instead of answering — an ENGINE failure,
      ledgered as failed, never as load shedding.
    - ``logit_eps`` — added to the matched rows' logits (per-row, so a
      perturbation can target a payload subset exactly) — what the
      shadow logit-drift probe exists to catch.
    - ``match`` — ``callable(payload) -> bool`` selecting payloads
      (None = every payload): a drill can mark its premium class's
      request bodies and match on the marker, so the injected
      degradation hits ONLY priority 0.
    - ``seed`` — the error-draw seed (keyed with the device label, so
      replicas degrade independently but reproducibly).
    """
    if spec is None:
        return runner
    target = spec.get("artifact")
    if target is not None and str(target) != str(artifact_ref):
        return runner
    latency_s = float(spec.get("latency_ms", 0.0)) / 1000.0
    error_rate = float(spec.get("error_rate", 0.0))
    eps = float(spec.get("logit_eps", 0.0))
    if latency_s <= 0 and error_rate <= 0 and eps == 0:
        return runner
    match = spec.get("match")
    import random as _random

    rng = _random.Random(f"{spec.get('seed', 0)}:{device}")

    def degraded(payloads: List[Any]):
        import numpy as np

        hits = [
            i for i, p in enumerate(payloads)
            if match is None or match(p)
        ]
        if hits and latency_s > 0:
            time.sleep(latency_s)
        if hits and error_rate > 0 and rng.random() < error_rate:
            raise RuntimeError(
                "injected engine failure (degradation hook)"
            )
        out = runner(payloads)
        if hits and eps:
            out = [np.asarray(x) for x in list(out)]
            for i in hits:
                out[i] = out[i] + eps
        return out

    # the marker the zero-cost pin asserts is ABSENT on undegraded
    # runners: disabled injection returns the plain runner object
    degraded.degraded = True
    return degraded


class _ForwardCount:
    """The engine forwards a runner factory's engines ran, summed over
    the replicas' worker threads (each adds its batch's forwards)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.n = 0  # guarded-by: _lock

    def add(self, n: int) -> None:
        with self._lock:
            self.n += n

    def value(self) -> int:
        return self.n


def make_engine_runner_factory(
    buckets: Sequence[int],
    *,
    pace_ms: float = 0.0,
    on_engine: Optional[Callable[[Any, Any], None]] = None,
    packed: bool = False,
    packed_impl: str = "unpack",
    resident_models: int = 1,
    model_dirs: Optional[Dict[str, str]] = None,
    on_event: Optional[Callable[..., Any]] = None,
    degrade: Optional[Dict[str, Any]] = None,
) -> Callable[[str, Any], Callable[[List[Any]], Any]]:
    """The real runner factory: ``factory(artifact_dir, device) ->
    runner`` builds an :class:`~bdbnn_tpu_torch.serve.engine.InferenceEngine`
    with its weights on that device and its buckets warmed, and returns
    its batched-predict callable.

    ``packed=True`` keeps the weights 1-bit resident (engine ``packed``
    mode, nn/packed.py). ``resident_models > 1`` puts a
    :class:`ResidentModelCache` of that capacity behind each replica:
    payloads may then be ``(model_key, image)`` tuples, and the runner
    groups each coalesced batch by model, answers every group from its
    co-resident engine, and reassembles results in arrival order.
    ``model_dirs`` maps model keys to artifact dirs (``DEFAULT_MODEL``
    falls back to the factory's own ``artifact_dir`` argument). Every
    cache built is appended to ``factory.caches`` so the orchestration
    can assemble the verdict's ``resident`` block. A blue/green swap calls
    the factory again for the same device; the retired runner's cache
    leaves the list with it. ``factory.forwards()`` counts the forwards
    of every engine the factory built, warmup included — retired and
    evicted ones too (what a kernel launch count is held against).

    ``degrade`` (fault injection, canary drills and tests only) wraps the
    runners built for ONE targeted artifact ref with
    :func:`_apply_degradation`; runners for every other ref come back
    unwrapped, so the hook costs nothing when inactive.

    ``pace_ms > 0`` swaps the engine's compute for a fixed sleep per
    batch (nothing loads): the serving-fabric bench mode. With fewer
    cards than replicas (or on the CPU) compute-bound throughput cannot
    scale with the replica count however good the dispatcher is, so
    pacing measures what the POOL adds (dispatch concurrency, queue
    isolation) with a service time that parallelizes the way a card per
    engine does."""
    import numpy as np

    pace_s = float(pace_ms) / 1000.0
    caches: List[ResidentModelCache] = []
    fw = _ForwardCount()

    def predict(engine, x):
        n0 = engine.forwards
        out = engine.predict_logits(x)
        fw.add(engine.forwards - n0)
        return out

    def factory(artifact_dir: str, device):
        if pace_s > 0:

            def paced(payloads: List[Any]):
                time.sleep(pace_s)
                return [np.zeros((1,), np.float32)] * len(payloads)

            return _apply_degradation(paced, degrade, artifact_dir, device)
        from bdbnn_tpu_torch.serve.engine import InferenceEngine

        def load_model(key: str):
            path = (model_dirs or {}).get(key)
            if path is None:
                if key != DEFAULT_MODEL:
                    raise KeyError(f"unknown model key {key!r}")
                path = artifact_dir
            engine = InferenceEngine(
                path, buckets=buckets, device=device,
                packed=packed, packed_impl=packed_impl,
            )
            fw.add(engine.forwards)  # the warmup's
            if on_engine is not None:
                on_engine(engine, device)  # warmup-seconds hook
            return engine

        cache = ResidentModelCache(
            load_model,
            capacity=max(int(resident_models), 1),
            device=str(device),
            on_event=on_event,
        )
        # one LIVE cache per device: a second build for the same device
        # replaces the old cache, which would otherwise pin its engines
        # and be aggregated into the verdict's resident block
        for stale in [c for c in caches if c.device == str(device)]:
            caches.remove(stale)
        caches.append(cache)
        cache.get(DEFAULT_MODEL)  # the default model warms eagerly

        def runner(payloads: List[Any]):
            # multi-model path: (model_key, image) tuples grouped by
            # key, each group answered by its co-resident engine, the
            # results reassembled in arrival order
            if payloads and isinstance(payloads[0], tuple):
                groups: Dict[str, List[int]] = {}
                for idx, (key, _img) in enumerate(payloads):
                    groups.setdefault(key or DEFAULT_MODEL, []).append(idx)
                results: List[Any] = [None] * len(payloads)
                for key, idxs in groups.items():
                    logits = predict(cache.get(key),
                                     np.stack([payloads[i][1] for i in idxs]))
                    for row, i in enumerate(idxs):
                        results[i] = logits[row]
                return results
            return predict(cache.get(DEFAULT_MODEL), np.stack(payloads))

        return _apply_degradation(runner, degrade, artifact_dir, device)

    factory.caches = caches
    factory.forwards = fw.value
    return factory


__all__ = [
    "DEFAULT_MODEL",
    "READY",
    "SHIFTING",
    "STOPPED",
    "SWAP_CANARY",
    "SWAP_CANARY_WARMING",
    "SWAP_DONE",
    "SWAP_FAILED",
    "SWAP_IDLE",
    "SWAP_ROLLED_BACK",
    "SWAP_ROLLING_BACK",
    "SWAP_SHIFTING",
    "SWAP_TERMINAL_STATES",
    "SWAP_WARMING",
    "UNHEALTHY",
    "WARMING",
    "PoolAdmin",
    "Replica",
    "ReplicaPool",
    "ResidentModelCache",
    "first_warm_capture",
    "make_engine_runner_factory",
    "replica_stats_fields",
    "resident_block",
    "single_engine_resident_block",
]

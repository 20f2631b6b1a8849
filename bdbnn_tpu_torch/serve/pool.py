"""Replica pool: data-parallel serving, one engine per card — the
port's copy of the ``serve-bench`` half of ``bdbnn_tpu/serve/pool.py``.

One engine on one card serves one card's worth of traffic. This module
fans the serving stack out: one :class:`Replica` per device (each owning
its own warmed engine, bounded work queue and worker thread) behind one
dispatcher, so the front micro-batcher's coalesced batches execute on N
cards concurrently. Three responsibilities:

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
3. **Drain** — the latched-flag contract one layer down: after
   :meth:`drain` no batch enters a replica queue, every queued batch is
   executed and answered, then workers exit.

Runners are injected callables (the real path binds
:class:`bdbnn_tpu_torch.serve.engine.InferenceEngine` instances placed
on their devices via :func:`make_engine_runner_factory`; each runs on
its replica's worker thread, and the engine binds its card per call), so
the dispatcher and health machinery — and their tests — need no card.
Telemetry flows through an injected ``on_event`` hook (``replica``
events, obs/events.py).

:class:`PoolAdmin` is the read half of the reference's operator surface:
the HTTP front end's ``GET /admin/replicas`` and ``GET /admin/swap``
answer from it as the reference's do before any swap. The reference
pool's blue/green ``swap``, ``canary_swap``, shadow comparator, the
write half of ``PoolAdmin`` (``start_swap``) and the fault-injection
hook wait for the rollouts (ROADMAP A, Later 12).
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
READY = "ready"
UNHEALTHY = "unhealthy"
STOPPED = "stopped"
# the swap state a pool without blue/green swap reports, in the
# reference's stats shape
SWAP_IDLE = "idle"


class _Work:
    __slots__ = ("payloads", "future", "t_enqueue")

    def __init__(self, payloads):
        self.payloads = payloads
        self.future: Future = Future()
        # perf_counter, matching the request tracer's clock: the
        # dispatch-wait span (submit -> worker pickup) is handed back
        # on the batch Future (obs/rtrace.py) and must never mix clock
        # bases with the batcher's stamps
        self.t_enqueue = time.perf_counter()


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
        self._runner = runner
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # guarded-by: _lock
        self.state = READY  # guarded-by: _lock
        # monotonic timestamp of the batch currently executing (None =
        # idle) — the wedge detector's heartbeat
        self.busy_since: Optional[float] = None  # guarded-by: _lock
        # generation tag: a restart bumps it; a worker observing a
        # newer generation retires itself instead of double-consuming
        self._gen = 0  # guarded-by: _lock
        # guarded-by: _lock: batches, completed, restarts
        self.batches = 0
        self.completed = 0
        self.restarts = 0
        self._stopping = False  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        # superseded worker threads that were still alive at restart: a
        # wedged generation may hold an accepted batch Future, and
        # stop() must wait it out (or report unclean)
        self._retired_threads: List[threading.Thread] = []
        self._on_done: Optional[Callable[["Replica", int, str], None]] = None
        self.start_worker()

    # -- worker --------------------------------------------------------

    def start_worker(self) -> None:
        with self._lock:
            self._gen += 1
            gen = self._gen
            self._stopping = False
            # the heartbeat belongs to the NEW generation: a wedged old
            # worker's stale busy_since must not re-trip the monitor
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
                continue
            compute_ms = (time.perf_counter() - t_pick) * 1000.0
            retired = False
            with self._cv:
                if self._gen == gen:
                    self.busy_since = None
                else:
                    retired = True
                # a retiring (superseded) worker's answered batch still
                # counts: it WAS served by this replica
                self.batches += 1
                self.completed += len(work.payloads)
            if not work.future.done():
                set_future_timing(work.future, dispatch_ms, compute_ms)
                set_future_answered_by(work.future, version)
                work.future.set_result(results)
            if self._on_done is not None:
                try:
                    self._on_done(self, len(work.payloads), version)
                except Exception:
                    pass  # ledger hooks must never kill a worker
            if retired:
                return  # a wedged worker's last act: answer, then exit

    # -- pool-side surface ---------------------------------------------

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

    def worker_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wedged(self, timeout_s: float) -> bool:
        with self._lock:
            return (
                self.busy_since is not None
                and time.monotonic() - self.busy_since > timeout_s
            )

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
                "queue_depth": len(self._q),
                "busy": self.busy_since is not None,
                "batches": self.batches,
                "completed": self.completed,
                "restarts": self.restarts,
                "max_queue_batches": self.max_queue_batches,
            }


class ReplicaPool:
    """N replicas behind one least-loaded dispatcher, with health
    monitoring.

    ``runner_factory(artifact_ref, device) -> runner`` builds one
    replica's batch callable (the real factory warms an engine on that
    device — see :func:`make_engine_runner_factory`); ``devices`` names
    one replica per entry (a ``torch.device`` or an opaque label; the
    snapshots carry its string). ``on_event(kind, **fields)`` receives
    ``replica`` telemetry when wired.
    """

    def __init__(
        self,
        runner_factory: Callable[[Any, Any], Callable[[List[Any]], Any]],
        devices: Sequence[Any],
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
        # rejects), `shed_requests` the requests inside them
        # guarded-by: _lock: shed, shed_requests, dispatched
        self.shed = 0
        self.shed_requests = 0
        self.dispatched = 0
        self.completed_by_version: Dict[str, int] = {}  # guarded-by: _lock
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

    # -- dispatch ------------------------------------------------------

    def _place(self, work: _Work) -> Optional[bool]:
        """THE dispatch policy, shared by submit and the restart
        requeue path: least-loaded READY replica first, then the rest
        (a candidate can fill between the load read and the enqueue,
        so try in order). True = enqueued; False = every candidate
        full; None = no READY replica at all."""
        candidates = sorted(
            (r for r in self.replicas if r.state == READY),
            key=lambda r: r.load(),
        )
        for r in candidates:
            if r.try_enqueue(work):
                return True
        return False if candidates else None

    def submit(self, payloads: List[Any]) -> Future:
        """Place one coalesced batch on the least-loaded READY replica;
        returns the batch Future (one result list for the whole batch —
        exactly what the micro-batcher's async runner contract wants).
        Raises :class:`LoadShedError` when draining, when no replica is
        healthy, or when every healthy replica's queue is full."""
        if self._draining.is_set():
            with self._lock:
                self.shed += 1
                self.shed_requests += len(payloads)
            raise LoadShedError("draining")
        work = _Work(payloads)
        placed = self._place(work)
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

    # -- health --------------------------------------------------------

    def _health_loop(self, interval_s: float) -> None:
        while not self._monitor_stop.wait(interval_s):
            for r in self.replicas:
                try:
                    if r.state != READY:
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
        with r._lock:
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
            placed = self._place(work)
            if placed:
                requeued += 1
            else:
                shed += 1
                with self._lock:
                    self.shed += 1
                    self.shed_requests += len(work.payloads)
                if not work.future.done():
                    # preserve _place's tri-state, same as submit()
                    work.future.set_exception(LoadShedError(
                        "queue full" if placed is False
                        else "no healthy replica"
                    ))
        with r._lock:
            r.restarts += 1
        r.start_worker()
        with r._lock:
            # overwrite ONLY our own UNHEALTHY mark: drain may have
            # marked the replica STOPPED while this restart ran
            if r.state == UNHEALTHY:
                r.state = READY
        self._emit(
            "replica", phase="restart", replica=r.rid, device=r.device,
            version=r.version, reason=reason, requeued=requeued,
            shed=shed, restarts=r.restarts,
        )

    # -- lifecycle / reporting -----------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Latch the drain flag (submit sheds), execute every queued
        batch, stop the workers and the health monitor. Every accepted
        Future resolves before this returns True."""
        self._draining.set()
        self._monitor_stop.set()
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
            with r._lock:
                r.state = STOPPED
        # a worker that failed to stop in time may leave queued work —
        # answer it explicitly, never silently
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
        reps = [r.snapshot() for r in self.replicas]
        return {
            "replicas": reps,
            "n_replicas": len(reps),
            "version": self.version,
            "dispatched": dispatched,
            "shed": shed,
            "shed_requests": shed_requests,
            "batches": sum(r["batches"] for r in reps),
            "completed": sum(r["completed"] for r in reps),
            "restarts": sum(r["restarts"] for r in reps),
            "completed_by_version": by_version,
            "swap": self.swap_status(),
        }

    def swap_status(self) -> Dict[str, Any]:
        """The swap state machine's status, in the reference's shape: a
        pool without blue/green swap is always idle."""
        return {"state": SWAP_IDLE}


class PoolAdmin:
    """The read half of the operator surface the HTTP front end's
    ``/admin/*`` routes call into: the per-replica table
    (``GET /admin/replicas``) and the swap status (``GET /admin/swap``),
    answered as the reference's ``PoolAdmin`` answers them before any
    swap. Starting a swap (``POST /admin/swap``) waits for the rollouts
    (ROADMAP A, Later 12); the front end answers it 501."""

    def __init__(self, pool: ReplicaPool):
        self.pool = pool

    def replicas(self) -> Dict[str, Any]:
        return self.pool.stats()

    def swap_status(self) -> Dict[str, Any]:
        return {"current": self.pool.swap_status(), "last": None}


def replica_stats_fields(ps: Dict[str, Any]) -> Dict[str, Any]:
    """The ``replica phase=stats`` event payload over a
    :meth:`ReplicaPool.stats` snapshot — one row per replica plus the
    swap state's position (always idle in the port), the live
    heartbeat ``watch`` renders — the reference's shape, so its
    consumers read a port run."""
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
        # forwards of the engines evicted so far (guarded-by: _lock)
        self._evicted_forwards = 0

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
                    evicted = self._engines.pop(old_key)
                    self._evicted_forwards += int(getattr(evicted, "forwards", 0))
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

    def forwards(self) -> int:
        """Forwards of every engine this cache built — the resident ones
        and the evicted ones (what a kernel launch count is held
        against)."""
        with self._lock:
            return self._evicted_forwards + sum(
                int(getattr(e, "forwards", 0)) for e in self._engines.values()
            )

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
    can assemble the verdict's ``resident`` block.

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

    def factory(artifact_dir: str, device):
        if pace_s > 0:

            def paced(payloads: List[Any]):
                time.sleep(pace_s)
                return [np.zeros((1,), np.float32)] * len(payloads)

            return paced
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
                    engine = cache.get(key)
                    logits = engine.predict_logits(
                        np.stack([payloads[i][1] for i in idxs])
                    )
                    for row, i in enumerate(idxs):
                        results[i] = logits[row]
                return results
            return cache.get(DEFAULT_MODEL).predict_logits(
                np.stack(payloads)
            )

        return runner

    factory.caches = caches
    return factory


__all__ = [
    "DEFAULT_MODEL",
    "PoolAdmin",
    "READY",
    "STOPPED",
    "SWAP_IDLE",
    "UNHEALTHY",
    "Replica",
    "ReplicaPool",
    "ResidentModelCache",
    "first_warm_capture",
    "make_engine_runner_factory",
    "replica_stats_fields",
    "resident_block",
    "single_engine_resident_block",
]

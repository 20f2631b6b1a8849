"""Dynamic micro-batching: coalesce requests, bound the queues, drain —
the port's copy of ``bdbnn_tpu/serve/batching.py`` (stdlib only).

Serving single requests through a batched engine on the card wants four
properties the naive loop lacks:

1. **Coalescing under a deadline** — single requests are batched up to
   the engine's largest bucket, but never held past ``max_delay_ms``
   from the first request's enqueue: throughput from batching, with a
   hard cap on the latency it can add.
2. **Bounded queues + load shedding** — every request queue has a fixed
   capacity; when a priority's queue is full, ``submit`` raises
   :class:`LoadShedError` IMMEDIATELY (explicit rejection the client
   can retry against) instead of growing without bound.
3. **Priority classes + strict-priority dequeue** — requests carry a
   priority (0 = most important); each class gets its OWN bounded
   queue, and the worker always drains the highest class first when
   assembling a batch.
4. **Graceful drain** — ``drain()`` latches a flag (the latched-flag
   pattern of ``train/resilience.py``'s ``PreemptionHandler``), after
   which new submits are shed but every request already accepted is
   answered before the worker exits. SIGTERM → ``drain()`` is wired by
   the ``serve-bench`` CLI through a ``PreemptionHandler``.

The engine is injected as a callable, so the batcher (and its tests)
never needs torch or a card; the runner runs on the batcher's worker
thread (the engine binds its device per call, serve/engine.py).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from bdbnn_tpu_torch.obs.rtrace import (
    pop_future_answered_by,
    pop_future_timing,
    set_future_answered_by,
)


class LoadShedError(RuntimeError):
    """The request was rejected — queue full or batcher draining."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"request shed: {reason}")


class _Request:
    __slots__ = ("payload", "priority", "future", "t_enqueue", "trace")

    def __init__(self, payload, priority: int = 0, trace=None):
        self.payload = payload
        self.priority = priority
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        # optional obs.rtrace.RequestTrace riding the request: the
        # batcher stamps its queue/coalesce/dispatch/compute stages at
        # the owning sites; None costs one attribute read per boundary
        self.trace = trace


class MicroBatcher:
    """Coalescing request batcher in front of a batch-callable engine.

    ``runner(batch_list) -> results`` receives the payloads of one
    coalesced batch and returns one result per payload (any indexable).
    A runner may instead return a ``concurrent.futures.Future``
    resolving to the results (**async dispatch** — the replica-pool
    path, serve/pool.py): the worker chains the per-request futures to
    it and immediately collects the NEXT batch, so N pool replicas
    execute batches concurrently instead of serializing behind one
    blocking runner call. Completion accounting moves to the chained
    callback; :meth:`drain` additionally waits for every dispatched
    batch to resolve, so the no-unresolved-Future guarantee holds in
    both modes. ``on_batch(stats_dict)`` (optional) fires after every
    executed batch — ``serve-bench`` uses it to emit ``serve`` events.

    ``priorities`` (default 1) sets the number of priority classes;
    ``submit(payload, priority=p)`` with ``0 <= p < priorities``
    enqueues into class p's own bounded queue (bound = ``max_queue``
    PER class). ``stats()["per_priority"]`` is the one source of truth
    for per-class occupancy — the live ``watch`` events and the SLO
    verdict read it.
    """

    def __init__(
        self,
        runner: Callable[[List[Any]], Any],
        *,
        max_batch: int = 32,
        max_queue: int = 128,
        max_delay_ms: float = 5.0,
        on_batch: Optional[Callable[[Dict[str, Any]], None]] = None,
        priorities: int = 1,
        max_pending_batches: Optional[int] = None,
    ):
        if max_batch <= 0 or max_queue <= 0:
            raise ValueError("max_batch and max_queue must be positive")
        if priorities <= 0:
            raise ValueError("priorities must be >= 1")
        if max_pending_batches is not None and max_pending_batches <= 0:
            raise ValueError("max_pending_batches must be >= 1")
        self.runner = runner
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.on_batch = on_batch
        self.priorities = int(priorities)
        # one bounded deque per priority class, 0 drained first; all
        # guarded by _lock (the Condition's lock)
        self._qs: List[deque] = [deque() for _ in range(self.priorities)]  # guarded-by: _lock
        # latched drain flag (resilience.py pattern): set once, observed
        # by the worker at batch boundaries and by submit immediately
        self._draining = threading.Event()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # set by the WORKER, under _lock, after its final queue sweep:
        # once True no request can enter a queue, so no accepted
        # Future can ever be left unresolved (see _worker/submit)
        self._dead = False  # guarded-by: _lock
        # shared counters, written by submit / the worker / settle
        # callbacks and snapshotted by stats():
        # guarded-by: _lock: shed, completed, batches, occupancy_sum,
        # guarded-by: _lock: max_queue_depth_seen, _shed_p, _completed_p,
        # guarded-by: _lock: _max_depth_p, _occupancy_sum_p
        self.shed = 0
        self.completed = 0
        self.batches = 0
        self.occupancy_sum = 0.0
        self.max_queue_depth_seen = 0
        # per-priority counters, index = priority class
        self._shed_p = [0] * self.priorities
        self._completed_p = [0] * self.priorities
        self._max_depth_p = [0] * self.priorities
        self._occupancy_sum_p = [0.0] * self.priorities
        # async-dispatched batches (runner returned a Future) not yet
        # resolved — drain() waits for this to hit zero.
        # max_pending_batches is the async-mode BACKPRESSURE bound: the
        # worker stops assembling new batches while this many are
        # outstanding, so requests wait in the per-priority FRONT
        # queues (where strict-priority dequeue still applies) instead
        # of FIFO-ing into downstream replica queues — and an overload
        # sheds at submit() like the blocking path, never by failing
        # batches that were already accepted. The pool orchestrations
        # set it to ~2x the replica count: one batch executing + one
        # queued per replica, bounding priority inversion to what is
        # already dispatched.
        self._pending_async = 0  # guarded-by: _lock
        self.max_pending_batches = max_pending_batches
        self._thread = threading.Thread(
            target=self._worker, name="micro-batcher", daemon=True
        )
        self._thread.start()

    # -- client side ---------------------------------------------------

    def submit(self, payload, priority: int = 0, trace=None) -> Future:
        """Enqueue one request into its priority class; returns its
        Future. Raises :class:`LoadShedError` when draining or that
        class's queue is full — never blocks the caller on a full
        queue; raises ``ValueError`` on an out-of-range priority (a
        malformed header must be rejected by the CALLER with a 400,
        not silently reclassified here). ``trace`` (optional,
        obs/rtrace.py) rides the request so the worker can stamp its
        queue-wait and coalesce spans at the sites that own them.

        The enqueue happens under ``_lock``, the same lock the worker's
        drain-exit holds for its final queue sweep + ``_dead`` latch: a
        request either lands before that sweep (and is answered or
        explicitly failed by it) or observes ``_dead`` and is shed here
        — an accepted Future can never be left unresolved."""
        p = int(priority)
        if not 0 <= p < self.priorities:
            raise ValueError(
                f"priority must be in [0, {self.priorities}), got {p}"
            )
        req = _Request(payload, p, trace=trace)
        with self._cv:
            if self._dead or self._draining.is_set():
                self.shed += 1
                self._shed_p[p] += 1
                raise LoadShedError("draining")
            if len(self._qs[p]) >= self.max_queue:
                self.shed += 1
                self._shed_p[p] += 1
                raise LoadShedError("queue full")
            self._qs[p].append(req)
            depth = len(self._qs[p])
            self._max_depth_p[p] = max(self._max_depth_p[p], depth)
            self.max_queue_depth_seen = max(
                self.max_queue_depth_seen, sum(len(q) for q in self._qs)
            )
            self._cv.notify()
        return req.future

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Latch the drain flag, answer every accepted request, stop the
        worker. Returns True when the worker exited within ``timeout``.
        Idempotent.

        The no-unresolved-Future guarantee is enforced by the worker's
        exit protocol (final queue sweep + ``_dead`` latch under the
        submit lock, see :meth:`_worker`), not by timing here — plus,
        in async-dispatch mode, by waiting out every batch Future the
        runner handed back (the pool resolves them as it drains)."""
        self._draining.set()
        with self._cv:
            self._cv.notify_all()  # wake a worker parked on an empty queue
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        self._thread.join(timeout)
        clean = not self._thread.is_alive()
        with self._cv:
            while self._pending_async > 0:
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            clean = clean and self._pending_async == 0
        return clean

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            batches = max(self.batches, 1)
            return {
                "completed": self.completed,
                "shed": self.shed,
                "batches": self.batches,
                "mean_occupancy": round(self.occupancy_sum / batches, 4),
                "queue_depth": sum(len(q) for q in self._qs),
                "max_queue_depth_seen": self.max_queue_depth_seen,
                # the AGGREGATE capacity the aggregate depth is bounded
                # by (per-class bound x classes) — `peak depth N of
                # bound M` must be a coherent pair in every consumer;
                # the per-class bound rides alongside
                "max_queue": self.max_queue * self.priorities,
                "max_queue_per_class": self.max_queue,
                "priorities": self.priorities,
                # the one per-class source of truth: verdict + watch +
                # /statsz all read this, never private counters
                "per_priority": [
                    {
                        "priority": p,
                        "queue_depth": len(self._qs[p]),
                        "max_queue_depth_seen": self._max_depth_p[p],
                        "completed": self._completed_p[p],
                        "shed": self._shed_p[p],
                        "mean_occupancy": round(
                            self._occupancy_sum_p[p] / batches, 4
                        ),
                    }
                    for p in range(self.priorities)
                ],
            }

    # -- worker side ---------------------------------------------------

    def _pop_highest(self) -> Optional[_Request]:  # requires-lock: _lock
        """Pop the oldest request of the HIGHEST nonempty class (strict
        priority: class 1 is only served when class 0 is empty). Caller
        holds ``_lock``."""
        for q in self._qs:
            if q:
                return q.popleft()
        return None

    def _collect(self) -> List[_Request]:
        """One coalesced batch: block for the first request (waking to
        re-check the drain flag), then gather — highest priority first —
        until the batch is full or the first request's deadline passes."""
        with self._cv:
            while True:
                first = self._pop_highest()
                if first is not None:
                    break
                if self._draining.is_set():
                    return []
                self._cv.wait(timeout=0.02)
        if first.trace is not None:
            # queue stage ends at pickup — everything since submit
            # (including any async-backpressure hold that kept the
            # worker from assembling a batch) is queue wait
            first.trace.stamp("queue")
        batch = [first]
        deadline = first.t_enqueue + self.max_delay_s
        while len(batch) < self.max_batch:
            with self._cv:
                nxt = self._pop_highest()
                if nxt is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._draining.is_set():
                        # deadline passed (or draining: flush what we
                        # have — latency over occupancy on the way out)
                        break
                    self._cv.wait(timeout=remaining)
                    nxt = self._pop_highest()
            if nxt is not None:
                if nxt.trace is not None:
                    nxt.trace.stamp("queue")
                batch.append(nxt)
            elif time.monotonic() >= deadline or self._draining.is_set():
                break
        return batch

    def _worker(self) -> None:
        while True:
            if self.max_pending_batches is not None:
                # async backpressure: hold off assembling the next batch
                # until the pool has headroom. This holds THROUGH drain
                # too — the pool keeps resolving batches, pending falls,
                # and every queued request is dispatched in (priority)
                # order rather than shed against a full replica queue.
                with self._cv:
                    while self._pending_async >= self.max_pending_batches:
                        self._cv.wait(timeout=0.02)
            batch = self._collect()
            if not batch:
                # drain exit: latch _dead and sweep stragglers ATOMICALLY
                # with respect to submit's enqueue — a request either
                # landed before this sweep (failed here, explicitly) or
                # its submit observes _dead and sheds. Futures are
                # resolved outside the lock; nothing else touches them.
                with self._cv:
                    stragglers = []
                    for q in self._qs:
                        while q:
                            stragglers.append(q.popleft())
                    self.shed += len(stragglers)
                    for req in stragglers:
                        self._shed_p[req.priority] += 1
                    self._dead = True
                for req in stragglers:
                    if not req.future.done():
                        req.future.set_exception(LoadShedError("draining"))
                return
            t0 = time.monotonic()
            for r in batch:
                if r.trace is not None:
                    # coalesce stage ends when the batch dispatches
                    r.trace.stamp("coalesce")
            try:
                results = self.runner([r.payload for r in batch])
            except Exception as e:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            if isinstance(results, Future):
                # async dispatch (replica pool): chain settlement to the
                # batch Future and collect the NEXT batch immediately —
                # this is what lets N replicas run concurrently behind
                # one front batcher
                with self._cv:
                    self._pending_async += 1

                def _chain(f: Future, batch=batch, t0=t0):
                    try:
                        exc = None if f.cancelled() else f.exception()
                        if f.cancelled() or exc is not None:
                            e = exc or LoadShedError("draining")
                            for r in batch:
                                if not r.future.done():
                                    r.future.set_exception(e)
                        else:
                            self._settle(
                                batch, f.result(), t0, time.monotonic(),
                                timing=pop_future_timing(f),
                                answered_by=pop_future_answered_by(f),
                            )
                    finally:
                        with self._cv:
                            self._pending_async -= 1
                            self._cv.notify_all()

                results.add_done_callback(_chain)
                continue
            self._settle(batch, results, t0, time.monotonic())

    def _settle(
        self, batch, results, t0: float, t1: float, timing=None,
        answered_by=None,
    ) -> None:
        """Distribute one executed batch's results and account it —
        shared by the synchronous runner path and the async-dispatch
        callback. ``timing`` is the replica pool's measured
        (dispatch_ms, compute_ms) split riding the batch Future
        (obs/rtrace.py); the sync path has no dispatch hop, so the
        whole runner wall is the compute stage. ``answered_by`` (the
        version label the replica worker attached) is relabeled onto
        every per-request future so a caller can attribute each
        request to the version that ANSWERED it."""
        # stage accounting BEFORE the futures resolve: a waiter waking
        # on set_result must observe a fully-stamped trace
        for r in batch:
            tr = r.trace
            if tr is None:
                continue
            if timing is not None:
                tr.add("dispatch", timing[0])
                tr.add("compute", timing[1])
                tr.sync()
            else:
                tr.stamp("compute")
        for i, r in enumerate(batch):
            # done() guard: a client may have cancel()ed its Future
            # (set_result would raise InvalidStateError); a runner
            # returning too few results must fail THAT future, not
            # kill the worker thread for good
            try:
                if not r.future.done():
                    if answered_by is not None:
                        # before set_result, so the waiter always
                        # observes the label (the timing-split rule)
                        set_future_answered_by(r.future, answered_by)
                    r.future.set_result(results[i])
            except Exception as e:
                if not r.future.done():
                    r.future.set_exception(e)
        with self._cv:
            per_prio_n = [0] * self.priorities
            for r in batch:
                per_prio_n[r.priority] += 1
            self.completed += len(batch)
            self.batches += 1
            self.occupancy_sum += len(batch) / self.max_batch
            for p in range(self.priorities):
                self._completed_p[p] += per_prio_n[p]
                self._occupancy_sum_p[p] += (
                    per_prio_n[p] / self.max_batch
                )
            stats = {
                "batch_size": len(batch),
                "occupancy": round(len(batch) / self.max_batch, 4),
                "queue_depth": sum(len(q) for q in self._qs),
                "queue_depth_by_priority": [
                    len(q) for q in self._qs
                ],
                "batch_by_priority": per_prio_n,
                "run_ms": round((t1 - t0) * 1000.0, 3),
                "oldest_wait_ms": round(
                    (t0 - batch[0].t_enqueue) * 1000.0, 3
                ),
                "completed": self.completed,
                "shed": self.shed,
            }
        if self.on_batch is not None:
            try:
                self.on_batch(stats)
            except Exception:
                pass  # telemetry must never kill the serving loop


__all__ = ["LoadShedError", "MicroBatcher"]

"""The in-process load generator, the SLO verdict and the
``serve-bench`` orchestration — the port's copy of the ``serve-bench``
half of ``bdbnn_tpu/serve/loadgen.py``.

- :class:`LoadGenerator` drives a submit callable closed- or open-loop:
  **closed loop** — ``concurrency`` workers each keep exactly one
  request in flight (the sustainable-throughput probe); **open loop** —
  requests arrive on a Poisson process at ``rate`` req/s regardless of
  completions, the gaps pre-drawn from ``random.Random(seed)``, so the
  offered load is deterministic per seed and an overloaded server keeps
  receiving requests (what exercises the bounded queues and shedding).
- :func:`slo_verdict` assembles the strict-JSON SLO verdict in the
  reference's schema (:data:`VERDICT_SCHEMA_VERSION`): p50/p95/p99
  latency, throughput, batch occupancy, shed rate, drain/preemption
  disposition, and the optional blocks — null where the bench gives
  none — so the reference's ``compare``, ``summarize`` and ``watch``
  read a port verdict.
- :func:`run_serve_bench` wires the stack together: engine (warmed
  buckets) → micro-batcher (bounded queue) → load generator, or the
  replica pool behind the batcher's async dispatch (``--replicas``,
  ``--pace-ms``), with a run directory (manifest + ``events.jsonl``) so
  the reference's tools see a port serving run. SIGTERM/SIGINT latch a
  ``PreemptionHandler`` flag (train/resilience.py): the generator stops
  offering load, the batcher drains, and every accepted request is
  answered before the verdict is written.

The HTTP front end's half (serve/http.py) lives here too, as in the
reference:

- :func:`build_schedule` draws a traffic-shaped arrival schedule up
  front from ``random.Random(seed)`` — ``poisson``, ``diurnal``,
  ``flash_crowd``, ``heavy_tail`` and ``slow_client`` (:data:`SCENARIOS`),
  each arrival with a priority class, a tenant and optionally a model —
  so the offered load is deterministic per seed.
- :class:`HttpLoadGenerator` replays a schedule against a live server
  over real sockets: persistent keep-alive connections, latency charged
  from the scheduled arrival, dribbled bodies for slow clients, and a
  ledger that counts every request that got no response (``dropped``).
- :func:`http_slo_verdict` builds the verdict from the front end's
  request ledger, the batcher's stats and the admission counters (the
  per-priority and per-tenant blocks and :func:`fairness_ratio`).

The engines run on the CUDA card unless the config names the CPU
(``device``); there is no fallback.
"""

from __future__ import annotations

import json
import math
import os
import random
import socket
import threading
import time
from collections import namedtuple
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher

VERDICT_NAME = "verdict.json"
# the reference's verdict schema: v1 aggregates; v2 per-priority,
# per-tenant, fairness and scenario blocks (HTTP); v3 ``replicas``,
# ``scaling``, ``swap``, ``resident`` and ``packed``; v4
# ``attribution`` (obs/rtrace.py); v5 ``canary``; v6 ``fleet``; v7
# ``fleet_attribution``; v8 ``capacity``. Every block the bench does not
# fill is null, so each consumer of an older version keeps working.
VERDICT_SCHEMA_VERSION = 8

def percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending sequence; None when
    empty (the reference's ``serve.loadgen.percentile``; the port's one
    definition, which its engine, load generators, SLO verdicts, request
    tracers and fleet router use). Nearest-rank needs no numpy, so a
    host-only process (the fleet router) computes it without it."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    if not sorted_vals:
        return None
    rank = max(int(math.ceil(q / 100.0 * len(sorted_vals))), 1)
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def _pct(vals: Sequence[float], q: float, digits: int = 3) -> Optional[float]:
    v = percentile(vals, q)
    return None if v is None else round(v, digits)


class LoadGenerator:
    """Offer load to a submit callable; collect per-request latency.

    ``submit_fn(payload) -> Future`` (the micro-batcher's ``submit``);
    ``sample_fn(i) -> payload`` supplies request payloads (cycled from a
    small pregenerated pool in serve-bench). ``stop_fn()`` polled
    between arrivals — the SIGTERM latch."""

    def __init__(
        self,
        submit_fn: Callable[[Any], Future],
        sample_fn: Callable[[int], Any],
        *,
        mode: str = "open",
        requests: int = 200,
        rate: float = 100.0,
        concurrency: int = 4,
        seed: int = 0,
        stop_fn: Callable[[], bool] = lambda: False,
    ):
        if mode not in ("open", "closed"):
            raise ValueError(f"mode must be open|closed, got {mode!r}")
        self.submit_fn = submit_fn
        self.sample_fn = sample_fn
        self.mode = mode
        self.requests = int(requests)
        self.rate = float(rate)
        self.concurrency = max(int(concurrency), 1)
        self.seed = int(seed)
        self.stop_fn = stop_fn
        self._lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.shed = 0
        self.failed = 0  # accepted but errored (NOT load shedding)
        self.submitted = 0
        # accepted-Future accounting: _done callbacks may run a beat
        # AFTER result() wakes its waiter (Future resolves waiters
        # first), so run() must wait for _processed to catch up with
        # _accepted before snapshotting counters into the verdict
        self._accepted = 0
        self._processed = 0
        self._inflight: List[Future] = []

    # -- submission ----------------------------------------------------

    def _one(
        self, i: int, wait: bool, t0: Optional[float] = None
    ) -> Optional[Future]:
        """Submit request ``i``; latency is measured from ``t0`` when
        given — open-loop mode passes the SCHEDULED arrival time, so a
        generator that falls behind under overload charges the backlog
        delay to the requests that suffered it (no coordinated
        omission) instead of under-reporting the tail."""
        if t0 is None:
            t0 = time.perf_counter()
        try:
            fut = self.submit_fn(self.sample_fn(i))
        except LoadShedError:
            with self._lock:
                self.shed += 1
                self.submitted += 1
            return None
        with self._lock:
            self.submitted += 1
            self._accepted += 1

        def _done(f: Future, t0=t0):
            lat = (time.perf_counter() - t0) * 1000.0
            exc = None if f.cancelled() else f.exception()
            with self._lock:
                if not f.cancelled() and exc is None:
                    self.latencies_ms.append(lat)
                elif isinstance(exc, LoadShedError):
                    # accepted but shed by a racing drain: still load
                    # shedding, still part of the accounting identity
                    self.shed += 1
                else:
                    # engine/runner breakage is NOT shedding — an
                    # operator must not read a broken artifact as queue
                    # overload
                    self.failed += 1
                self._processed += 1

        fut.add_done_callback(_done)
        if wait:
            try:
                fut.result()
            except Exception:
                pass  # recorded as not-completed; the verdict shows it
        return fut

    def _run_closed(self) -> None:
        per_worker = self.requests // self.concurrency
        extra = self.requests % self.concurrency

        def worker(wid: int, n: int):
            # each worker owns a disjoint id range; min(wid, extra)
            # accounts for the +1 requests handed to workers < extra,
            # so ids cover exactly 0..requests-1 with no overlap
            base = wid * per_worker + min(wid, extra)
            for j in range(n):
                if self.stop_fn():
                    return
                self._one(base + j, wait=True)

        threads = [
            threading.Thread(
                target=worker, args=(w, per_worker + (1 if w < extra else 0))
            )
            for w in range(self.concurrency)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _run_open(self) -> None:
        # the arrival schedule is drawn up front from the seed —
        # deterministic offered load, independent of service times
        rng = random.Random(self.seed)
        gaps = [rng.expovariate(self.rate) for _ in range(self.requests)]
        t_next = time.perf_counter()
        for i, gap in enumerate(gaps):
            t_next += gap
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if self.stop_fn():
                return
            # latency clock starts at the SCHEDULED arrival, not the
            # (possibly late) submit — see _one
            fut = self._one(i, wait=False, t0=t_next)
            if fut is not None:
                self._inflight.append(fut)

    def run(self) -> Dict[str, Any]:
        """Offer the configured load; returns raw counters (the caller
        builds the verdict after the batcher drains)."""
        t0 = time.perf_counter()
        if self.mode == "closed":
            self._run_closed()
        else:
            self._run_open()
        # answered-before-verdict: wait for whatever is still in flight
        # (the batcher keeps consuming; on drain it answers everything)
        for fut in self._inflight:
            try:
                fut.result(timeout=60.0)
            except Exception:
                pass
        wall_s = time.perf_counter() - t0
        # settle: every accepted Future's _done callback must have
        # landed, or the last request's latency/shed increment could be
        # missing from the snapshot
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with self._lock:
                if self._processed >= self._accepted:
                    break
            time.sleep(0.001)
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": len(self.latencies_ms),
                "shed": self.shed,
                "failed": self.failed,
                "wall_s": wall_s,
                "latencies_ms": sorted(self.latencies_ms),
            }


# ---------------------------------------------------------------------------
# Traffic-shaped arrival processes + the socket load generator
# ---------------------------------------------------------------------------


# one scheduled request of a scenario: seconds-from-start, priority
# class, tenant, whether the CLIENT dribbles the body (slow-client
# scenario — the server must tolerate slow writers without stalling
# everyone else), and which co-resident model the request targets
# (x-model header; None = the server's default model)
Arrival = namedtuple(
    "Arrival", ("t", "priority", "tenant", "slow", "model"),
    defaults=(None,),
)

# the provenance scalars the verdict needs from an engine — held
# instead of the engine itself so dropping the engine actually frees
# its device weights (the A/B bench relies on this)
_EngineMeta = namedtuple("_EngineMeta", ("arch", "dataset"))


SCENARIOS = (
    "poisson", "diurnal", "flash_crowd", "heavy_tail", "slow_client",
)


def _weighted_pick(rng: random.Random, options: Sequence, weights) -> Any:
    """Deterministic weighted draw from a seeded Random (no
    random.choices: one rng.random() per draw keeps the consumption
    schedule obvious and stable)."""
    total = float(sum(weights))
    x = rng.random() * total
    acc = 0.0
    for opt, w in zip(options, weights):
        acc += float(w)
        if x < acc:
            return opt
    return options[-1]


def build_schedule(
    scenario: str,
    *,
    requests: int,
    rate: float,
    seed: int,
    priorities: int = 3,
    priority_weights: Optional[Sequence[float]] = None,
    tenants: Sequence[str] = ("tenant-a", "tenant-b"),
    tenant_weights: Optional[Sequence[float]] = None,
    flash_factor: float = 8.0,
    diurnal_amp: float = 0.8,
    heavy_sigma: float = 1.5,
    slow_fraction: float = 0.2,
    models: Optional[Sequence[str]] = None,
    model_weights: Optional[Sequence[float]] = None,
) -> List[Arrival]:
    """A deterministic arrival schedule for one scenario — drawn up
    front from ``random.Random(seed)``, so the OFFERED load is
    seed-reproducible regardless of how the server responds.

    - ``poisson``      constant-rate memoryless arrivals (the open
      loop's, with priorities/tenants attached)
    - ``diurnal``      a full sinusoidal day compressed into the run:
      rate(t) = rate·(1 + amp·sin(2πt/T)), T = the nominal run length
      — exercises sustained swing between underload and overload
    - ``flash_crowd``  baseline Poisson with a ``flash_factor``×
      burst over the middle sixth of the run — the thundering herd
      that must shed LOW classes while priority 0 keeps its p99
    - ``heavy_tail``   lognormal inter-arrivals (σ = ``heavy_sigma``)
      with the mean matched to 1/rate: long quiet stretches punctuated
      by dense clumps, the realistic non-Poisson mix
    - ``slow_client``  Poisson arrivals where a seeded
      ``slow_fraction`` of requests dribble their body bytes — the
      server must not let a slow writer stall fast ones

    Priorities and tenants are drawn per request from the seeded RNG
    (defaults: 10%% priority-0, 30%% priority-1, 60%% priority-2;
    uniform tenants) — pass explicit weights to skew."""
    if scenario not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {scenario!r} (want one of {SCENARIOS})"
        )
    if requests <= 0 or rate <= 0:
        raise ValueError("need requests > 0 and rate > 0")
    if priority_weights is None:
        # default mix: a thin premium class over a broad best-effort
        # base, truncated/padded to the configured class count
        base = [0.1, 0.3, 0.6]
        priority_weights = (
            base[:priorities]
            if priorities <= 3
            else base + [0.6] * (priorities - 3)
        )
    if len(priority_weights) != priorities:
        raise ValueError(
            f"priority_weights must have {priorities} entries, got "
            f"{len(priority_weights)}"
        )
    if tenant_weights is None:
        tenant_weights = [1.0] * len(tenants)
    if len(tenant_weights) != len(tenants):
        raise ValueError(
            f"tenant_weights must have {len(tenants)} entries, got "
            f"{len(tenant_weights)}"
        )
    if models and model_weights is None:
        model_weights = [1.0] * len(models)
    if models and len(model_weights) != len(models):
        raise ValueError(
            f"model_weights must have {len(models)} entries, got "
            f"{len(model_weights)}"
        )
    rng = random.Random(seed)
    duration = requests / rate  # nominal run length at the base rate
    flash_t0, flash_t1 = duration / 3.0, duration / 3.0 + duration / 6.0
    mu = math.log(1.0 / rate) - heavy_sigma**2 / 2.0

    out: List[Arrival] = []
    t = 0.0
    for _ in range(int(requests)):
        if scenario == "heavy_tail":
            gap = rng.lognormvariate(mu, heavy_sigma)
        else:
            r = rate
            if scenario == "diurnal":
                r = max(
                    rate * (1.0 + diurnal_amp
                            * math.sin(2.0 * math.pi * t / duration)),
                    rate * 0.05,
                )
            elif scenario == "flash_crowd" and flash_t0 <= t < flash_t1:
                r = rate * flash_factor
            gap = rng.expovariate(r)
        t += gap
        slow = scenario == "slow_client" and rng.random() < slow_fraction
        out.append(Arrival(
            t=t,
            priority=_weighted_pick(
                rng, list(range(priorities)), priority_weights
            ),
            tenant=_weighted_pick(rng, list(tenants), tenant_weights),
            slow=slow,
            model=(
                _weighted_pick(rng, list(models), model_weights)
                if models else None
            ),
        ))
    return out


def recv_response(rfile) -> Tuple[int, Dict[str, str], bytes]:
    """Minimal HTTP/1.1 response parse off a socket makefile('rb') —
    the socket load generator's, and any client's that speaks to the
    front end (serve/http.py) in the same wire dialect."""
    line = rfile.readline()
    if not line:
        raise ConnectionError("server closed the connection")
    parts = line.decode("latin-1").split(None, 2)
    status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        h = rfile.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    n = int(headers.get("content-length", 0) or 0)
    body = rfile.read(n) if n else b""
    return status, headers, body


class HttpLoadGenerator:
    """Offer a prebuilt :func:`build_schedule` schedule to a live
    server over REAL sockets (raw stdlib sockets — slow-client body
    dribble needs byte-level control no high-level client gives).

    A dispatcher walks the schedule by wall clock and hands each
    arrival to a worker pool (``concurrency`` persistent keep-alive
    connections); latency is measured from the SCHEDULED arrival, so a
    backlogged pool charges the delay to the requests that suffered it
    (no coordinated omission). ``stop_fn`` is polled between arrivals
    — the SIGTERM latch.

    The ledger separates the outcomes that matter for the drain
    contract: every request must get SOME response (2xx/4xx/5xx);
    ``dropped`` counts requests that got none — the number the
    zero-dropped acceptance test pins at 0."""

    def __init__(
        self,
        host: str,
        port: int,
        schedule: Sequence[Arrival],
        *,
        body_fn: Callable[[int], bytes],
        content_type: str = "application/octet-stream",
        path: str = "/v1/predict",
        concurrency: int = 16,
        stop_fn: Callable[[], bool] = lambda: False,
        slow_chunks: int = 4,
        slow_gap_s: float = 0.02,
        timeout_s: float = 60.0,
        on_arrival: Optional[Callable[[int], None]] = None,
    ):
        self.host = host
        self.port = int(port)
        self.schedule = list(schedule)
        self.body_fn = body_fn
        self.content_type = content_type
        self.path = path
        self.concurrency = max(int(concurrency), 1)
        self.stop_fn = stop_fn
        self.slow_chunks = max(int(slow_chunks), 1)
        self.slow_gap_s = float(slow_gap_s)
        self.timeout_s = float(timeout_s)
        # fires with the schedule index after each arrival is offered —
        # the swap-under-load orchestration keys its trigger off it
        self.on_arrival = on_arrival
        self._lock = threading.Lock()
        self.by_status: Dict[int, int] = {}
        self.dropped = 0
        self.submitted = 0
        self.lat_by_priority: Dict[int, List[float]] = {}

    # -- one request over one (reused) connection ----------------------

    def _connect(self):
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        return sock, sock.makefile("rb")

    def _send(self, sock, i: int, arr: Arrival) -> None:
        body = self.body_fn(i)
        model = (
            f"x-model: {arr.model}\r\n"
            if getattr(arr, "model", None) else ""
        )
        head = (
            f"POST {self.path} HTTP/1.1\r\n"
            f"host: {self.host}:{self.port}\r\n"
            f"x-priority: {arr.priority}\r\n"
            f"x-tenant: {arr.tenant}\r\n"
            + model
            + f"content-type: {self.content_type}\r\n"
            f"content-length: {len(body)}\r\n\r\n"
        ).encode("latin-1")
        if not arr.slow:
            sock.sendall(head + body)
            return
        # slow client: headers at once, then the body in dribbled
        # chunks — the server's reader must wait it out without
        # blocking anyone else's requests
        sock.sendall(head)
        step = max(len(body) // self.slow_chunks, 1)
        for off in range(0, len(body), step):
            sock.sendall(body[off:off + step])
            time.sleep(self.slow_gap_s)

    def _one(self, conn, i: int, arr: Arrival, t_sched: float):
        """Returns (conn, status|None); reconnects once on a torn
        keep-alive connection before counting the request dropped."""
        for attempt in (0, 1):
            if conn is None:
                try:
                    conn = self._connect()
                except OSError:
                    conn = None
                    continue
            sock, rfile = conn
            try:
                self._send(sock, i, arr)
                status, headers, _body = recv_response(rfile)
            except (OSError, ValueError, ConnectionError):
                try:
                    sock.close()
                except OSError:
                    pass
                conn = None
                continue
            lat_ms = (time.perf_counter() - t_sched) * 1000.0
            with self._lock:
                self.by_status[status] = self.by_status.get(status, 0) + 1
                if status == 200:
                    self.lat_by_priority.setdefault(
                        arr.priority, []
                    ).append(lat_ms)
            if headers.get("connection", "").lower() == "close":
                try:
                    sock.close()
                except OSError:
                    pass
                conn = None
            return conn, status
        with self._lock:
            self.dropped += 1
        return conn, None

    def run(self) -> Dict[str, Any]:
        import queue as _queue

        work: "_queue.Queue" = _queue.Queue()

        def worker():
            conn = None
            while True:
                item = work.get()
                if item is None:
                    break
                i, arr, t_sched = item
                conn, _status = self._one(conn, i, arr, t_sched)
            if conn is not None:
                try:
                    conn[0].close()
                except OSError:
                    pass

        workers = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.concurrency)
        ]
        for w in workers:
            w.start()
        t0 = time.perf_counter()
        for i, arr in enumerate(self.schedule):
            delay = (t0 + arr.t) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if self.stop_fn():
                break
            with self._lock:
                self.submitted += 1
            # latency clock starts at the SCHEDULED arrival
            work.put((i, arr, t0 + arr.t))
            if self.on_arrival is not None:
                try:
                    self.on_arrival(i)
                except Exception:
                    pass  # an orchestration hook must not stop the load
        for _ in workers:
            work.put(None)
        for w in workers:
            w.join(self.timeout_s)
        wall_s = time.perf_counter() - t0
        with self._lock:
            responses = sum(self.by_status.values())
            # a worker outliving its join (server wedged past
            # timeout_s) holds requests that are in `submitted` but in
            # neither `responses` nor `dropped` — they got NO answer
            # within the measurement, which is exactly what `dropped`
            # exists to count; the zero-dropped gate must not pass them
            missing = self.submitted - responses - self.dropped
            if missing > 0:
                self.dropped += missing
            return {
                "submitted": self.submitted,
                "responses": responses,
                "dropped": self.dropped,
                "by_status": {
                    str(k): v for k, v in sorted(self.by_status.items())
                },
                "wall_s": round(wall_s, 3),
                "p99_ms_by_priority": {
                    str(p): _pct(sorted(v), 99.0)
                    for p, v in sorted(self.lat_by_priority.items())
                },
            }


def fairness_ratio(
    per_tenant: Dict[str, Dict[str, Any]],
) -> Optional[float]:
    """Max/min ratio of per-tenant SERVICE rates (completed/submitted)
    over tenants that offered load: 1.0 = perfectly even service, large
    = somebody is starving. None when fewer than two tenants offered
    load, or when a tenant got NOTHING through (an infinite ratio is
    not a number a tolerance can judge — the per-tenant table carries
    the zero explicitly)."""
    rates = []
    for t in per_tenant.values():
        submitted = t.get("submitted") or 0
        if submitted > 0:
            rates.append((t.get("completed") or 0) / submitted)
    if len(rates) < 2:
        return None
    lo = min(rates)
    if lo <= 0.0:
        return None
    return round(max(rates) / lo, 4)



def slo_verdict(
    raw: Dict[str, Any],
    batcher_stats: Dict[str, Any],
    *,
    mode: str,
    rate: float,
    seed: int,
    provenance: Optional[Dict[str, Any]] = None,
    warmup_s: Optional[Dict[str, float]] = None,
    preempted: bool = False,
    drained_clean: bool = True,
    scenario: Optional[str] = None,
    per_priority: Optional[Dict[str, Dict[str, Any]]] = None,
    per_tenant: Optional[Dict[str, Dict[str, Any]]] = None,
    fairness: Optional[float] = None,
    client: Optional[Dict[str, Any]] = None,
    slo: Optional[Dict[str, Any]] = None,
    replicas: Optional[Dict[str, Any]] = None,
    scaling: Optional[Dict[str, Any]] = None,
    swap: Optional[Dict[str, Any]] = None,
    resident: Optional[Dict[str, Any]] = None,
    packed: Optional[Dict[str, Any]] = None,
    attribution: Optional[Dict[str, Any]] = None,
    canary: Optional[Dict[str, Any]] = None,
    fleet: Optional[Dict[str, Any]] = None,
    fleet_attribution: Optional[Dict[str, Any]] = None,
    capacity: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the deterministic strict-JSON SLO verdict, in the
    reference's schema (:data:`VERDICT_SCHEMA_VERSION`).

    The v1 aggregates come from ``raw`` (the load generator's counters)
    and ``batcher_stats`` (:meth:`MicroBatcher.stats`). ``serve-bench``
    fills ``replicas`` and ``scaling`` (the replica pool), ``resident``
    and ``packed`` (weight residency and the dense-vs-packed A/B) and
    ``attribution`` (the request tracer, obs/rtrace.py). The other
    blocks belong to the reference's HTTP front end, canary, fleet and
    capacity planes; each is null unless given, so every consumer of the
    reference's verdicts (``compare``, ``summarize``, ``watch``) reads
    this one."""
    lats = raw["latencies_ms"]
    wall = max(raw["wall_s"], 1e-9)
    submitted = max(raw["submitted"], 1)
    verdict = {
        "serve_verdict": VERDICT_SCHEMA_VERSION,
        "mode": mode,
        "rate_rps": rate if mode != "closed" else None,
        "seed": seed,
        "scenario": scenario,
        "requests_submitted": raw["submitted"],
        "requests_completed": raw["completed"],
        "requests_shed": raw["shed"],
        "requests_failed": raw.get("failed", 0),
        # malformed-body 400s (serve-http): the tenant's own bad
        # requests — neither completed nor shed nor failed, so the
        # ledger identity completed+shed+failed+rejected == submitted
        # survives bad clients
        "requests_rejected": raw.get("rejected", 0),
        "shed_rate": round(raw["shed"] / submitted, 6),
        "p50_ms": _pct(lats, 50.0),
        "p95_ms": _pct(lats, 95.0),
        "p99_ms": _pct(lats, 99.0),
        "throughput_rps": round(raw["completed"] / wall, 3),
        "wall_s": round(wall, 3),
        "mean_batch_occupancy": batcher_stats.get("mean_occupancy"),
        "batches": batcher_stats.get("batches"),
        "max_queue_depth_seen": batcher_stats.get("max_queue_depth_seen"),
        "max_queue": batcher_stats.get("max_queue"),
        "per_priority": per_priority,
        "per_tenant": per_tenant,
        "fairness_ratio": fairness,
        "client": client,
        "slo": slo,
        "replicas": replicas,
        "scaling": scaling,
        "swap": swap,
        "resident": resident,
        "packed": packed,
        "attribution": attribution,
        "canary": canary,
        "fleet": fleet,
        "fleet_attribution": fleet_attribution,
        "capacity": capacity,
        # bucket keys as strings: the verdict must survive a JSON
        # round trip unchanged (int dict keys would silently stringify)
        "warmup_compile_s": (
            {str(k): v for k, v in warmup_s.items()} if warmup_s else None
        ),
        "preempted": bool(preempted),
        "drained_clean": bool(drained_clean),
        "provenance": provenance or {},
    }
    from bdbnn_tpu_torch.obs.events import jsonsafe

    return jsonsafe(verdict)


def http_slo_verdict(
    accounting: Dict[str, Any],
    batcher_stats: Dict[str, Any],
    admission_stats: Dict[str, Any],
    *,
    scenario: str,
    rate: float,
    seed: int,
    provenance: Optional[Dict[str, Any]] = None,
    warmup_s: Optional[Dict[str, float]] = None,
    preempted: bool = False,
    drained_clean: bool = True,
    client: Optional[Dict[str, Any]] = None,
    slo_p99_ms: float = 0.0,
    replicas: Optional[Dict[str, Any]] = None,
    swap: Optional[Dict[str, Any]] = None,
    resident: Optional[Dict[str, Any]] = None,
    packed: Optional[Dict[str, Any]] = None,
    attribution: Optional[Dict[str, Any]] = None,
    canary: Optional[Dict[str, Any]] = None,
    capacity: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build the v2 verdict from the HTTP front end's request ledger
    (:meth:`serve.http.HttpFrontEnd.accounting`), the batcher's
    per-priority occupancy and the admission controller's per-tenant
    counters — the three sources of truth, joined exactly once."""
    lat_p = accounting["latencies_ms_by_priority"]
    counts_p = accounting["counts_by_priority"]
    per_priority: Dict[str, Dict[str, Any]] = {}
    all_lats: List[float] = []
    for p, (lats, counts) in enumerate(zip(lat_p, counts_p)):
        all_lats += lats
        shed = (
            counts["shed_draining"] + counts["shed_over_quota"]
            + counts["shed_queue_full"]
            + counts.get("shed_unavailable", 0)
        )
        per_priority[str(p)] = {
            "submitted": counts["submitted"],
            "completed": counts["completed"],
            "failed": counts["failed"],
            "rejected": counts.get("rejected", 0),
            "shed": shed,
            "shed_draining": counts["shed_draining"],
            "shed_over_quota": counts["shed_over_quota"],
            "shed_queue_full": counts["shed_queue_full"],
            "shed_unavailable": counts.get("shed_unavailable", 0),
            "shed_rate": round(
                shed / max(counts["submitted"], 1), 6
            ),
            "p50_ms": _pct(lats, 50.0),
            "p95_ms": _pct(lats, 95.0),
            "p99_ms": _pct(lats, 99.0),
        }
    per_tenant: Dict[str, Dict[str, Any]] = {}
    for tenant, c in (admission_stats.get("tenants") or {}).items():
        submitted = c["admitted"] + c["over_quota"]
        per_tenant[tenant] = {
            "submitted": submitted,
            "admitted": c["admitted"],
            "completed": c["completed"],
            "failed": c["failed"],
            "rejected": c.get("rejected", 0),
            "over_quota": c["over_quota"],
            "shed_queue": c["shed"],
            "shed_rate": c["shed_rate"],
            "quota_rate": c["quota_rate"],
            "quota_burst": c["quota_burst"],
        }
    submitted = sum(c["submitted"] for c in counts_p)
    completed = sum(c["completed"] for c in counts_p)
    failed = sum(c["failed"] for c in counts_p)
    rejected = sum(c.get("rejected", 0) for c in counts_p)
    shed = sum(v["shed"] for v in per_priority.values())
    all_lats.sort()
    slo = None
    if slo_p99_ms > 0:
        p0_p99 = per_priority.get("0", {}).get("p99_ms")
        slo = {
            "p99_ms_target_priority0": slo_p99_ms,
            "p99_ms_priority0": p0_p99,
            "met": bool(p0_p99 is not None and p0_p99 <= slo_p99_ms),
        }
    return slo_verdict(
        {
            "submitted": submitted,
            "completed": completed,
            "shed": shed,
            "failed": failed,
            "rejected": rejected,
            "wall_s": accounting["wall_s"],
            "latencies_ms": all_lats,
        },
        batcher_stats,
        mode="http",
        rate=rate,
        seed=seed,
        provenance=provenance,
        warmup_s=warmup_s,
        preempted=preempted,
        drained_clean=drained_clean,
        scenario=scenario,
        per_priority=per_priority,
        per_tenant=per_tenant,
        fairness=fairness_ratio(per_tenant),
        client=client,
        slo=slo,
        replicas=replicas,
        swap=swap,
        resident=resident,
        packed=packed,
        attribution=attribution,
        canary=canary,
        capacity=capacity,
    )


def run_serve_bench(cfg) -> Dict[str, Any]:
    """End-to-end serving benchmark over an export artifact (the
    ``serve-bench`` CLI body). ``cfg`` is a
    :class:`bdbnn_tpu_torch.serve.config.ServeBenchConfig`. Returns
    ``{verdict, run_dir}``; the verdict is also written to
    ``<run_dir>/verdict.json`` (and ``cfg.out`` when set) and emitted as
    the final ``serve`` event. Raises before anything runs when the
    config asks for the card (the default) and there is none."""
    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.train.resilience import PreemptionHandler

    cfg = cfg.validate()
    resolve_device(cfg.device)
    # the SIGTERM latch covers the WHOLE bench — a preemption during
    # the multi-second engine build and warmup must drain-and-report,
    # not die with the default disposition
    with PreemptionHandler() as handler:
        return _serve_bench_body(cfg, handler)


def _serve_bench_body(cfg, handler) -> Dict[str, Any]:
    """Route one serve-bench invocation: the classic single-engine path
    for the default config, the replica-pool path (optionally a
    multi-N scaling sweep) when ``--replicas`` asks for more than one
    replica — or for the paced fabric mode either way."""
    sweep = tuple(sorted({int(n) for n in cfg.replicas}))
    if sweep == (1,) and cfg.pace_ms == 0:
        return _serve_bench_single(cfg, handler)
    return _serve_bench_pool(cfg, handler, sweep)


class _ArtifactMeta:
    """Just the artifact metadata the pooled orchestrations need —
    arch/dataset/shape/buckets read from ``artifact.json``, with NO
    weight load and NO device placement (the serving weights live
    inside the replicas' own engines; paced fabric mode loads nothing
    at all). Duck-types the fields the manifest/provenance helpers
    read off a real engine."""

    def __init__(self, artifact_dir: str, buckets):
        from bdbnn_tpu_torch.serve.export import read_artifact

        self.artifact = read_artifact(artifact_dir)
        self.arch = self.artifact["arch"]
        self.dataset = self.artifact["dataset"]
        self.image_size = int(self.artifact["image_size"])
        self.num_classes = int(self.artifact["num_classes"])
        self.buckets = tuple(sorted({int(b) for b in buckets}))


def _bench_manifest_fields(cfg, engine, prov, recipe) -> Dict[str, Any]:
    """The manifest fields both serve-bench paths (single-engine and
    replica-pool) share — one place for the provenance/knob surface, so
    a new field cannot land in one path and drift from the other."""
    return {
        "mode": "serve-bench",
        "artifact": os.path.abspath(cfg.artifact),
        # recipe fields flow through so `compare` aligns serving runs
        # on the same export provenance — None entries dropped and
        # spread FIRST, so a bare-checkpoint export's empty recipe can
        # never null out the arch/dataset the engine positively knows
        **{k: v for k, v in recipe.items() if v is not None},
        "arch": engine.arch,
        "dataset": engine.dataset,
        "export_config_hash": prov.get("config_hash"),
        "buckets": list(cfg.buckets),
        "queue_depth": cfg.queue_depth,
        "max_delay_ms": cfg.max_delay_ms,
        "load_mode": cfg.mode,
        "rate": cfg.rate,
        "requests": cfg.requests,
        "concurrency": cfg.concurrency,
        "seed": cfg.seed,
        "rtrace": cfg.rtrace,
        "rtrace_sample_every": cfg.rtrace_sample_every,
    }


def _serve_provenance(
    artifact_dir, engine, prov, recipe, manifest
) -> Dict[str, Any]:
    """The verdict's provenance block — shared by both bench paths and
    the HTTP front end (whose ``artifact_dir`` may be a
    registry-resolved version, not the raw CLI argument)."""
    return {
        "artifact": os.path.abspath(artifact_dir),
        "arch": engine.arch,
        "dataset": engine.dataset,
        "config_hash": prov.get("config_hash"),
        "recipe": recipe,
        "serve_config_hash": manifest.get("config_hash"),
    }


def write_verdict_files(
    verdict: Dict[str, Any], run_dir: str, out: str = ""
) -> None:
    """Atomically (tmp + rename) write the verdict to the run dir and,
    when set, the caller's ``--out`` path — the one write protocol all
    three serving orchestrations use."""
    for path in (os.path.join(run_dir, VERDICT_NAME), out or None):
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(verdict, f, indent=2, sort_keys=True)
            os.replace(tmp, path)


def _pool_replicas_block(
    pool_stats: Optional[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The verdict's v3 ``replicas`` block from one pool's final
    :meth:`~bdbnn_tpu_torch.serve.pool.ReplicaPool.stats` snapshot: the
    per-replica table (device, version, batches, completed requests,
    occupancy share, restarts) and the completed-by-version ledger the
    swap acceptance test pins."""
    if pool_stats is None:
        return None
    total = max(pool_stats["completed"], 1)
    return {
        "n": pool_stats["n_replicas"],
        "version": pool_stats["version"],
        "dispatched_batches": pool_stats["dispatched"],
        "pool_shed_batches": pool_stats["shed"],
        "restarts": pool_stats["restarts"],
        "completed_by_version": pool_stats["completed_by_version"],
        "per_replica": [
            {
                "replica": r["replica"],
                "device": r["device"],
                "version": r["version"],
                "state": r["state"],
                "batches": r["batches"],
                "completed": r["completed"],
                # occupancy share: this replica's slice of the served
                # requests — a wedged/unhealthy replica shows up as a
                # hole here even when the aggregate throughput held
                "share": round(r["completed"] / total, 4),
                "restarts": r["restarts"],
            }
            for r in pool_stats["replicas"]
        ],
    }


def _serve_bench_pool(cfg, handler, sweep) -> Dict[str, Any]:
    """The replica-pool serve-bench: for each N in ``sweep`` build an
    N-replica pool (one warmed engine per card — or a paced stub per
    simulated device in fabric mode), drive the configured
    load through the front batcher's async dispatch, and drain. With
    more than one N the verdict carries the ``scaling`` block
    (throughput per N, monotonicity, efficiency at the largest N =
    throughput(N_max) / ((N_max/N_min) * throughput(N_min)) — the
    number ``compare`` judges as ``serve_scaling_efficiency``)."""
    import datetime

    import numpy as np

    from bdbnn_tpu_torch.obs.events import EventWriter
    from bdbnn_tpu_torch.obs.manifest import write_manifest
    from bdbnn_tpu_torch.serve.pool import (
        ReplicaPool,
        first_warm_capture,
        make_engine_runner_factory,
        replica_stats_fields,
        resident_block,
    )

    paced = cfg.pace_ms > 0
    # metadata/shape source only (no weight load, nothing on a device)
    # — replica engines are built and warmed per device by the
    # factory; paced mode loads nothing at all
    engine = _ArtifactMeta(cfg.artifact, cfg.buckets)

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = os.path.join(cfg.log_path, stamp)
    os.makedirs(run_dir, exist_ok=True)
    prov = engine.artifact.get("provenance", {})
    recipe = prov.get("recipe") or {}
    manifest = write_manifest(
        run_dir,
        {
            **_bench_manifest_fields(cfg, engine, prov, recipe),
            "replicas": list(sweep),
            "pace_ms": cfg.pace_ms,
            "packed_weights": cfg.packed_weights,
            "packed_impl": cfg.packed_impl,
        },
        device=cfg.device,
    )
    events = EventWriter(run_dir, max_bytes=int(cfg.events_max_mb * 2**20))
    events.emit(
        "serve",
        phase="start",
        artifact=os.path.abspath(cfg.artifact),
        arch=engine.arch,
        buckets=list(cfg.buckets),
        mode=cfg.mode,
        rate_rps=cfg.rate if cfg.mode == "open" else None,
        requests=cfg.requests,
        queue_depth=cfg.queue_depth,
        max_delay_ms=cfg.max_delay_ms,
        replicas=list(sweep),
        pace_ms=cfg.pace_ms if paced else None,
    )

    warm_compile, _on_engine = first_warm_capture()
    factory = make_engine_runner_factory(
        cfg.buckets,
        pace_ms=cfg.pace_ms,
        on_engine=_on_engine,
        packed=cfg.packed_weights == "on",
        packed_impl=cfg.packed_impl,
        on_event=lambda kind, **f: events.emit(kind, **f),
    )
    rng = np.random.default_rng(cfg.seed)
    img_pool = rng.standard_normal(
        (32, engine.image_size, engine.image_size, 3)
    ).astype(np.float32)
    sample_fn = lambda i: img_pool[i % len(img_pool)]

    throughput: Dict[str, float] = {}
    passes: Dict[int, Any] = {}
    caches_per_pass: Dict[int, Any] = {}
    tracers: Dict[int, Any] = {}
    for n in sweep:
        if handler.preempted:
            break
        # snapshot by IDENTITY, not index: the factory REPLACES a
        # re-used device's stale cache in place (removal shifts list
        # indices), so a tail slice would miss re-created caches for
        # devices earlier passes already used
        caches_before = {id(c) for c in factory.caches}
        if paced:
            devices: List[Any] = [f"paced:{i}" for i in range(n)]
        else:
            from bdbnn_tpu_torch.parallel.mesh import replica_devices

            devices = list(replica_devices(n, cfg.device))
        pool = ReplicaPool(
            factory,
            devices,
            artifact_ref=cfg.artifact,
            version="v0001",
            max_queue_batches=cfg.replica_queue_batches,
            wedge_timeout_s=cfg.wedge_timeout_s,
            on_event=lambda kind, **f: events.emit(kind, **f),
        )

        # live telemetry parity with the single-engine path: rolling
        # per-batch `serve` stats (on_batch fires from the async
        # settle callback too) + the per-replica heartbeat `watch`
        # renders — a pooled bench must not go dark while it runs
        window: List[float] = []
        win_lock = threading.Lock()
        batch_counter = [0]
        emit_every = max(
            cfg.requests // (20 * max(engine.buckets[-1], 1)), 1
        )

        def on_batch(stats: Dict[str, Any], n=n) -> None:
            with win_lock:
                window.append(stats["oldest_wait_ms"] + stats["run_ms"])
                del window[:-256]
                rolling = sorted(window)
                batch_counter[0] += 1
                nb = batch_counter[0]
            if nb % emit_every == 0:
                events.emit(
                    "serve",
                    phase="stats",
                    replicas_n=n,
                    batch_size=stats["batch_size"],
                    occupancy=stats["occupancy"],
                    queue_depth=stats["queue_depth"],
                    rolling_p99_ms=_pct(rolling, 99.0),
                    completed=stats["completed"],
                    shed=stats["shed"],
                )

        # request-path tracing (obs/rtrace.py): every submission gets a
        # queue -> coalesce -> dispatch -> compute waterfall; sampled
        # exemplars + periodic stage histograms flow as rtrace events
        tracer = None
        if cfg.rtrace:
            from bdbnn_tpu_torch.obs.rtrace import RequestTracer

            tracer = RequestTracer(
                seed=cfg.seed,
                sample_every=cfg.rtrace_sample_every,
                tail_k=cfg.rtrace_tail_k,
                on_sample=lambda wf: events.emit(
                    "rtrace", phase="request", **wf
                ),
            )
            tracers[n] = tracer

        pump_stop = threading.Event()

        def pump(pool=pool, tracer=tracer):
            while not pump_stop.wait(0.5):
                events.emit(
                    "replica", phase="stats",
                    **replica_stats_fields(pool.stats()),
                )
                if tracer is not None:
                    events.emit(
                        "rtrace", phase="stats", **tracer.stats()
                    )

        t_pump = threading.Thread(
            target=pump, name="bench-replica-stats", daemon=True
        )
        t_pump.start()

        batcher = MicroBatcher(
            pool.submit,
            max_batch=engine.buckets[-1],
            max_queue=cfg.queue_depth,
            max_delay_ms=cfg.max_delay_ms,
            on_batch=on_batch,
            # backpressure: ~1 executing + 1 queued batch per replica —
            # overload sheds at the front (priority-ordered), never by
            # failing accepted batches against full replica queues
            max_pending_batches=2 * n,
        )
        gen = LoadGenerator(
            tracer.bind(batcher.submit) if tracer is not None
            else batcher.submit,
            sample_fn,
            mode=cfg.mode,
            requests=cfg.requests,
            rate=cfg.rate,
            concurrency=cfg.concurrency,
            seed=cfg.seed,
            stop_fn=lambda: handler.preempted,
        )
        raw = gen.run()
        drained = batcher.drain(timeout=120.0)
        drained = pool.drain(timeout=60.0) and drained
        pump_stop.set()
        t_pump.join(timeout=5.0)
        thr = round(raw["completed"] / max(raw["wall_s"], 1e-9), 3)
        throughput[str(n)] = thr
        passes[n] = (raw, batcher.stats(), pool.stats(), drained)
        caches_per_pass[n] = [
            c for c in factory.caches if id(c) not in caches_before
        ]
        events.emit(
            "serve",
            phase="scaling",
            replicas_n=n,
            throughput_rps=thr,
            completed=raw["completed"],
            shed=raw["shed"],
            wall_s=round(raw["wall_s"], 3),
        )

    if passes:
        n_last = max(passes)
        raw, batcher_stats, pool_stats, drained_clean = passes[n_last]
        resident = resident_block(caches_per_pass.get(n_last, []))
        if resident is not None:
            events.emit(
                "memory",
                phase="serve_resident",
                available=True,
                devices=[],
                peak_bytes=None,
                limit_bytes=None,
                weights_mode=(
                    "packed" if cfg.packed_weights == "on" else "dense"
                ),
                resident_bytes=resident["bytes_per_model_max"],
                models=len(resident["models"]),
                replicas=resident["replicas"],
            )
    else:
        # preempted before the first pass could offer load: an honest
        # empty verdict, drained by construction
        raw = {"submitted": 0, "completed": 0, "shed": 0, "failed": 0,
               "wall_s": 0.0, "latencies_ms": []}
        batcher_stats, pool_stats, drained_clean = {}, None, True
        resident = None

    scaling = None
    if len(passes) > 1:
        ns = sorted(passes)
        n_min, n_max = ns[0], ns[-1]
        t_min, t_max = throughput[str(n_min)], throughput[str(n_max)]
        vals = [throughput[str(n)] for n in ns]
        scaling = {
            "replicas": ns,
            "throughput_rps": throughput,
            # ideal scaling from the smallest measured N: 1.0 = linear
            "efficiency": (
                round(t_max / ((n_max / n_min) * t_min), 4)
                if t_min else None
            ),
            "monotone": all(b >= a for a, b in zip(vals, vals[1:])),
            "paced_ms": cfg.pace_ms if paced else None,
        }

    verdict = slo_verdict(
        raw,
        batcher_stats,
        mode=cfg.mode,
        rate=cfg.rate,
        seed=cfg.seed,
        provenance=_serve_provenance(
            cfg.artifact, engine, prov, recipe, manifest
        ),
        warmup_s=dict(warm_compile) if warm_compile else None,
        preempted=handler.preempted,
        drained_clean=drained_clean,
        replicas=_pool_replicas_block(pool_stats),
        scaling=scaling,
        resident=resident,
        # attribution from the LARGEST measured pass — the same pass
        # every other aggregate in this verdict reports
        attribution=(
            tracers[max(passes)].attribution()
            if passes and max(passes) in tracers else None
        ),
    )
    events.emit("serve", phase="verdict", **verdict)
    events.close()
    write_verdict_files(verdict, run_dir, cfg.out)
    return {"verdict": verdict, "run_dir": run_dir}


def _serve_bench_single(cfg, handler) -> Dict[str, Any]:
    """The single-engine serve-bench, now residency-aware: with
    ``--packed-weights on`` the engine keeps its binary convs 1-bit
    resident (nn/packed.py); with ``ab`` the SAME load runs twice —
    dense first, then packed — and the verdict's ``packed`` block
    records the memory squeeze (resident bytes per side + ratio) and
    an honest per-step time delta, even when step time is a wash. The
    primary verdict aggregates come from the PACKED pass (the
    configuration being shipped); each pass emits a ``memory`` event
    (phase ``serve_resident``) recording resident-bytes before/after
    the squeeze."""
    import datetime

    import numpy as np

    from bdbnn_tpu_torch.obs.events import EventWriter
    from bdbnn_tpu_torch.obs.manifest import write_manifest
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    mode_plan = {
        "off": (("dense", False),),
        "on": (("packed", True),),
        "ab": (("dense", False), ("packed", True)),
    }[cfg.packed_weights]

    run_dir = os.path.join(
        cfg.log_path,
        datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"),
    )
    os.makedirs(run_dir, exist_ok=True)
    events = EventWriter(
        run_dir, max_bytes=int(cfg.events_max_mb * 2**20)
    )

    manifest = None
    prov: Dict[str, Any] = {}
    recipe: Dict[str, Any] = {}
    passes: Dict[str, Dict[str, Any]] = {}
    engine_meta: Any = None
    for label, is_packed in mode_plan:
        if handler.preempted and passes:
            break
        engine = InferenceEngine(
            cfg.artifact,
            buckets=cfg.buckets,
            device=cfg.device,
            packed=is_packed,
            packed_impl=cfg.packed_impl,
        )
        warmup_s = dict(engine.compile_seconds)
        if manifest is None:
            prov = engine.artifact.get("provenance", {})
            recipe = prov.get("recipe") or {}
            manifest = write_manifest(
                run_dir,
                {
                    **_bench_manifest_fields(cfg, engine, prov, recipe),
                    "packed_weights": cfg.packed_weights,
                    "packed_impl": cfg.packed_impl,
                },
                device=cfg.device,
            )
        residency = engine.residency()
        # the residency datapoint: what THIS mode keeps alive in device
        # memory vs what the other mode would — before/after on one
        # timeline, consumable by any `memory`-event reader
        events.emit(
            "memory",
            phase="serve_resident",
            available=True,
            devices=[],
            peak_bytes=None,
            limit_bytes=None,
            weights_mode=label,
            packed_impl=cfg.packed_impl if is_packed else None,
            resident_bytes=residency["resident_bytes"],
            dense_equiv_bytes=residency["dense_equiv_bytes"],
            packed_equiv_bytes=residency["packed_equiv_bytes"],
            ratio=residency["ratio"],
        )
        step_ms = engine.time_step(iters=5)
        events.emit(
            "serve",
            phase="start",
            artifact=os.path.abspath(cfg.artifact),
            arch=engine.arch,
            buckets=list(cfg.buckets),
            warmup_compile_s=warmup_s,
            mode=cfg.mode,
            # closed mode offers no Poisson load — null, like verdict
            rate_rps=cfg.rate if cfg.mode == "open" else None,
            requests=cfg.requests,
            queue_depth=cfg.queue_depth,
            max_delay_ms=cfg.max_delay_ms,
            weights_mode=label,
        )

        # rolling p99 over a sliding latency window for the live
        # `serve` stats events `watch` renders
        window: List[float] = []
        win_lock = threading.Lock()
        batch_counter = [0]
        emit_every = max(
            cfg.requests // (20 * max(engine.buckets[-1], 1)), 1
        )

        def on_batch(stats: Dict[str, Any]) -> None:
            # per-batch latency proxy: oldest request's wait + run
            with win_lock:
                window.append(stats["oldest_wait_ms"] + stats["run_ms"])
                del window[:-256]
                rolling = sorted(window)
                batch_counter[0] += 1
                n = batch_counter[0]
            if n % emit_every == 0:
                events.emit(
                    "serve",
                    phase="stats",
                    batch_size=stats["batch_size"],
                    occupancy=stats["occupancy"],
                    queue_depth=stats["queue_depth"],
                    rolling_p99_ms=_pct(rolling, 99.0),
                    completed=stats["completed"],
                    shed=stats["shed"],
                )

        def runner(samples: List[np.ndarray], engine=engine):
            return engine.predict_logits(np.stack(samples))

        batcher = MicroBatcher(
            runner,
            max_batch=engine.buckets[-1],
            max_queue=cfg.queue_depth,
            max_delay_ms=cfg.max_delay_ms,
            on_batch=on_batch,
        )

        # a small pregenerated pool of deterministic samples, cycled —
        # the offered traffic is seed-reproducible (and identical on
        # both A/B sides) without allocating thousands of images
        rng = np.random.default_rng(cfg.seed)
        pool = rng.standard_normal(
            (32, engine.image_size, engine.image_size, 3)
        ).astype(np.float32)
        sample_fn = lambda i: pool[i % len(pool)]

        # request-path tracing (obs/rtrace.py): queue -> coalesce ->
        # compute waterfalls per request (no socket, so no read/admit/
        # respond; no pool, so the dispatch stage stays empty -> null)
        tracer = None
        if cfg.rtrace:
            from bdbnn_tpu_torch.obs.rtrace import RequestTracer

            tracer = RequestTracer(
                seed=cfg.seed,
                sample_every=cfg.rtrace_sample_every,
                tail_k=cfg.rtrace_tail_k,
                on_sample=lambda wf, label=label: events.emit(
                    "rtrace", phase="request", weights_mode=label, **wf
                ),
            )

        gen = LoadGenerator(
            tracer.bind(batcher.submit) if tracer is not None
            else batcher.submit,
            sample_fn,
            mode=cfg.mode,
            requests=cfg.requests,
            rate=cfg.rate,
            concurrency=cfg.concurrency,
            seed=cfg.seed,
            stop_fn=lambda: handler.preempted,
        )
        raw = gen.run()
        # graceful drain: accepted requests are all answered before
        # the verdict is written — on SIGTERM this is the whole point
        drained_clean = batcher.drain(timeout=120.0)
        if tracer is not None:
            events.emit(
                "rtrace", phase="stats", weights_mode=label,
                **tracer.stats(),
            )
        wall = max(raw["wall_s"], 1e-9)
        passes[label] = {
            "raw": raw,
            "batcher_stats": batcher.stats(),
            "drained_clean": drained_clean,
            "warmup_s": warmup_s,
            "residency": residency,
            "step_ms": step_ms,
            # the engine's own blocked-compute window under the real
            # interleave — the compute-stage cross-check attribution
            # cites next to the idle time_step calibration
            "step_stats": engine.step_stats(),
            "tracer": tracer,
            "throughput_rps": round(raw["completed"] / wall, 3),
            "p99_ms": _pct(raw["latencies_ms"], 99.0),
        }
        # keep only the provenance scalars, then drop EVERY reference
        # that reaches the engine — the engine local, the runner whose
        # default arg captured it, and the batcher/gen that hold the
        # runner: the next pass builds its own engine, and an A/B must
        # not hold both resident sets at once (a surviving reference
        # would pin the dense weights through the packed pass's
        # construction and warmup — that overlap is the bug the A/B
        # exists to measure)
        # the pass's engine forwards (warmup, the time_step calibration,
        # the served batches): what a launch count is held against — 19
        # launches a forward of each kernel the mode runs
        events.emit(
            "serve", phase="pass", weights_mode=label,
            packed_impl=cfg.packed_impl if is_packed else None,
            forwards=engine.forwards,
        )
        engine_meta = _EngineMeta(engine.arch, engine.dataset)
        del engine, runner, batcher, gen

    primary = passes.get("packed") or passes["dense"]

    packed_block = None
    if cfg.packed_weights != "off":
        sides = {}
        for label in ("dense", "packed"):
            p = passes.get(label)
            if p is None:
                # a side that never ran (packed-only mode, or an ab
                # run preempted between passes) still records its
                # resident footprint computed from the OTHER side's
                # tensor index — dense-equivalent for a missing dense
                # pass, packed-equivalent for a missing packed pass
                # (filling the packed side with dense bytes would
                # report resident_ratio ~1.0, as if packing bought
                # nothing) — so the squeeze stays visible without the
                # double run
                pr = primary["residency"]
                equiv_key = (
                    "dense_equiv_bytes" if label == "dense"
                    else "packed_equiv_bytes"
                )
                sides[label] = {
                    "resident_bytes": pr[equiv_key],
                    "step_ms": None,
                    "throughput_rps": None,
                    "p99_ms": None,
                }
                continue
            sides[label] = {
                "resident_bytes": p["residency"]["resident_bytes"],
                "step_ms": p["step_ms"],
                "throughput_rps": p["throughput_rps"],
                "p99_ms": p["p99_ms"],
            }
        d_bytes = sides["dense"]["resident_bytes"]
        p_bytes = sides["packed"]["resident_bytes"]
        d_ms, p_ms = sides["dense"]["step_ms"], sides["packed"]["step_ms"]
        packed_block = {
            "mode": cfg.packed_weights,
            "impl": cfg.packed_impl,
            "dense": sides["dense"],
            "packed": sides["packed"],
            "resident_ratio": (
                round(d_bytes / max(p_bytes, 1), 3)
                if d_bytes is not None and p_bytes is not None else None
            ),
            "step_ms_delta_pct": (
                round((p_ms - d_ms) / d_ms * 100.0, 2)
                if d_ms and p_ms is not None else None
            ),
        }

    from bdbnn_tpu_torch.serve.pool import single_engine_resident_block

    resident = single_engine_resident_block(
        primary["residency"], completed=primary["raw"]["completed"]
    )

    attribution = None
    if primary.get("tracer") is not None:
        attribution = primary["tracer"].attribution(
            device={
                # blocked-compute cross-check: idle calibration (the
                # time_step mean) next to the window measured under
                # the real serving interleave
                "time_step_ms": primary["step_ms"],
                **primary["step_stats"],
            }
        )

    verdict = slo_verdict(
        primary["raw"],
        primary["batcher_stats"],
        mode=cfg.mode,
        rate=cfg.rate,
        seed=cfg.seed,
        provenance=_serve_provenance(
            cfg.artifact, engine_meta, prov, recipe, manifest
        ),
        warmup_s=primary["warmup_s"],
        preempted=handler.preempted,
        drained_clean=all(p["drained_clean"] for p in passes.values()),
        resident=resident,
        packed=packed_block,
        attribution=attribution,
    )
    events.emit("serve", phase="verdict", **verdict)
    events.close()
    write_verdict_files(verdict, run_dir, cfg.out)
    return {"verdict": verdict, "run_dir": run_dir}



__all__ = [
    "SCENARIOS",
    "VERDICT_NAME",
    "VERDICT_SCHEMA_VERSION",
    "Arrival",
    "HttpLoadGenerator",
    "LoadGenerator",
    "build_schedule",
    "fairness_ratio",
    "http_slo_verdict",
    "percentile",
    "recv_response",
    "run_serve_bench",
    "slo_verdict",
    "write_verdict_files",
]

"""Cross-host serving fleet: the health-routed HTTP router — the port's
copy of ``bdbnn_tpu/serve/fleet.py``.

Pools scale cards; fleets scale hosts. Every host runs the port's
``serve-http`` unchanged — its own engine or replica pool, its own
admission control, its own drain contract — and this module puts a thin
router process in front of N of them, spreading traffic by health and
occupancy and surviving the failure modes a single host never sees: a
host dying mid-flash-crowd, a torn artifact replica, a peer that stopped
answering. The router is a byte proxy over the standard library's
sockets and threads: it decodes no body, does no tensor work and holds
no device (several hosts may share one card, each its own process with
its own CUDA context).

One consequence of the port's one-replica swap (serve/pool.py): a host
that swaps on its one replica sheds the batches of its shift window with
a well-formed 503, and the router relays that shed as it relays every
other one — it never retries it and never routes around a swapping host.
The fleet verdict's per-priority blocks count those sheds.

The contract, piece by piece:

- **Health-routed dispatch.** A prober polls every host's ``/readyz``
  (and ``/statsz`` for the live table) on an interval and runs the
  SHARED warmup→debounce→hysteresis state machine
  (:class:`bdbnn_tpu_torch.obs.health.DetectorState` — one discipline for
  training, canary and fleet health): the first ``warmup`` probes are
  never judged, a connect/timeout breach must persist ``debounce``
  consecutive probes before the host is declared ``dead``, and a dead
  host re-arms on the first successful probe. A host answering
  ``/readyz`` 503 is not dead — it is ``draining`` (SIGTERM landed) or
  ``warming`` (AOT compile running) and is routed around WITHOUT
  burning the failure detector. Dispatch picks the ready host with the
  lowest in-flight count (occupancy), round-robin on ties.

- **Retry with backoff, never a drop.** A request the router accepted
  is answered, period. A transport failure against one host — connect
  refused, per-attempt timeout, connection reset mid-exchange — is
  retried on a DIFFERENT host (up to ``max_attempts`` distinct hosts)
  with exponential backoff between attempts, and every retry is
  ledgered per host and per cause (``connect`` / ``timeout`` /
  ``reset``). Inference is deterministic and idempotent, so a request
  whose connection died after the backend started computing is safe to
  re-execute on a peer; the accounting counts it ONCE — against the
  host that actually answered. Only when every attempt is exhausted
  does the router answer 503 itself (``no host available``,
  ``retry-after`` set) — an explicit shed, never a dropped connection.

- **Load-shed taxonomy preserved end-to-end.** A WELL-FORMED backend
  response is relayed verbatim, never retried: a 429 ``over_quota`` is
  THIS tenant's fault on every host (same quotas), and a 503
  ``draining``/``queue full`` re-executed elsewhere would turn one
  explicit shed into a duplicate execution the moment the first host
  answers after all. The router's per-priority ledger files relayed
  sheds under the backend's own reason (parsed from the shed body), so
  the fleet verdict's shed taxonomy reads exactly like a single
  host's.

- **Graceful degradation.** A draining host (``/readyz`` 503
  ``draining``) leaves the dispatch set immediately, bleeds its
  in-flight work (the host's own drain contract answers everything it
  accepted), and the fleet keeps serving at reduced capacity. The
  router's own ``drain()`` does the same one level up: latch, answer
  every in-flight proxy, then close the listener.

- **Fleet blue/green.** ``POST /fleet/swap`` (or ``--swap-at`` under a
  scenario) rolls the fleet host by host: first the target version is
  replicated into every host's registry by digest-verified
  :meth:`~bdbnn_tpu_torch.serve.registry.ArtifactRegistry.pull`, then each
  host's ``POST /admin/swap`` fires and the router POLLS that host's
  swap state machine to a TERMINAL state
  (:data:`bdbnn_tpu_torch.serve.pool.SWAP_TERMINAL_STATES`) before touching
  the next — a rollout can never take two hosts out of dispatch at
  once.

- **Fleet-consistent verdicts.** The run ends in a v6 SLO verdict
  whose ``fleet`` block carries the per-host ledgers (proxied /
  completed / relayed / retries-by-cause / probe transitions / p99),
  and those ledgers must SUM to the client's own observation —
  ``ledger_consistent`` is computed, not asserted, and the
  zero-dropped gate is now summed across hosts. ``compare`` judges
  ``serve_fleet_dropped`` (zero tolerance), ``serve_fleet_retry_rate``
  and ``serve_fleet_host_p99_spread``.

Events: the ``fleet`` kind (obs/events.py), phases ``start`` /
``ready`` / ``probe`` / ``proxy`` / ``pull`` / ``swap`` / ``stats`` /
``drain`` / ``stop``; the verdict lands as the usual ``serve``
``verdict`` event so ``watch``/``summarize``/``compare`` consume a
fleet run through the same pipeline as every other serving run.
"""

from __future__ import annotations

import json
import os
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from bdbnn_tpu_torch.obs.capacity import FleetCapacityWindows
from bdbnn_tpu_torch.obs.events import jsonsafe
from bdbnn_tpu_torch.obs.health import DetectorState
from bdbnn_tpu_torch.obs.rtrace import (
    STAGE_HEADER,
    TRACE_HEADER,
    FleetTracer,
    HostStatsWindows,
    encode_trace_context,
)
from bdbnn_tpu_torch.serve.http import PREDICT_PATH, _REASONS
from bdbnn_tpu_torch.serve.loadgen import _pct, recv_response

# retry causes the per-host ledger buckets by — the transport-failure
# taxonomy (a backend RESPONSE is never a retry cause: it is relayed)
RETRY_CAUSES = ("connect", "timeout", "reset")

# host states the prober assigns. "ready" is the only dispatchable one;
# "draining"/"warming" are the host's own explicit /readyz words (alive,
# not dispatchable — they never burn the failure detector); "dead" is
# the detector's debounced verdict on connect/timeout breaches.
HOST_WARMING = "warming"
HOST_READY = "ready"
HOST_DRAINING = "draining"
HOST_DEAD = "dead"


def backoff_s(attempt: int, base_s: float, cap_s: float) -> float:
    """The retry backoff schedule: ``base * 2^attempt`` capped — the
    exact sequence the schedule-pin test asserts, so a refactor cannot
    silently turn bounded backoff into a hot retry loop."""
    return min(base_s * (2.0 ** max(int(attempt), 0)), cap_s)


def _read_request(
    rfile, max_body: int
) -> Optional[Tuple[str, str, Dict[str, str], Optional[bytes]]]:
    """One HTTP/1.1 request off a buffered reader; None at EOF; body
    None signals over-``max_body`` (the caller answers 413)."""
    line = rfile.readline()
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3:
        raise ValueError(f"malformed request line: {line!r}")
    method, path, _version = parts
    headers: Dict[str, str] = {}
    while True:
        h = rfile.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    n = int(headers.get("content-length", 0) or 0)
    if n > max_body:
        return method, path, headers, None
    body = rfile.read(n) if n else b""
    if len(body) != n:
        raise ValueError("truncated request body")
    return method, path, headers, body


def _head_bytes(
    status: int, headers: Dict[str, str], body: bytes, *, close: bool
) -> bytes:
    head = (
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
        f"content-length: {len(body)}\r\n"
    )
    for name, value in headers.items():
        head += f"{name}: {value}\r\n"
    if close:
        head += "connection: close\r\n"
    return head.encode("latin-1") + b"\r\n"


class HostState:
    """One backend host's live record inside the router.

    Every mutable field is guarded by the ROUTER's lock, shared into
    each host record (one lock for the whole table: the proxy path
    touches a host's counters and the router's aggregates in one
    logical step, and a per-host lock would just invite ordering
    bugs). The DetectorState is deliberately NOT guarded: the probe
    loop is its single writer by construction.
    """

    def __init__(
        self, idx: int, label: str, host: str, port: int,
        lock: "threading.RLock", warmup: int, debounce: int,
    ):
        self.idx = idx
        self.label = label
        self.host = host
        self.port = int(port)
        self._lock = lock  # the router's lock, shared — see class doc
        self.detector = DetectorState(warmup, debounce)  # prober-only
        # guarded-by: _lock: state, server_id, inflight, proxied, completed, responses_by_status, retries, retried_away, consecutive_failures, backoff_until, probes, transitions, lat_ms, last_statsz
        self.state = HOST_WARMING
        self.server_id: Optional[str] = None
        self.inflight = 0
        self.proxied = 0
        self.completed = 0
        self.responses_by_status: Dict[int, int] = {}
        self.retries: Dict[str, int] = {c: 0 for c in RETRY_CAUSES}
        self.retried_away = 0
        self.consecutive_failures = 0
        self.backoff_until = 0.0
        self.probes = 0
        self.transitions = 0
        self.lat_ms: List[float] = []
        self.last_statsz: Optional[Dict[str, Any]] = None

    def snapshot(self) -> Dict[str, Any]:  # requires-lock: _lock
        """The per-host row of ``/statsz``, the ``fleet`` stats event
        and the verdict's fleet block — one shape, three consumers."""
        relayed_other = sum(
            n for s, n in self.responses_by_status.items()
            if s not in (200, 429, 503)
        )
        return {
            "host": self.host,
            "port": self.port,
            "state": self.state,
            "server_id": self.server_id,
            "inflight": self.inflight,
            "proxied": self.proxied,
            "completed": self.completed,
            "relayed_429": self.responses_by_status.get(429, 0),
            "relayed_503": self.responses_by_status.get(503, 0),
            "relayed_other": relayed_other,
            "retries": dict(self.retries),
            "retried_away": self.retried_away,
            "probes": self.probes,
            "probe_transitions": self.transitions,
            "p99_ms": _pct(sorted(self.lat_ms), 99.0),
        }


class _RouterServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    router: "FleetRouter"


class _RouterHandler(socketserver.StreamRequestHandler):
    # idle keep-alive connections are reaped so drain converges; a
    # torn keep-alive is exactly what the load generator's
    # reconnect-once path exists for
    timeout = 60.0

    def handle(self) -> None:
        router = self.server.router
        while True:
            try:
                req = _read_request(self.rfile, router.max_body_bytes)
            except (ValueError, OSError):
                break
            if req is None:
                break
            method, path, headers, body = req
            close = headers.get("connection", "").lower() == "close"
            try:
                if body is None:
                    self.wfile.write(_head_bytes(
                        413, {"content-type": "application/json"},
                        b'{"error": "payload too large"}', close=True,
                    ) + b'{"error": "payload too large"}')
                    self.wfile.flush()
                    break
                status, out_headers, out_body = router.handle_request(
                    method, path, headers, body
                )
                do_close = close or router.draining
                self.wfile.write(
                    _head_bytes(
                        status, out_headers, out_body, close=do_close
                    )
                    + out_body
                )
                self.wfile.flush()
            except (OSError, ConnectionError):
                break
            if close or router.draining:
                break


class FleetRouter:
    """The fleet's traffic spreader: N backend serve-http hosts behind
    one listener, health-routed, retry-ledgered, swap-orchestrated.

    Thread shape: one acceptor thread (``serve_forever``), one handler
    thread per client connection (proxying is blocking I/O), one
    prober thread, and at most one fleet-swap thread. All shared state
    sits behind ONE reentrant lock (each :class:`HostState` shares
    it); the drain latch and stop flags are Events.
    """

    def __init__(
        self,
        hosts: List[Tuple[str, int]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        priorities: int = 3,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 1.0,
        proxy_timeout_s: float = 60.0,
        max_attempts: int = 3,
        backoff_base_s: float = 0.025,
        backoff_cap_s: float = 0.25,
        health_warmup: int = 0,
        health_debounce: int = 2,
        retry_after_s: int = 1,
        max_body_bytes: int = 16 * 2**20,
        registry: str = "",
        host_registries: Tuple[str, ...] = (),
        swap_host_timeout_s: float = 120.0,
        on_event: Optional[Callable[..., Any]] = None,
        tracer: Optional[FleetTracer] = None,
        scrape_timeout_s: float = 0.5,
        scrape_stale_after: int = 3,
        scrape_window: int = 64,
    ):
        self.host = host
        self.port = int(port)
        self.priorities = max(int(priorities), 1)
        self.default_priority = self.priorities - 1
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.max_attempts = max(int(max_attempts), 1)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.retry_after_s = int(retry_after_s)
        self.max_body_bytes = int(max_body_bytes)
        self.registry_root = registry
        self.host_registries = tuple(host_registries)
        self.swap_host_timeout_s = float(swap_host_timeout_s)
        self.on_event = on_event
        # cross-host tracing (obs/rtrace.py): when wired, every
        # proxied predict carries a minted trace context and its
        # router stages + the backend's stitched stage block roll into
        # the v7 fleet_attribution. The scrape plane (HostStatsWindows,
        # internally locked) merges each host's /statsz rtrace block
        # on the stats pump's bounded-timeout schedule.
        self.tracer = tracer
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.scrape = HostStatsWindows(
            window=int(scrape_window),
            stale_after=int(scrape_stale_after),
        )
        # the fleet capacity merge (obs/capacity.py): per-host scraped
        # capacity blocks under the SAME staleness discipline as the
        # rtrace windows above — internally locked, fed only by the
        # scrape pump
        self.capacity = FleetCapacityWindows(
            stale_after=int(scrape_stale_after),
        )
        # ONE reentrant lock for the whole router (host table included):
        # reentrancy makes an accidental nested acquire harmless, and
        # the condition below shares it so drain's inflight-zero wait
        # cannot race a proxy between accounting and decrement
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self.hosts = [
            HostState(
                i, f"h{i}", h, p, self._lock,
                health_warmup, health_debounce,
            )
            for i, (h, p) in enumerate(hosts)
        ]
        # guarded-by: _lock: _inflight, _rr, _counts, _lats, _arrival_stamps, _unrouteable, _shed_draining, _t_started, _t_drained, _swap, _swap_thread
        self._inflight = 0
        # observed proxy arrival stamps: the MEASURED offered rate
        # serve-mode fleet verdicts report (never a config figure)
        self._arrival_stamps: List[float] = []
        self._rr = 0
        self._counts: List[Dict[str, int]] = [
            {"submitted": 0, "completed": 0, "failed": 0,
             "rejected": 0, "shed_draining": 0, "shed_over_quota": 0,
             "shed_queue_full": 0, "shed_unavailable": 0}
            for _ in range(self.priorities)
        ]
        self._lats: List[List[float]] = [
            [] for _ in range(self.priorities)
        ]
        self._unrouteable = 0
        self._shed_draining = 0
        self._t_started: Optional[float] = None
        self._t_drained: Optional[float] = None
        self._swap: Optional[Dict[str, Any]] = None
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._server: Optional[_RouterServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._swap_thread: Optional[threading.Thread] = None

    # -- events ---------------------------------------------------------

    def _emit(self, kind: str, **fields: Any) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(kind, **fields)
        except Exception:
            pass  # telemetry must never take the dispatch path down

    # -- lifecycle ------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def start(self) -> Tuple[str, int]:
        srv = _RouterServer((self.host, self.port), _RouterHandler)
        srv.router = self
        self._server = srv
        self.port = srv.server_address[1]
        self._server_thread = threading.Thread(
            target=srv.serve_forever, name="fleet-router", daemon=True,
            kwargs={"poll_interval": 0.1},
        )
        self._server_thread.start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-prober", daemon=True
        )
        self._probe_thread.start()
        return self.host, self.port

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until at least one host probes ready (dispatch is
        possible) or the timeout lapses."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if any(h.state == HOST_READY for h in self.hosts):
                    return True
            if self._stop.is_set():
                return False
            time.sleep(0.02)
        return False

    def wait_swap(self, timeout: Optional[float] = None) -> bool:
        """Block until an in-flight fleet swap settles (the http.py
        ``admin.wait`` precedent): a rollout legitimately still
        rolling when the load generator finishes must reach its
        terminal state — and its terminal event — BEFORE the drain
        snapshots the verdict, or a successful run reads as a torn
        'shifting' failure."""
        with self._lock:
            t = self._swap_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def drain(self, timeout: float = 30.0) -> bool:
        """Latch the drain flag (new predicts answered 503 draining),
        wait for every in-flight proxy's response to be written, stop
        the prober, then close the listener. Idempotent."""
        self._draining.set()
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            clean = self._inflight == 0
            if self._t_drained is None:
                self._t_drained = time.perf_counter()
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(max(deadline - time.monotonic(), 0.1))
        with self._lock:
            swap_thread = self._swap_thread
        if swap_thread is not None:
            swap_thread.join(max(deadline - time.monotonic(), 0.1))
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._server_thread is not None:
            self._server_thread.join(
                max(deadline - time.monotonic(), 0.1)
            )
            clean = clean and not self._server_thread.is_alive()
        return clean

    # -- health probing -------------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            for h in self.hosts:
                if self._stop.is_set():
                    return
                self._probe_host(h)

    def _probe_host(self, h: HostState) -> None:
        ok = False
        word = None
        statsz: Optional[Dict[str, Any]] = None
        try:
            status, _headers, body = self._request_host(
                h, "GET", "/readyz", {}, b"",
                timeout=self.probe_timeout_s,
            )
            ok = True  # the host ANSWERED: alive, whatever the status
            try:
                word = (json.loads(body) or {}).get("state")
            except Exception:
                word = None
            if word not in (HOST_READY, HOST_DRAINING, HOST_WARMING):
                word = HOST_READY if status == 200 else HOST_WARMING
        except (OSError, ValueError, ConnectionError):
            ok = False
        if ok:
            # /statsz is ENRICHMENT only (live table, server_id): a
            # host that answers /readyz is alive, and a failed or slow
            # statsz fetch must never feed the failure detector — it
            # just leaves the last snapshot stale
            try:
                s_status, _h2, s_body = self._request_host(
                    h, "GET", "/statsz", {}, b"",
                    timeout=self.probe_timeout_s,
                )
                if s_status == 200:
                    statsz = json.loads(s_body)
            except (OSError, ValueError, ConnectionError):
                statsz = None
        transition = None
        with h._lock:
            h.probes += 1
            # the shared warmup -> debounce -> hysteresis discipline:
            # fired exactly once per dead episode; a successful probe
            # is the recovery signal that re-arms the detector
            fired = h.detector.update(not ok, recovered=ok)
            if ok:
                new = word
                if statsz is not None:
                    h.last_statsz = {
                        k: statsz.get(k)
                        for k in ("inflight", "requests_seen", "state")
                    }
                    h.server_id = statsz.get("server_id")
                h.consecutive_failures = 0
                h.backoff_until = 0.0
            elif fired or h.state == HOST_DEAD:
                new = HOST_DEAD
            else:
                # breach not yet debounced: keep the last known state
                # (one blip must not evict a host mid-flash-crowd)
                new = h.state
            if new != h.state:
                h.transitions += 1
                old, h.state = h.state, new
                transition = (old, new)
        if transition is not None:
            self._emit(
                "fleet", phase="probe", host=h.label,
                state_from=transition[0], state_to=transition[1],
            )

    # -- dispatch -------------------------------------------------------

    def _pick_host(self, exclude) -> Optional[HostState]:
        """Least-occupancy over the ready set (round-robin on ties),
        skipping hosts in retry backoff unless nothing else is left —
        a backoff host beats an unconditional shed."""
        now = time.monotonic()
        with self._lock:
            ready = [
                h for h in self.hosts
                if h.label not in exclude and h.state == HOST_READY
            ]
            usable = [h for h in ready if now >= h.backoff_until]
            pool = usable or ready
            if not pool:
                return None
            self._rr += 1
            rr = self._rr
            return min(
                pool,
                key=lambda h: (h.inflight, (h.idx - rr) % len(self.hosts)),
            )

    def _request_host(
        self, h: HostState, method: str, path: str,
        headers: Dict[str, str], body: bytes, *, timeout: float,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One request/response exchange with a backend over a fresh
        connection (connection: close — the backend's drain grace then
        never waits on the router's idle keep-alives)."""
        return self._request_host_timed(
            h, method, path, headers, body, timeout=timeout
        )[:3]

    def _request_host_timed(
        self, h: HostState, method: str, path: str,
        headers: Dict[str, str], body: bytes, *, timeout: float,
    ) -> Tuple[int, Dict[str, str], bytes, float, float]:
        """:meth:`_request_host` plus the trace's connect/exchange
        split, both measured on the ROUTER's clock: ``connect_ms`` is
        the TCP establish, ``exchange_ms`` the wall from first request
        byte sent to response fully received. The trace charges the
        attempt's full wall (not these timers alone) so the stage sum
        reconciles with the trace total by construction; the
        ``network`` stage is the wall's residual minus the backend's
        self-reported span — never a cross-clock subtract."""
        t0 = time.perf_counter()
        sock = socket.create_connection((h.host, h.port), timeout=timeout)
        t_conn = time.perf_counter()
        try:
            sock.settimeout(timeout)
            head = (
                f"{method} {path} HTTP/1.1\r\n"
                f"host: {h.host}:{h.port}\r\n"
                "connection: close\r\n"
            )
            for name in (
                "x-priority", "x-tenant", "x-model", "content-type",
                TRACE_HEADER,
            ):
                if name in headers:
                    head += f"{name}: {headers[name]}\r\n"
            head += f"content-length: {len(body)}\r\n\r\n"
            sock.sendall(head.encode("latin-1") + body)
            rfile = sock.makefile("rb")
            try:
                status, rheaders, rbody = recv_response(rfile)
            finally:
                rfile.close()
            return (
                status, rheaders, rbody,
                (t_conn - t0) * 1000.0,
                (time.perf_counter() - t_conn) * 1000.0,
            )
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _proxy_predict(
        self, headers: Dict[str, str], body: bytes, priority: int,
        trace=None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """The retry/relay core: try distinct hosts on transport
        failures (ledgered per host and per cause, backoff between
        attempts); RELAY the first well-formed response verbatim.

        When tracing is wired, the router stages stamp here:
        ``probe_wait`` (request parse -> first pick, i.e. the cv wait
        on probed router state), ``pick`` per host selection,
        ``connect``/``network`` on the successful attempt, and one
        ``retry_hop`` per failed attempt — the attempt's wall PLUS the
        backoff sleep it incurred, charged to that attempt."""
        tried: set = set()
        if trace is not None:
            trace.stamp("probe_wait")
            headers = dict(headers)
            headers[TRACE_HEADER] = encode_trace_context(
                trace.trace_id, trace.seq, priority,
                headers.get("x-tenant"),
            )
        for attempt in range(self.max_attempts):
            h = self._pick_host(tried)
            if h is None:
                break
            if trace is not None:
                trace.stamp("pick")
            tried.add(h.label)
            with h._lock:
                h.inflight += 1
                h.proxied += 1
            t0 = time.perf_counter()
            cause = None
            try:
                (
                    status, rheaders, rbody, connect_ms, exchange_ms,
                ) = self._request_host_timed(
                    h, "POST", PREDICT_PATH, headers, body,
                    timeout=self.proxy_timeout_s,
                )
            except (socket.timeout, TimeoutError):
                cause = "timeout"
            except ConnectionRefusedError:
                cause = "connect"
            except (ConnectionError, BrokenPipeError):
                cause = "reset"
            except (OSError, ValueError):
                cause = "connect"
            if cause is not None:
                with h._lock:
                    h.inflight -= 1
                    h.retries[cause] = h.retries.get(cause, 0) + 1
                    h.retried_away += 1
                    h.consecutive_failures += 1
                    # the failing host backs off from dispatch on its
                    # own schedule, independent of the probe cadence
                    h.backoff_until = time.monotonic() + backoff_s(
                        h.consecutive_failures - 1,
                        self.backoff_base_s, self.backoff_cap_s,
                    )
                self._emit(
                    "fleet", phase="proxy", host=h.label,
                    cause=cause, attempt=attempt,
                )
                # bounded backoff before the NEXT attempt: the peer
                # retry must not arrive as a synchronized hammer. No
                # sleep after the final attempt — the shed is already
                # decided and the wait would only delay the client's
                # explicit 503 (and drain convergence)
                if attempt < self.max_attempts - 1:
                    time.sleep(backoff_s(
                        attempt, self.backoff_base_s,
                        self.backoff_cap_s,
                    ))
                if trace is not None:
                    trace.stamp("retry_hop")
                continue
            t_done = time.perf_counter()
            lat_ms = (t_done - t0) * 1000.0
            if trace is not None:
                # reconciliation by construction (the backend header's
                # own discipline, one hop up): charge the attempt's
                # FULL wall since the last stamp — `connect` gets the
                # measured TCP establish, and the residual (exchange
                # plus the router's own pre-connect/post-read slop the
                # socket timer cannot see) goes to the stitcher, which
                # splits it into backend span + `network`. The stage
                # sum then equals the trace wall exactly, so the
                # cross-hop identity never flags scheduler slop on a
                # contended box as misattribution.
                elapsed_ms = (t_done - trace._last) * 1000.0
                conn_ms = min(connect_ms, elapsed_ms)
                trace.add("connect", conn_ms)
                trace.attempts = attempt + 1
                self.tracer.stitch(
                    trace, elapsed_ms - conn_ms,
                    rheaders.get(STAGE_HEADER), h.label,
                )
                trace.sync(at=t_done)
            with h._lock:
                h.inflight -= 1
                h.consecutive_failures = 0
                h.backoff_until = 0.0
                h.responses_by_status[status] = (
                    h.responses_by_status.get(status, 0) + 1
                )
                if status == 200:
                    h.completed += 1
                    h.lat_ms.append(lat_ms)
            out_headers = {
                "content-type": rheaders.get(
                    "content-type", "application/json"
                ),
                "x-served-by": h.label,
            }
            if "retry-after" in rheaders:
                out_headers["retry-after"] = rheaders["retry-after"]
            self._ledger_response(priority, status, rbody, lat_ms=(
                lat_ms if status == 200 else None
            ))
            return status, out_headers, rbody
        # every attempt exhausted (or zero dispatchable hosts): the
        # router's OWN explicit shed — an answer, never a hang
        with self._lock:
            self._unrouteable += 1
            self._counts[priority]["shed_unavailable"] += 1
        body_out = json.dumps(
            {"error": "no host available", "tried": sorted(tried)}
        ).encode()
        return 503, {
            "content-type": "application/json",
            "retry-after": str(self.retry_after_s),
        }, body_out

    def _ledger_response(
        self, priority: int, status: int, rbody: bytes,
        lat_ms: Optional[float],
    ) -> None:
        """File one RELAYED response under the backend's own shed
        taxonomy (parsed from the shed body), so the fleet verdict's
        per-priority blocks read exactly like a single host's."""
        reason = None
        if status in (429, 503):
            try:
                reason = (json.loads(rbody) or {}).get("error")
            except Exception:
                reason = None
        with self._lock:
            c = self._counts[priority]
            if status == 200:
                c["completed"] += 1
                if lat_ms is not None:
                    self._lats[priority].append(lat_ms)
            elif status == 429:
                c["shed_over_quota"] += 1
            elif status == 503:
                if reason == "draining":
                    c["shed_draining"] += 1
                elif reason == "no healthy replica":
                    c["shed_unavailable"] += 1
                else:
                    c["shed_queue_full"] += 1
            elif 400 <= status < 500:
                c["rejected"] += 1
            else:
                c["failed"] += 1

    # -- request routing ------------------------------------------------

    def handle_request(
        self, method: str, path: str, headers: Dict[str, str],
        body: bytes,
    ) -> Tuple[int, Dict[str, str], bytes]:
        json_h = {"content-type": "application/json"}

        def respond(status: int, obj: Any, **extra: str):
            return status, {**json_h, **extra}, json.dumps(
                jsonsafe(obj)
            ).encode()

        if method == "GET" and path == "/healthz":
            with self._lock:
                ready = sum(
                    1 for h in self.hosts if h.state == HOST_READY
                )
            return respond(200, {
                "status": "ok",
                "role": "fleet-router",
                "hosts_ready": ready,
                "hosts_total": len(self.hosts),
                "draining": self.draining,
            })
        if method == "GET" and path == "/readyz":
            if self.draining:
                return respond(
                    503, {"state": "draining"},
                    **{"retry-after": str(self.retry_after_s)},
                )
            with self._lock:
                any_ready = any(
                    h.state == HOST_READY for h in self.hosts
                )
            if not any_ready:
                return respond(
                    503, {"state": "warming"},
                    **{"retry-after": str(self.retry_after_s)},
                )
            return respond(200, {"state": "ready"})
        if method == "GET" and path in ("/statsz", "/fleet/hosts"):
            return respond(200, self.stats())
        if method == "GET" and path == "/fleet/swap":
            with self._lock:
                swap = dict(self._swap) if self._swap else {
                    "state": "idle"
                }
            return respond(200, swap)
        if method == "POST" and path == "/fleet/swap":
            try:
                spec = json.loads(body) if body else {}
            except Exception as e:
                return respond(400, {"error": f"undecodable body: {e}"})
            if not isinstance(spec, dict):
                return respond(
                    400, {"error": "swap body must be a JSON object"}
                )
            status, payload = self.start_fleet_swap(spec)
            return respond(status, payload)
        if method == "POST" and path == PREDICT_PATH:
            return self._handle_predict(headers, body)
        return respond(404, {"error": f"no route {method} {path}"})

    def _handle_predict(
        self, headers: Dict[str, str], body: bytes
    ) -> Tuple[int, Dict[str, str], bytes]:
        raw_p = headers.get("x-priority")
        if raw_p is None:
            priority = self.default_priority
        else:
            try:
                priority = int(raw_p)
            except ValueError:
                priority = -1
            if not 0 <= priority < self.priorities:
                return 400, {"content-type": "application/json"}, (
                    json.dumps({
                        "error": "bad x-priority",
                        "want": f"int in [0, {self.priorities})",
                        "got": raw_p,
                    }).encode()
                )
        # the trace begins BEFORE the cv block so probe_wait charges
        # the router-state wait a request actually experienced
        trace = (
            self.tracer.begin(priority, headers.get("x-tenant"))
            if self.tracer is not None else None
        )
        with self._cv:
            if self._t_started is None:
                # the verdict wall clock starts at the first routed
                # request — warmup idle must not dilute throughput
                self._t_started = time.perf_counter()
            self._counts[priority]["submitted"] += 1
            self._arrival_stamps.append(time.perf_counter())
            if self._draining.is_set():
                self._counts[priority]["shed_draining"] += 1
                self._shed_draining += 1
                if trace is not None:
                    self.tracer.abort(trace)
                return 503, {
                    "content-type": "application/json",
                    "retry-after": str(self.retry_after_s),
                }, b'{"error": "draining"}'
            self._inflight += 1
        try:
            status, out_headers, out_body = self._proxy_predict(
                headers, body, priority, trace
            )
            if trace is not None:
                # only a relayed 200 is a served request; a relayed
                # shed/reject or the router's own 503 must never read
                # as a fast fleet serve
                if status == 200:
                    self.tracer.finish(trace)
                else:
                    self.tracer.abort(trace)
            return status, out_headers, out_body
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    # -- fleet blue/green ----------------------------------------------

    def start_fleet_swap(
        self, spec: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        """Kick the host-by-host rollout thread. 202 accepted / 409
        already rolling / 400 bad spec."""
        if "version" not in spec and "artifact" not in spec:
            return 400, {
                "error": 'swap body must carry {"version": N} or '
                '{"artifact": dir}',
            }
        with self._lock:
            if self._swap is not None and self._swap.get("state") in (
                "replicating", "shifting"
            ):
                return 409, {
                    "error": "a fleet swap is already in flight",
                    **dict(self._swap),
                }
            # the target set is SNAPSHOTTED at trigger time — the same
            # hosts hosts_total reports, so the done-report's
            # shifted/total ratio cannot disagree with the set that
            # actually shifted when a host transitions mid-rollout
            targets = [
                h for h in self.hosts if h.state == HOST_READY
            ]
            self._swap = {
                "state": "replicating",
                "target": spec.get("version", spec.get("artifact")),
                "hosts_total": len(targets),
                "hosts_shifted": [],
                "error": None,
                "seconds": None,
                # the port's one-replica hosts shed the batches of their
                # shift window (relayed, never retried): each host's own
                # swap report counts them, summed here
                "shed": 0,
                "shed_by_host": {},
            }
            snapshot = dict(self._swap)
            # the thread handle is published under the SAME lock as the
            # swap doc: wait_swap/drain racing a just-accepted trigger
            # must see either neither or both, or a verdict could
            # snapshot a legitimately-running swap as torn
            self._swap_thread = threading.Thread(
                target=self._run_fleet_swap, args=(dict(spec), targets),
                name="fleet-swap", daemon=True,
            )
            thread = self._swap_thread
        thread.start()
        return 202, snapshot

    def _run_fleet_swap(
        self, spec: Dict[str, Any], targets: List[HostState]
    ) -> None:
        from bdbnn_tpu_torch.serve.pool import SWAP_TERMINAL_STATES

        t0 = time.monotonic()

        def fail(err: str) -> None:
            with self._lock:
                if self._swap is not None:
                    self._swap["state"] = "failed"
                    self._swap["error"] = err
            self._emit("fleet", phase="swap", state="failed", error=err)

        # 1. replicate: the target version lands in every host registry
        #    by digest-verified pull BEFORE any host is asked to shift —
        #    a torn replica fails the rollout here, with vN fully
        #    serving everywhere
        if self.registry_root and "version" in spec:
            from bdbnn_tpu_torch.serve.registry import ArtifactRegistry

            seen: set = set()
            for root in self.host_registries:
                if root in seen or os.path.abspath(
                    root
                ) == os.path.abspath(self.registry_root):
                    continue
                seen.add(root)
                try:
                    pulled = ArtifactRegistry(root).pull(
                        self.registry_root, int(spec["version"])
                    )
                except Exception as e:
                    fail(f"registry pull into {root!r}: {e}")
                    return
                self._emit(
                    "fleet", phase="pull", host_registry=root,
                    version=int(spec["version"]),
                    pulled=len(pulled),
                )
        with self._lock:
            if self._swap is not None:
                self._swap["state"] = "shifting"
        # 2. host by host, SERIALLY: fire the host's own blue/green and
        #    poll its swap state machine to a terminal state before the
        #    next host — never two hosts out of dispatch at once
        for h in targets:
            # the host's swap state machine runs on ITS OWN thread
            # after the 202 — a poll landing before its first status
            # write would read the PREVIOUS swap's record. Snapshot the
            # pre-trigger status: a terminal state is only attributable
            # to THIS swap once an in-flight state was observed or the
            # status document CHANGED from the snapshot.
            try:
                _s0, _h0, b0 = self._request_host(
                    h, "GET", "/admin/swap", {}, b"",
                    timeout=self.probe_timeout_s * 10,
                )
                doc0 = json.loads(b0) or {}
                before = doc0.get("current") or {}
                before_last = doc0.get("last")
            except (OSError, ValueError, ConnectionError):
                before, before_last = {}, None
            try:
                status, _hh, rbody = self._request_host(
                    h, "POST", "/admin/swap", {
                        "content-type": "application/json"
                    }, json.dumps(spec).encode(),
                    timeout=self.probe_timeout_s * 10,
                )
            except (OSError, ValueError, ConnectionError) as e:
                fail(f"host {h.label}: swap trigger failed: {e}")
                return
            if status != 202:
                fail(
                    f"host {h.label}: swap rejected (HTTP {status}): "
                    f"{rbody[:200]!r}"
                )
                return
            deadline = time.monotonic() + self.swap_host_timeout_s
            final = None
            seen_inflight = False
            while time.monotonic() < deadline:
                try:
                    s2, _h2, b2 = self._request_host(
                        h, "GET", "/admin/swap", {}, b"",
                        timeout=self.probe_timeout_s * 10,
                    )
                    current = (
                        (json.loads(b2) or {}).get("current") or {}
                    )
                    state = current.get("state")
                except (OSError, ValueError, ConnectionError):
                    current, state = {}, None
                if state is not None and state not in (
                    SWAP_TERMINAL_STATES
                ):
                    seen_inflight = True
                elif state in SWAP_TERMINAL_STATES and (
                    seen_inflight or current != before
                ):
                    final = state
                    break
                time.sleep(0.2)
            if final != "done":
                fail(
                    f"host {h.label}: swap ended in state {final!r} "
                    f"(want 'done' within {self.swap_host_timeout_s}s)"
                )
                return
            shed = self._host_swap_shed(h, before_last)
            with self._lock:
                if self._swap is not None:
                    self._swap["hosts_shifted"].append(h.label)
                    self._swap["shed_by_host"][h.label] = shed
                    if shed is not None:
                        self._swap["shed"] += shed
            self._emit(
                "fleet", phase="swap", state="shifted", host=h.label,
                shed=shed,
            )
        seconds = round(time.monotonic() - t0, 3)
        shifted = {h.label for h in targets}
        # hosts OUTSIDE the trigger-time ready set (warming, draining,
        # dead) were not shifted and still serve the previous version
        # if they rejoin — the done report names them so a partial
        # rollout can never masquerade as full coverage
        unshifted = [
            h.label for h in self.hosts if h.label not in shifted
        ]
        with self._lock:
            if self._swap is not None:
                self._swap["state"] = "done"
                self._swap["seconds"] = seconds
                self._swap["hosts_unshifted"] = unshifted
        self._emit(
            "fleet", phase="swap", state="done", seconds=seconds,
            hosts_shifted=len(targets), hosts_unshifted=unshifted,
        )

    def _host_swap_shed(
        self, h: HostState, before_last: Any
    ) -> Optional[int]:
        """The requests ``h`` shed while its swap ran: the ``shed`` of
        the host's swap report (``GET /admin/swap`` ``last``), which the
        host writes just after its pool's state turns terminal — so it is
        read again, briefly, until it differs from the pre-trigger one.
        None when the host reports none."""
        for _ in range(10):
            try:
                _s, _h, b = self._request_host(
                    h, "GET", "/admin/swap", {}, b"",
                    timeout=self.probe_timeout_s * 10,
                )
                last = (json.loads(b) or {}).get("last")
            except (OSError, ValueError, ConnectionError):
                last = None
            if isinstance(last, dict) and last != before_last:
                shed = last.get("shed")
                return int(shed) if isinstance(shed, int) else None
            time.sleep(0.05)
        return None

    # -- reporting ------------------------------------------------------

    def scrape_host_stats(self) -> None:
        """One merge pass of the fleet metrics plane: GET every host's
        ``/statsz`` with the scrape's OWN bounded timeout and fold the
        ``rtrace`` block into that host's rolling windows. A wedged or
        dead host costs at most ``scrape_timeout_s`` and one failure
        count — it can never stall the pump; after ``stale_after``
        consecutive failures its window reads stale and drops out of
        the merged view. Called from the stats pump, never from the
        request path."""
        for h in self.hosts:
            if self._stop.is_set():
                return
            try:
                status, _, rbody = self._request_host(
                    h, "GET", "/statsz", {}, b"",
                    timeout=self.scrape_timeout_s,
                )
                block = None
                cap_block = None
                if status == 200:
                    payload = json.loads(rbody) or {}
                    block = payload.get("rtrace")
                    cap_block = payload.get("capacity")
                if isinstance(block, dict):
                    self.scrape.record(h.label, block)
                else:
                    self.scrape.record_failure(h.label)
                # the capacity merge follows the same discipline but
                # keeps its own staleness book: a host serving rtrace
                # without a capacity block (pre-v8) goes stale HERE
                # without poisoning the rtrace windows, and vice versa
                self.capacity.record(h.label, cap_block)
            except Exception:
                self.scrape.record_failure(h.label)
                self.capacity.record_failure(h.label)

    def stats(self) -> Dict[str, Any]:
        hosts: Dict[str, Any] = {}
        for h in self.hosts:
            with h._lock:
                hosts[h.label] = h.snapshot()
        with self._lock:
            ready = sum(
                1 for h in self.hosts if h.state == HOST_READY
            )
            swap = dict(self._swap) if self._swap else None
            out = {
                "role": "fleet-router",
                "draining": self.draining,
                "hosts_total": len(self.hosts),
                "hosts_ready": ready,
                "inflight": self._inflight,
                "unrouteable": self._unrouteable,
                "router_shed_draining": self._shed_draining,
                "hosts": hosts,
                "swap": swap,
            }
        # the live fleet metrics plane: the router's own cross-host
        # trace windows plus the per-host scraped windows (both
        # internally locked — never under the router lock above)
        out["rtrace"] = (
            self.tracer.stats() if self.tracer is not None else None
        )
        out["host_windows"] = self.scrape.snapshot()
        # the fleet-merged capacity view: per-host demand/headroom/burn
        # summaries + the merged-over-fresh-hosts totals — what the
        # router's own /statsz serves one level up
        out["capacity"] = self.capacity.snapshot()
        return jsonsafe(out)

    def accounting(self) -> Dict[str, Any]:
        """The post-drain ledger the fleet verdict is built from —
        the same shape as the HTTP front end's, so the verdict
        assembly reads identically one layer up."""
        with self._lock:
            t_end = self._t_drained or time.perf_counter()
            wall_s = (
                t_end - self._t_started
                if self._t_started is not None else 0.0
            )
            stamps = self._arrival_stamps
            measured_rate = None
            if len(stamps) >= 2 and stamps[-1] > stamps[0]:
                # (n-1) inter-arrival gaps over their observed span:
                # what actually hit the router, not a config knob
                measured_rate = round(
                    (len(stamps) - 1) / (stamps[-1] - stamps[0]), 4
                )
            return {
                "wall_s": wall_s,
                "latencies_ms_by_priority": [
                    sorted(l) for l in self._lats
                ],
                "counts_by_priority": [dict(c) for c in self._counts],
                "measured_rate_rps": measured_rate,
            }

    def capacity_block(self) -> Dict[str, Any]:
        """The fleet verdict's v8 ``capacity`` block: the per-host
        summaries + the merged-over-fresh-hosts view, with the three
        flat gates ``compare`` judges (``burn_rate_max``,
        ``headroom_rps``, ``demand_shed_ratio_max``) at the top level
        — same contract as a single host's block."""
        snap = self.capacity.snapshot()
        merged = snap["merged"]
        return {
            "fleet": snap,
            "burn_rate_max": merged["burn_rate_max"],
            "headroom_rps": merged["headroom_rps"],
            "demand_shed_ratio_max": merged["demand_shed_ratio_max"],
        }

    def fleet_block(
        self, client: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """The verdict's v6 ``fleet`` block: per-host ledgers + fleet
        totals + the consistency judgment against the client's own
        observation (computed, never assumed)."""
        stats = self.stats()
        hosts = stats["hosts"]
        with self._lock:
            submitted = sum(c["submitted"] for c in self._counts)
            unrouteable = self._unrouteable
            shed_draining = self._shed_draining
            swap = dict(self._swap) if self._swap else None
        completed_total = sum(h["completed"] for h in hosts.values())
        relayed_total = sum(
            h["relayed_429"] + h["relayed_503"] + h["relayed_other"]
            for h in hosts.values()
        )
        retries_total = sum(
            sum(h["retries"].values()) for h in hosts.values()
        )
        p99s = [
            h["p99_ms"] for h in hosts.values()
            if h["p99_ms"] is not None
        ]
        spread = (
            round(max(p99s) / max(min(p99s), 1e-9), 4)
            if len(p99s) >= 2 else None
        )
        # ledger consistency: every response the client saw must be
        # attributable — per-status — to exactly one host relay or one
        # router-origin shed; None when no client observed the run
        consistent = None
        if client is not None:
            expected: Dict[int, int] = {}
            for h in hosts.values():
                # snapshot carries the split; rebuild the status map
                expected[200] = expected.get(200, 0) + h["completed"]
                expected[429] = expected.get(429, 0) + h["relayed_429"]
                expected[503] = expected.get(503, 0) + h["relayed_503"]
            for hh in self.hosts:
                with hh._lock:
                    for s, n in hh.responses_by_status.items():
                        if s not in (200, 429, 503):
                            expected[s] = expected.get(s, 0) + n
            expected[503] = (
                expected.get(503, 0) + unrouteable + shed_draining
            )
            observed = {
                int(k): v
                for k, v in (client.get("by_status") or {}).items()
            }
            consistent = {
                k: v for k, v in expected.items() if v
            } == {k: v for k, v in observed.items() if v}
        return jsonsafe({
            "n_hosts": len(hosts),
            "hosts": hosts,
            "submitted": submitted,
            "completed_total": completed_total,
            "relayed_total": relayed_total,
            "router_unrouteable": unrouteable,
            "router_shed_draining": shed_draining,
            "retries_total": retries_total,
            "retry_rate": round(retries_total / max(submitted, 1), 6),
            "host_p99_spread": spread,
            "dropped": (
                None if client is None
                else int(client.get("dropped") or 0)
            ),
            "ledger_consistent": consistent,
            "swap": swap,
        })


# ---------------------------------------------------------------------------
# Verdict assembly + the serve-fleet orchestration (the CLI body)
# ---------------------------------------------------------------------------


def fleet_slo_verdict(
    accounting: Dict[str, Any],
    fleet: Dict[str, Any],
    *,
    scenario: str,
    rate: Optional[float],
    seed: int,
    provenance: Optional[Dict[str, Any]] = None,
    preempted: bool = False,
    drained_clean: bool = True,
    client: Optional[Dict[str, Any]] = None,
    slo_p99_ms: float = 0.0,
    fleet_attribution: Optional[Dict[str, Any]] = None,
    capacity: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Build the v7 verdict from the router's ledger: the same
    per-priority skeleton as the HTTP front end's verdict (so
    ``compare``/``summarize`` read a fleet run unchanged) plus the
    ``fleet`` block and — when the router traced — the
    ``fleet_attribution`` cross-host waterfall block."""
    from bdbnn_tpu_torch.serve.loadgen import slo_verdict

    lat_p = accounting["latencies_ms_by_priority"]
    counts_p = accounting["counts_by_priority"]
    per_priority: Dict[str, Dict[str, Any]] = {}
    all_lats: List[float] = []
    for p, (lats, counts) in enumerate(zip(lat_p, counts_p)):
        all_lats += lats
        shed = (
            counts["shed_draining"] + counts["shed_over_quota"]
            + counts["shed_queue_full"] + counts["shed_unavailable"]
        )
        per_priority[str(p)] = {
            "submitted": counts["submitted"],
            "completed": counts["completed"],
            "failed": counts["failed"],
            "rejected": counts["rejected"],
            "shed": shed,
            "shed_draining": counts["shed_draining"],
            "shed_over_quota": counts["shed_over_quota"],
            "shed_queue_full": counts["shed_queue_full"],
            "shed_unavailable": counts["shed_unavailable"],
            "shed_rate": round(shed / max(counts["submitted"], 1), 6),
            "p50_ms": _pct(lats, 50.0),
            "p95_ms": _pct(lats, 95.0),
            "p99_ms": _pct(lats, 99.0),
        }
    submitted = sum(c["submitted"] for c in counts_p)
    completed = sum(c["completed"] for c in counts_p)
    failed = sum(c["failed"] for c in counts_p)
    rejected = sum(c["rejected"] for c in counts_p)
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
        {},  # no batcher at the router: occupancy fields land null
        mode="fleet",
        rate=rate,
        seed=seed,
        provenance=provenance,
        preempted=preempted,
        drained_clean=drained_clean,
        scenario=scenario,
        per_priority=per_priority,
        client=client,
        slo=slo,
        fleet=fleet,
        fleet_attribution=fleet_attribution,
        capacity=capacity,
    )


def parse_hosts(specs) -> List[Tuple[str, int]]:
    """``("127.0.0.1:8100", ...)`` -> [(host, port), ...]."""
    out = []
    for spec in specs:
        host, _, port = str(spec).rpartition(":")
        out.append((host, int(port)))
    return out


def _scenario_bodies(
    artifact_dir: str, seed: int, n_bodies: int = 8
) -> Tuple[List[bytes], int]:
    """Deterministic raw-float32 request bodies shaped from the
    artifact's own manifest — a stdlib read (no weights, no numpy, no
    JAX): the router is a byte proxy and must stay importable
    anywhere."""
    with open(os.path.join(artifact_dir, "artifact.json")) as f:
        artifact = json.load(f)
    size = int(artifact["image_size"])
    n = size * size * 3
    rnd = random.Random(seed)
    bodies = [
        struct.pack(
            f"<{n}f", *(rnd.uniform(-2.0, 2.0) for _ in range(n))
        )
        for _ in range(n_bodies)
    ]
    return bodies, n * 4


def run_serve_fleet(cfg, on_arrival=None) -> Dict[str, Any]:
    """End-to-end fleet serving (the ``serve-fleet`` CLI body).
    ``cfg`` is a :class:`bdbnn_tpu_torch.serve.config.ServeFleetConfig`;
    the backend hosts are EXISTING serve-http processes (brought up by
    an operator, a supervisor, or the fleet e2e's subprocess harness).
    ``on_arrival`` (tests only) observes each offered schedule index —
    the fault-injection hook the SIGTERM-mid-flash-crowd acceptance
    drives its kill through."""
    from bdbnn_tpu_torch.train.resilience import PreemptionHandler

    cfg = cfg.validate()
    with PreemptionHandler() as handler:
        return _serve_fleet_body(cfg, handler, on_arrival)


def _serve_fleet_body(cfg, handler, on_arrival=None) -> Dict[str, Any]:
    import datetime

    from bdbnn_tpu_torch.obs.events import EventWriter
    from bdbnn_tpu_torch.obs.manifest import write_manifest
    from bdbnn_tpu_torch.serve.loadgen import (
        HttpLoadGenerator,
        build_schedule,
        write_verdict_files,
    )

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = os.path.join(cfg.log_path, stamp)
    os.makedirs(run_dir, exist_ok=True)
    recipe: Dict[str, Any] = {}
    if cfg.artifact:
        try:
            with open(
                os.path.join(cfg.artifact, "artifact.json")
            ) as f:
                art = json.load(f)
            recipe = (art.get("provenance") or {}).get("recipe") or {}
        except (OSError, ValueError):
            recipe = {}
    manifest = write_manifest(
        run_dir,
        {
            "mode": "serve-fleet",
            "hosts": list(cfg.hosts),
            "artifact": (
                os.path.abspath(cfg.artifact) if cfg.artifact else None
            ),
            **{k: v for k, v in recipe.items() if v is not None},
            "priorities": cfg.priorities,
            "scenario": cfg.scenario or None,
            "rate": cfg.rate,
            "requests": cfg.requests,
            "seed": cfg.seed,
            "probe_interval_s": cfg.probe_interval_s,
            "health_warmup": cfg.health_warmup,
            "health_debounce": cfg.health_debounce,
            "max_attempts": cfg.max_attempts,
            "backoff_base_ms": cfg.backoff_base_ms,
            "backoff_cap_ms": cfg.backoff_cap_ms,
            "registry": (
                os.path.abspath(cfg.registry) if cfg.registry else None
            ),
            "swap_to": cfg.swap_to or None,
            "swap_at": cfg.swap_at or None,
        },
        # the router holds no engine and touches no card: its manifest
        # records the host it runs on
        device="cpu",
    )
    events = EventWriter(
        run_dir, max_bytes=int(cfg.events_max_mb * 2**20)
    )
    tracer = None
    if cfg.rtrace:
        tracer = FleetTracer(
            sample_every=cfg.rtrace_sample_every,
            tail_k=cfg.rtrace_tail_k,
            seed=cfg.seed,
            on_sample=lambda wf: events.emit(
                "rtrace", phase="request", **wf
            ),
        )
    router = FleetRouter(
        parse_hosts(cfg.hosts),
        host=cfg.host,
        port=cfg.port,
        priorities=cfg.priorities,
        probe_interval_s=cfg.probe_interval_s,
        probe_timeout_s=cfg.probe_timeout_s,
        proxy_timeout_s=cfg.proxy_timeout_s,
        max_attempts=cfg.max_attempts,
        backoff_base_s=cfg.backoff_base_ms / 1000.0,
        backoff_cap_s=cfg.backoff_cap_ms / 1000.0,
        health_warmup=cfg.health_warmup,
        health_debounce=cfg.health_debounce,
        registry=cfg.registry,
        host_registries=cfg.host_registries,
        swap_host_timeout_s=cfg.swap_host_timeout_s,
        on_event=lambda kind, **f: events.emit(kind, **f),
        tracer=tracer,
        scrape_timeout_s=cfg.scrape_timeout_s,
        scrape_stale_after=cfg.scrape_stale_after,
    )
    host, port = router.start()
    events.emit(
        "fleet",
        phase="start",
        host=host,
        port=port,
        hosts=list(cfg.hosts),
        priorities=cfg.priorities,
        scenario=cfg.scenario or None,
        rate_rps=cfg.rate if cfg.scenario else None,
        requests=cfg.requests if cfg.scenario else None,
    )
    if not router.wait_ready(timeout=cfg.ready_timeout_s):
        router.drain(timeout=5.0)
        events.emit("fleet", phase="stop", host=host, port=port)
        events.close()
        raise RuntimeError(
            f"no backend host probed ready within "
            f"{cfg.ready_timeout_s:.0f}s — are the serve-http hosts "
            f"up at {list(cfg.hosts)}?"
        )
    events.emit("fleet", phase="ready", host=host, port=port)

    stats_stop = threading.Event()

    def stats_pump():
        while not stats_stop.wait(cfg.stats_interval_s):
            # scrape first so the heartbeat carries windows no older
            # than one pump period; each host is bounded by the
            # scrape's own timeout, so a wedged host cannot stall this
            router.scrape_host_stats()
            events.emit("fleet", phase="stats", **router.stats())

    pump = threading.Thread(target=stats_pump, daemon=True)
    pump.start()

    client_raw = None
    try:
        if cfg.scenario:
            bodies, _nbytes = _scenario_bodies(cfg.artifact, cfg.seed)
            schedule = build_schedule(
                cfg.scenario,
                requests=cfg.requests,
                rate=cfg.rate,
                seed=cfg.seed,
                priorities=cfg.priorities,
                priority_weights=(
                    list(cfg.priority_weights)
                    if cfg.priority_weights else None
                ),
                tenants=cfg.tenants,
                tenant_weights=(
                    list(cfg.tenant_weights)
                    if cfg.tenant_weights else None
                ),
                flash_factor=cfg.flash_factor,
                diurnal_amp=cfg.diurnal_amp,
                heavy_sigma=cfg.heavy_sigma,
                slow_fraction=cfg.slow_fraction,
            )
            hooks: List[Callable[[int], None]] = []
            if on_arrival is not None:
                hooks.append(on_arrival)
            if cfg.swap_at > 0:
                threshold = max(int(cfg.swap_at * len(schedule)), 1)
                swap_fired: List[bool] = []
                from bdbnn_tpu_torch.serve.registry import (
                    looks_like_version,
                    parse_version,
                )

                if cfg.registry and looks_like_version(cfg.swap_to):
                    swap_spec: Dict[str, Any] = {
                        "version": parse_version(cfg.swap_to)
                    }
                else:
                    swap_spec = {"artifact": cfg.swap_to}

                def _swap_hook(i: int) -> None:
                    if not swap_fired and i + 1 >= threshold:
                        swap_fired.append(True)
                        status, payload = router.start_fleet_swap(
                            swap_spec
                        )
                        # the payload's own "state" (replicating) would
                        # collide with the event's: the reference's emit
                        # raises there, inside the load generator's
                        # hook guard, and its trigger event never lands
                        events.emit(
                            "fleet", phase="swap", state="trigger",
                            at_request=i + 1, of=len(schedule),
                            status=status, swap_state=payload.get("state"),
                            **{k: v for k, v in payload.items()
                               if k != "state"},
                        )

                hooks.append(_swap_hook)

            def chained(i: int) -> None:
                for hook in hooks:
                    hook(i)

            gen = HttpLoadGenerator(
                host,
                port,
                schedule,
                body_fn=lambda i: bodies[i % len(bodies)],
                concurrency=cfg.concurrency,
                stop_fn=lambda: handler.preempted,
                slow_chunks=cfg.slow_chunks,
                slow_gap_s=cfg.slow_gap_ms / 1000.0,
                on_arrival=chained if hooks else None,
            )
            client_raw = gen.run()
        else:
            while not handler.preempted:
                time.sleep(0.1)
    finally:
        preempted = handler.preempted
        events.emit(
            "fleet",
            phase="drain",
            signum=handler.signum,
            preempted=preempted,
        )
        # let an in-flight fleet rollout settle before the router
        # winds down — its terminal report belongs in the verdict
        # either way (one full per-host shift budget per host)
        router.wait_swap(
            timeout=cfg.swap_host_timeout_s * max(len(cfg.hosts), 1)
        )
        drained_clean = router.drain(timeout=60.0)
        stats_stop.set()
        pump.join(timeout=5.0)

    fleet = router.fleet_block(client=client_raw)
    accounting = router.accounting()
    verdict = fleet_slo_verdict(
        accounting,
        fleet,
        scenario=cfg.scenario or "fleet",
        # scenario mode records the SCHEDULED rate; serve mode records
        # the MEASURED offered rate from observed arrival stamps —
        # cfg.rate there would fabricate a figure nothing measured
        rate=(
            cfg.rate if cfg.scenario
            else accounting["measured_rate_rps"]
        ),
        seed=cfg.seed,
        provenance={
            "hosts": list(cfg.hosts),
            "artifact": (
                os.path.abspath(cfg.artifact) if cfg.artifact else None
            ),
            "config_hash": None,
            "recipe": recipe,
            "serve_config_hash": manifest.get("config_hash"),
        },
        preempted=preempted,
        drained_clean=drained_clean,
        client=client_raw,
        slo_p99_ms=cfg.slo_p99_ms,
        fleet_attribution=(
            tracer.attribution() if tracer is not None else None
        ),
        capacity=router.capacity_block(),
    )
    events.emit("serve", phase="verdict", **verdict)
    events.emit("fleet", phase="stop", host=host, port=port)
    events.close()
    write_verdict_files(verdict, run_dir, cfg.out)
    return {
        "verdict": verdict,
        "run_dir": run_dir,
        "host": host,
        "port": port,
    }


__all__ = [
    "HOST_DEAD",
    "HOST_DRAINING",
    "HOST_READY",
    "HOST_WARMING",
    "RETRY_CAUSES",
    "FleetRouter",
    "HostState",
    "backoff_s",
    "fleet_slo_verdict",
    "parse_hosts",
    "run_serve_fleet",
]

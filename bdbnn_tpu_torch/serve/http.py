"""Network front end: stdlib asyncio HTTP/1.1 over the serving stack —
the port's copy of ``bdbnn_tpu/serve/http.py``.

A deliberately minimal HTTP/1.1 server in front of the ``MicroBatcher``
→ engine path: ``asyncio.start_server`` and a hand-rolled request
parser, no third-party server. The event loop runs on its own thread;
the engine's forward runs on the batcher's worker thread (or a
replica's), never on the loop's.

Endpoints:

==================  ====================================================
``POST /v1/predict``  one inference request. Headers: ``x-priority``
                      (int class, 0 = most important; out-of-range →
                      400) and ``x-tenant`` (quota key; default
                      ``anon``). Body: the payload ``decode`` accepts
                      (the CLI wires raw float32 image bytes or a JSON
                      list). 200 + logits JSON, or an explicit shed:
                      **429** ``over_quota`` (THIS tenant's bucket is
                      empty — its fault, retry later) vs **503**
                      ``draining`` / ``queue full`` (the SERVER is
                      going away or overloaded — retry elsewhere);
                      both carry ``retry-after``.
``GET /healthz``      liveness: 200 as soon as the process serves
                      sockets (load balancer: don't kill me).
``GET /readyz``       readiness: 200 only when the engine's warmup
                      has finished AND the drain latch is clear
                      (load balancer: you may route to me). SIGTERM →
                      flips to 503 ``draining`` BEFORE in-flight
                      requests finish — new traffic moves away while
                      accepted requests are answered.
``GET /statsz``       live stats JSON: per-priority queue occupancy
                      (one source of truth: ``MicroBatcher.stats()``),
                      per-tenant admission counters, in-flight count,
                      readiness state, the capacity block
                      (obs/capacity.py) and — when tracing is on — the
                      live request-path stage histograms
                      (obs/rtrace.py: per-stage p99, queue share).
``/admin/*``          with a replica pool: ``GET /admin/replicas`` (the
                      per-replica table), ``GET /admin/swap`` (the swap
                      state machine's status) and ``POST /admin/swap``
                      (``{"version": N}`` or ``{"artifact": dir}``:
                      starts a blue/green rollout, 202).
==================  ====================================================

**Drain contract (the batcher's drain extended over sockets).** SIGTERM
latches: ``/readyz`` goes 503 immediately, ``admit()`` starts
returning ``draining`` (503), and every request ALREADY accepted is
answered before the server closes — ``drain()`` waits for the
in-flight count to reach zero, then drains the batcher (whose queues
empty into answered futures, never dropped ones), then closes the
listener. An accepted request is never dropped; the verdict is written
after the last response.

The engine is injected as the batcher's runner callable, so this module
(and its socket tests) needs no card and no torch import; the
``serve-http`` orchestration (:func:`run_serve_http`) builds the engine
on the card unless the config names the CPU, and never falls back.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from bdbnn_tpu_torch.obs.capacity import CapacityPlane
from bdbnn_tpu_torch.obs.events import jsonsafe
from bdbnn_tpu_torch.obs.rtrace import (
    STAGE_HEADER,
    TRACE_HEADER,
    encode_stage_header,
    parse_trace_context,
    pop_future_answered_by,
)
from bdbnn_tpu_torch.serve.admission import (
    ADMIT,
    DEFAULT_TENANT,
    DRAINING,
    OVER_QUOTA,
    AdmissionController,
)
from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher
from bdbnn_tpu_torch.serve.pool import DEFAULT_MODEL

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}

PREDICT_PATH = "/v1/predict"


def _default_decode(body: bytes, content_type: str) -> Any:
    return json.loads(body) if body else None


def _shed_key(reason: str) -> str:
    """Ledger column for a LoadShedError reason — the taxonomy every
    shed site (submit-time and future-delivered alike) buckets through,
    so a total pool outage ("no healthy replica") is never misfiled as
    queue-full backpressure and triage reads the right layer."""
    if reason == "draining":
        return "shed_draining"
    if reason == "no healthy replica":
        return "shed_unavailable"
    return "shed_queue_full"


def _default_encode(result: Any) -> Any:
    return jsonsafe(result)


class HttpFrontEnd:
    """The asyncio server, run on its own thread so synchronous callers
    (CLI main loop, tests, the thread-based load generator) can drive
    it with plain calls: ``start()`` → (host, port), ``drain()``,
    ``stats()``, ``accounting()``.

    ``ready_fn`` reports the engine's warmup state (``/readyz`` gates
    on it; it must read host state only, never the card); ``decode``/``encode`` translate HTTP bodies to/from
    batcher payloads, so the server itself stays numpy-free.
    """

    def __init__(
        self,
        batcher: MicroBatcher,
        admission: AdmissionController,
        *,
        ready_fn: Callable[[], bool] = lambda: True,
        decode: Callable[[bytes, str], Any] = _default_decode,
        encode: Callable[[Any], Any] = _default_encode,
        host: str = "127.0.0.1",
        port: int = 0,
        max_body_bytes: int = 16 * 2**20,
        default_priority: Optional[int] = None,
        retry_after_s: int = 1,
        admin: Optional[Any] = None,
        model_router: Optional[Callable[[str], str]] = None,
        tracer: Optional[Any] = None,
        server_id: Optional[str] = None,
        capacity: Optional[CapacityPlane] = None,
        canary: Optional[Any] = None,
    ):
        self.batcher = batcher
        self.admission = admission
        # canary monitor (serve/canary.py): when wired, every served
        # request's (priority, latency, answered-by version) feeds the
        # per-cohort latency windows the rollout verdict judges. The
        # monitor ignores feeds outside an armed episode, so this
        # costs one attribute read per request when no rollout runs.
        self.canary = canary
        # capacity observatory (obs/capacity.py): every request feeds
        # the per-(model, tenant, priority) demand ledger and — on its
        # terminal disposition — the SLO budget plane. Always present
        # so the feed sites never branch; the orchestration passes a
        # plane configured with the run's objectives, a bare default
        # otherwise (demand + utilization still measured, no
        # detectors armed).
        self.capacity = (
            capacity if capacity is not None
            else CapacityPlane(priorities=batcher.priorities)
        )
        # request-lifecycle tracer (obs/rtrace.py): when wired, every
        # served request gets read/admit/queue/coalesce/dispatch/
        # compute/respond spans, /statsz exposes the live stage
        # histograms and the verdict carries the attribution block.
        # None = zero per-request cost beyond one attribute read.
        self.tracer = tracer
        self.ready_fn = ready_fn
        self.decode = decode
        self.encode = encode
        self.host = host
        self.port = int(port)
        self.max_body_bytes = int(max_body_bytes)
        # an absent x-priority header lands in the LOWEST class: best
        # effort by default, priority is something a client asks for
        self.default_priority = (
            batcher.priorities - 1
            if default_priority is None
            else int(default_priority)
        )
        self.retry_after_s = int(retry_after_s)
        # the replica-pool operator surface (serve/pool.py:PoolAdmin):
        # GET /admin/replicas, GET/POST /admin/swap. None = the admin
        # routes 404 (single-engine serving has no pool to administer).
        self.admin = admin
        # multi-model residency (serve/pool.py ResidentModelCache):
        # maps an ``x-model`` header value to a model key the batcher
        # payloads carry — requests route to co-resident packed
        # versions without a reload. Raises KeyError on an unknown or
        # unverifiable model -> 404, ledgered as `rejected` (the
        # client named something unservable; neither completed nor
        # shed). None = the header is rejected outright: a server not
        # configured for multi-model must not silently ignore a
        # routing request and answer from the wrong model.
        self.model_router = model_router
        # host identity: a stable id advertised on /healthz and /statsz
        # and stamped into 200 responses as ``served_by``, so a fronting
        # router's per-host ledger can be checked against what the HOST
        # says it is. None = single-host serving, responses unchanged.
        self.server_id = server_id
        self._completed_by_model: Dict[str, int] = {}
        self._draining = threading.Event()
        # in-flight = /v1/predict handlers between request-parsed and
        # response-written; open connections additionally tracked in
        # _conns so drain can give still-reading (e.g. slow-dribble)
        # clients a grace to finish and collect their 503
        self._inflight = 0
        self._conns = 0
        self._inflight_cv = threading.Condition()
        # accounting (mutated only on the loop thread; snapshotted from
        # others — int/list appends are atomic enough under the GIL)
        self._lat_by_priority: List[List[float]] = [
            [] for _ in range(batcher.priorities)
        ]
        # observed /v1/predict arrival stamps (perf_counter): the
        # MEASURED offered-rate figure serve-mode verdicts report —
        # derived from what actually arrived, never from a config knob
        self._arrival_stamps: List[float] = []
        self._counts_by_priority: List[Dict[str, int]] = [
            {"submitted": 0, "completed": 0, "failed": 0,
             "rejected": 0, "shed_draining": 0, "shed_over_quota": 0,
             "shed_queue_full": 0, "shed_unavailable": 0}
            for _ in range(batcher.priorities)
        ]
        self._requests_seen = 0
        self._t_started: Optional[float] = None
        self._t_drained: Optional[float] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------

    def start(self, timeout: float = 10.0) -> Tuple[str, int]:
        """Bind + serve on a dedicated event-loop thread; returns the
        bound (host, port) — port 0 resolves to the kernel's pick."""
        self._thread = threading.Thread(
            target=self._serve_thread, name="http-front-end", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("HTTP front end failed to start in time")
        if self._start_error is not None:
            raise RuntimeError(
                f"HTTP front end failed to bind: {self._start_error}"
            )
        return self.host, self.port

    def _serve_thread(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def _main():
            try:
                self._server = await asyncio.start_server(
                    self._client, self.host, self.port
                )
            except OSError as e:
                self._start_error = e
                self._started.set()
                return
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()
            async with self._server:
                await self._server.serve_forever()

        try:
            loop.run_until_complete(_main())
        except asyncio.CancelledError:
            pass
        finally:
            # let pending handler callbacks (already-scheduled 503s)
            # settle before tearing the loop down
            try:
                pending = [
                    t for t in asyncio.all_tasks(loop)
                    if t is not asyncio.current_task(loop)
                ]
                for t in pending:
                    t.cancel()
                if pending:
                    loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True)
                    )
            except Exception:
                pass
            loop.close()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout: float = 120.0) -> bool:
        """The SIGTERM path, callable from any thread. Latches the
        drain flag (readyz flips 503, new requests shed), waits for
        every ACCEPTED request's response to be written, drains the
        batcher, then closes the listener. Returns True when everything
        wound down inside ``timeout``. Idempotent."""
        already = self._draining.is_set()
        self._draining.set()
        self.admission.drain()
        deadline = time.monotonic() + timeout
        # 1. every accepted request answered (the socket-level extension
        #    of the batcher's no-unresolved-Future guarantee)
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(remaining)
            clean = self._inflight == 0
        # 2. the batcher's own drain (queues empty by now: nothing new
        #    could enter after the latch)
        clean = self.batcher.drain(
            timeout=max(deadline - time.monotonic(), 0.1)
        ) and clean
        if self._t_drained is None:
            self._t_drained = time.perf_counter()
        # 2b. grace for connections still mid-request — a slow client
        #     dribbling its body is parked in readexactly and not yet
        #     in-flight; give it a moment to finish the read and
        #     collect its explicit 503 instead of a torn connection
        #     (handlers close their connection at the next boundary
        #     once the latch is set, so this converges fast)
        grace_deadline = min(time.monotonic() + 2.0, deadline)
        with self._inflight_cv:
            while self._conns > 0:
                remaining = grace_deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(remaining)
        # 3. stop serving sockets and wind the loop down
        if not already and self._loop is not None:
            loop = self._loop

            def _shutdown():
                if self._server is not None:
                    self._server.close()
                # cancel serve_forever -> run_until_complete returns
                for task in asyncio.all_tasks(loop):
                    task.cancel()

            try:
                loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass  # loop already closed
        if self._thread is not None:
            self._thread.join(max(deadline - time.monotonic(), 0.1))
            clean = clean and not self._thread.is_alive()
        return clean

    # -- request plumbing ----------------------------------------------

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        # the read-stage clock starts when the request LINE lands, not
        # when the connection went readable: an idle keep-alive
        # connection parked in readline must not charge its idle wait
        # to the next request's read span
        t_recv = time.perf_counter()
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise ValueError(f"malformed request line: {line!r}")
        method, path, _version = parts
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            name = name.strip().lower()
            value = value.strip()
            if name == TRACE_HEADER and name in headers:
                # a DUPLICATED trace context is ambiguous (which hop
                # minted it?) — poison it so the adopt path falls
                # back to a fresh local trace instead of guessing
                value = ""
            headers[name] = value
        n = int(headers.get("content-length", 0) or 0)
        if n > self.max_body_bytes:
            return method, path, headers, None, t_recv  # signals 413
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body, t_recv

    def _respond(
        self, writer, status: int, obj: Any, *,
        retry_after: bool = False, close: bool = False,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = json.dumps(jsonsafe(obj)).encode()
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(body)}\r\n"
        )
        if retry_after:
            head += f"retry-after: {self.retry_after_s}\r\n"
        for name, value in (extra_headers or {}).items():
            head += f"{name}: {value}\r\n"
        if close:
            head += "connection: close\r\n"
        writer.write(head.encode("latin-1") + b"\r\n" + body)

    async def _client(self, reader, writer) -> None:
        with self._inflight_cv:
            self._conns += 1
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (
                    asyncio.IncompleteReadError, ValueError,
                    ConnectionError,
                ):
                    break
                if req is None:
                    break
                method, path, headers, body, t_recv = req
                close = (
                    headers.get("connection", "").lower() == "close"
                )
                if body is None:
                    self._respond(
                        writer, 413, {"error": "payload too large"},
                        close=True,
                    )
                    break
                await self._route(
                    writer, method, path, headers, body, t_recv
                )
                await writer.drain()
                if close or self._draining.is_set():
                    # draining: close at the request boundary so the
                    # drain grace converges instead of waiting out
                    # idle keep-alive connections
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-exchange: nothing to answer
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass
            with self._inflight_cv:
                self._conns -= 1
                self._inflight_cv.notify_all()

    async def _route(
        self, writer, method, path, headers, body, t_recv=None
    ) -> None:
        if method == "GET" and path == "/healthz":
            self._respond(writer, 200, {
                "status": "ok",
                "ready": bool(self.ready_fn()) and not self.draining,
                "server_id": self.server_id,
            })
        elif method == "GET" and path == "/readyz":
            if self.draining:
                self._respond(
                    writer, 503, {"state": "draining"}, retry_after=True
                )
            elif not self.ready_fn():
                self._respond(
                    writer, 503, {"state": "warming"}, retry_after=True
                )
            else:
                self._respond(writer, 200, {"state": "ready"})
        elif method == "GET" and path == "/statsz":
            self._respond(writer, 200, self.stats())
        elif path in ("/admin/replicas", "/admin/swap"):
            await self._admin(writer, method, path, body)
        elif method == "POST" and path == PREDICT_PATH:
            await self._predict(writer, headers, body, t_recv)
        else:
            self._respond(
                writer, 404, {"error": f"no route {method} {path}"}
            )

    async def _admin(self, writer, method, path, body) -> None:
        """The replica-pool operator routes. ``GET /admin/replicas`` =
        the live per-replica table (device, version, health, queue
        depth, completed); ``GET /admin/swap`` = the swap state
        machine's status; ``POST /admin/swap`` with ``{"version": N}``
        (registry, digest-verified) or ``{"artifact": "/dir"}`` starts
        a blue/green rollout and returns 202 while traffic keeps
        flowing — the rollout is the pool's, the route only triggers
        it."""
        if self.admin is None:
            self._respond(writer, 404, {
                "error": "no replica pool behind this server "
                "(started without --replicas/--registry)",
            })
            return
        if method == "GET" and path == "/admin/replicas":
            self._respond(writer, 200, self.admin.replicas())
        elif method == "GET" and path == "/admin/swap":
            self._respond(writer, 200, self.admin.swap_status())
        elif method == "POST" and path == "/admin/swap":
            try:
                spec = json.loads(body) if body else {}
            except Exception as e:
                self._respond(
                    writer, 400, {"error": f"undecodable body: {e}"}
                )
                return
            if not isinstance(spec, dict):
                self._respond(
                    writer, 400,
                    {"error": "swap body must be a JSON object"},
                )
                return
            # off the event loop: start_swap digest-verifies the target
            # (hashes the weights payload) before spawning the rollout
            # thread — run inline it would stall every in-flight
            # connection for the duration
            status, payload = await asyncio.get_event_loop(
            ).run_in_executor(None, self.admin.start_swap, spec)
            self._respond(writer, status, payload)
        else:
            self._respond(
                writer, 404, {"error": f"no route {method} {path}"}
            )

    async def _predict(self, writer, headers, body, t_recv=None) -> None:
        t0 = time.perf_counter()
        if self._t_started is None:
            # the verdict's wall clock starts at the FIRST request, not
            # at socket bind: the warmup (the kernels' first load on the
            # card) and pre-load idle must not dilute throughput_rps, or
            # compare would flag warmup variance as a serving regression
            self._t_started = t0
        self._requests_seen += 1
        tenant = headers.get("x-tenant") or DEFAULT_TENANT
        raw_p = headers.get("x-priority")
        if raw_p is None:
            priority = self.default_priority
        else:
            try:
                priority = int(raw_p)
            except ValueError:
                priority = -1
            if not 0 <= priority < self.batcher.priorities:
                self._respond(writer, 400, {
                    "error": "bad x-priority",
                    "want": f"int in [0, {self.batcher.priorities})",
                    "got": raw_p,
                })
                return
        trace = None
        if self.tracer is not None:
            # the span timeline starts at request receipt (the request
            # line's arrival when known); the first stamp charges the
            # socket read + parse that already happened
            trace = self.tracer.begin(
                priority, tenant,
                t_start=t_recv if t_recv is not None else t0,
            )
            # adopt an inbound trace context (x-rtrace) so the local
            # waterfall continues the SAME trace; the hardened parser
            # maps ANY malformed header — garbage, oversized, junk — to
            # None, i.e. a fresh local trace, never a 500
            trace.ctx = parse_trace_context(headers.get(TRACE_HEADER))
            trace.stamp("read")
        # in-flight covers the WHOLE predict — admission through the
        # written response — so drain's inflight-zero wait cannot race
        # a request between submit and accounting
        with self._inflight_cv:
            self._inflight += 1
        try:
            await self._predict_body(
                writer, headers, body, t0, tenant, priority, trace
            )
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _abort_trace(self, trace) -> None:
        """A request that ends without a served response (shed /
        rejected / failed) leaves the stage statistics untouched — a
        503 written in microseconds must never read as a fast serve."""
        if trace is not None and self.tracer is not None:
            self.tracer.abort(trace)

    async def _predict_body(
        self, writer, headers, body, t0, tenant: str, priority: int,
        trace=None,
    ) -> None:
        counts = self._counts_by_priority[priority]
        counts["submitted"] += 1
        self._arrival_stamps.append(t0)
        # demand-ledger key: the model the CLIENT asked for (resolved
        # or not — a request 404ing on an unknown model is still
        # demand for it), so offered and its disposition always land
        # under the same key and the ledger identity holds per key
        ledger_model = headers.get("x-model") or DEFAULT_MODEL
        cap = self.capacity
        cap.ledger.offered(ledger_model, tenant, priority)
        decision = self.admission.admit(tenant, trace=trace)
        if decision == DRAINING:
            self._abort_trace(trace)
            counts["shed_draining"] += 1
            cap.ledger.shed(ledger_model, tenant, priority)
            cap.budget.feed(priority, shed=True)
            self._respond(
                writer, 503,
                {"error": "draining", "tenant": tenant},
                retry_after=True,
            )
            return
        if decision == OVER_QUOTA:
            self._abort_trace(trace)
            counts["shed_over_quota"] += 1
            # the tenant's own budget ran out — `rejected` in the
            # demand ledger (with 400s/404s), and NOT fed to the shed
            # SLO: a 429 is the quota working, not capacity failing
            cap.ledger.rejected(ledger_model, tenant, priority)
            self._respond(
                writer, 429,
                {"error": "over_quota", "tenant": tenant},
                retry_after=True,
            )
            return
        assert decision == ADMIT
        raw_model = headers.get("x-model")
        model_key = None
        if raw_model is not None and self.model_router is None:
            # no router configured: answering from the (only) resident
            # model while the client asked for a specific one would be
            # silently wrong — explicit 404, ledgered like a bad body
            self._abort_trace(trace)
            counts["rejected"] += 1
            self.admission.record_rejected(tenant)
            cap.ledger.rejected(ledger_model, tenant, priority)
            self._respond(writer, 404, {
                "error": "multi-model routing disabled "
                "(start serve-http with --resident-models >= 2)",
                "model": raw_model,
            })
            return
        if self.model_router is not None:
            try:
                # off-loop: the first request naming an unseen model
                # pays a full registry digest walk (sha256 over
                # weights.npz) inside the router — on the event loop
                # that would stall every other connection for the
                # duration; memoized hits return in microseconds
                # either way
                model_key = await asyncio.get_running_loop(
                ).run_in_executor(None, self.model_router, raw_model)
            except KeyError as e:
                self._abort_trace(trace)
                counts["rejected"] += 1
                self.admission.record_rejected(tenant)
                cap.ledger.rejected(ledger_model, tenant, priority)
                self._respond(writer, 404, {
                    "error": f"unknown model: {e.args[0] if e.args else raw_model}",
                    "model": raw_model,
                })
                return
        try:
            payload = self.decode(
                body, headers.get("content-type", "")
            )
        except Exception as e:
            # a malformed body is neither completed nor shed — its own
            # ledger column, so `completed + shed + failed + rejected
            # == submitted` survives bad clients
            self._abort_trace(trace)
            counts["rejected"] += 1
            self.admission.record_rejected(tenant)
            cap.ledger.rejected(ledger_model, tenant, priority)
            self._respond(
                writer, 400, {"error": f"undecodable body: {e}"}
            )
            return
        if self.model_router is not None:
            # the batcher payload carries the routing decision; the
            # pool runner groups each coalesced batch by model key
            payload = (model_key, payload)
        try:
            fut = self.batcher.submit(payload, priority=priority, trace=trace)
        except LoadShedError as e:
            self._abort_trace(trace)
            self.admission.record_shed(tenant)
            counts[_shed_key(e.reason)] += 1
            cap.ledger.shed(ledger_model, tenant, priority)
            cap.budget.feed(priority, shed=True)
            self._respond(
                writer, 503,
                {"error": e.reason, "tenant": tenant},
                retry_after=True,
            )
            return
        try:
            result = await asyncio.wrap_future(fut)
        except LoadShedError as e:
            # a shed can land on the FUTURE too: the pooled runner
            # raises inside the batcher worker when every replica
            # queue is full (or none is healthy), and a drain latched
            # between submit and execution is the belt-and-braces
            # case — either way an explicit shed, never a dropped
            # connection, ledgered under its real reason
            self._abort_trace(trace)
            self.admission.record_shed(tenant)
            counts[_shed_key(e.reason)] += 1
            # a future-delivered shed never really entered service —
            # the ledger's entry disposition is `shed`, same as a
            # submit-time shed (admitted is bumped only at terminal
            # served/failed, so identity never double-counts this)
            cap.ledger.shed(ledger_model, tenant, priority)
            cap.budget.feed(priority, shed=True)
            self._respond(
                writer, 503,
                {"error": e.reason, "tenant": tenant},
                retry_after=True,
            )
            return
        except Exception as e:
            self._abort_trace(trace)
            self.admission.record_failed(tenant)
            counts["failed"] += 1
            cap.ledger.admitted(ledger_model, tenant, priority)
            cap.ledger.failed(ledger_model, tenant, priority)
            self._respond(
                writer, 500, {"error": f"inference failed: {e}"}
            )
            return
        lat_ms = (time.perf_counter() - t0) * 1000.0
        self._lat_by_priority[priority].append(lat_ms)
        if self.canary is not None:
            # cohort truth is who ANSWERED: the version label rides
            # the request future (obs/rtrace.py), so a canary-assigned
            # batch that fell back to the incumbent feeds the
            # incumbent's window
            self.canary.record_served(
                priority, lat_ms, pop_future_answered_by(fut)
            )
        counts["completed"] += 1
        self.admission.record_completed(tenant)
        cap.ledger.admitted(ledger_model, tenant, priority)
        cap.ledger.completed(ledger_model, tenant, priority)
        cap.budget.feed(priority, latency_ms=lat_ms)
        if self.model_router is not None:
            # keyed by pool.DEFAULT_MODEL so resident_block can merge
            # this ledger into the cache-stats rows it keys the same
            key = model_key or DEFAULT_MODEL
            self._completed_by_model[key] = (
                self._completed_by_model.get(key, 0) + 1
            )
        payload_out = {
            "result": self.encode(result),
            "priority": priority,
            "tenant": tenant,
            "model": model_key,
            "latency_ms": round(lat_ms, 3),
        }
        if self.server_id is not None:
            # host cross-check: WHO answered rides the response
            payload_out["served_by"] = self.server_id
        extra_headers = None
        if trace is not None and trace.ctx is not None:
            # traced request: return the server-side stage decomposition
            # in the response header. The self-reported span ends HERE
            # (at header build) — the final socket write is on the far
            # side of the bytes, so the caller's own `network` stage
            # absorbs it; the pre-write gap since the last stamp (future
            # wakeup + encode) is charged to `respond` so the header's
            # stage sum equals its total exactly
            total_ms = (time.perf_counter() - trace.t0) * 1000.0
            stages = dict(trace.stages)
            pre_write = total_ms - sum(stages.values())
            if pre_write > 0:
                stages["respond"] = (
                    stages.get("respond", 0.0) + pre_write
                )
            extra_headers = {
                STAGE_HEADER: encode_stage_header(
                    trace.ctx["id"], total_ms, stages
                ),
            }
        self._respond(
            writer, 200, payload_out, extra_headers=extra_headers
        )
        await writer.drain()
        if trace is not None:
            # respond span: future wakeup + encode + socket write; the
            # waterfall is complete once the bytes are flushed
            trace.stamp("respond")
            self.tracer.finish(trace)

    # -- reporting -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The live snapshot ``/statsz`` serves and the periodic
        ``http`` stats events carry: readiness, in-flight, per-priority
        queue occupancy (straight from ``MicroBatcher.stats()`` — one
        source of truth) and per-tenant admission counters."""
        ready = bool(self.ready_fn()) and not self.draining
        with self._inflight_cv:
            inflight = self._inflight
        return jsonsafe({
            "ready": ready,
            "state": (
                "draining" if self.draining
                else "ready" if ready else "warming"
            ),
            "server_id": self.server_id,
            "inflight": inflight,
            "requests_seen": self._requests_seen,
            "batcher": self.batcher.stats(),
            "admission": self.admission.stats(),
            "completed_by_priority": [
                c["completed"] for c in self._counts_by_priority
            ],
            "shed_by_priority": [
                c["shed_draining"] + c["shed_over_quota"]
                + c["shed_queue_full"] + c["shed_unavailable"]
                for c in self._counts_by_priority
            ],
            # live request-path stage histograms (obs/rtrace.py): the
            # per-stage p99s /statsz clients and `watch` read to tell
            # queue-bound from device-bound WHILE it happens
            "rtrace": (
                self.tracer.stats() if self.tracer is not None else None
            ),
            # the live canary view while a rollout observes: per-
            # detector status, cohort served counts, drift so far
            "canary": (
                self.canary.live() if self.canary is not None else None
            ),
            # the live capacity block (obs/capacity.py): demand table,
            # utilization gauges, burn-rate peek + headroom estimate
            "capacity": self.capacity.live_block(),
        })

    def accounting(self) -> Dict[str, Any]:
        """The post-drain request ledger the SLO verdict is built from:
        per-priority latency samples + disposition counts, wall time."""
        t_end = self._t_drained or time.perf_counter()
        wall_s = (
            t_end - self._t_started if self._t_started is not None else 0.0
        )
        stamps = self._arrival_stamps
        measured_rate = None
        if len(stamps) >= 2:
            span = stamps[-1] - stamps[0]
            if span > 0:
                # offered rate over the observed arrival span: (n-1)
                # inter-arrival gaps over their total duration — what
                # actually hit the socket, not what any config claims
                measured_rate = round((len(stamps) - 1) / span, 4)
        return {
            "wall_s": wall_s,
            "latencies_ms_by_priority": [
                sorted(l) for l in self._lat_by_priority
            ],
            "counts_by_priority": [
                dict(c) for c in self._counts_by_priority
            ],
            "completed_by_model": dict(self._completed_by_model),
            "requests_seen": self._requests_seen,
            "measured_rate_rps": measured_rate,
        }


# ---------------------------------------------------------------------------
# serve-http orchestration (the CLI body)
# ---------------------------------------------------------------------------




def image_codec(image_size: int):
    """``(decode, encode)`` of the ``/v1/predict`` wire format for
    ``image_size``² RGB images: the body is raw float32 little-endian
    pixels (``application/octet-stream``, the load generator's format)
    or a JSON nested list; the answer is ``pred`` (the argmax) and the
    ``logits`` rounded to 4 places."""
    import numpy as np

    shape = (int(image_size), int(image_size), 3)
    nbytes = int(np.prod(shape)) * 4

    def decode(body: bytes, content_type: str):
        if content_type.startswith("application/octet-stream"):
            if len(body) != nbytes:
                raise ValueError(
                    f"want {nbytes} bytes of float32 {shape}, got "
                    f"{len(body)}"
                )
            return np.frombuffer(body, "<f4").reshape(shape).copy()
        arr = np.asarray(json.loads(body), np.float32)
        if arr.shape != shape:
            raise ValueError(f"want shape {shape}, got {arr.shape}")
        return arr

    def encode(logits) -> Dict[str, Any]:
        return {
            "pred": int(np.argmax(logits)),
            "logits": [round(float(x), 4) for x in np.asarray(logits)],
        }

    return decode, encode


def run_serve_http(cfg, degrade=None) -> Dict[str, Any]:
    """End-to-end HTTP serving over an export artifact (the
    ``serve-http`` CLI body). ``cfg`` is a
    :class:`bdbnn_tpu_torch.serve.config.ServeHttpConfig`. Raises before
    anything runs when the config asks for the card (the default) and
    there is none. ``degrade`` (tests and canary drills only — never a
    CLI flag) is the fault-injection spec threaded into the pool's runner
    factory (serve/pool.py ``_apply_degradation``): per-version latency
    inflation, error rate, or logit perturbation, so the auto-rollback
    path can be proven against a genuinely degraded vN+1 through the
    real orchestration.

    Two modes sharing one server lifecycle:

    - ``cfg.scenario == ""`` — **serve**: bind, warm up, answer until
      SIGTERM/SIGINT latches, then drain and write the verdict from
      the server-side ledger.
    - ``cfg.scenario`` set — **bench**: same server, plus the
      scenario's socket load generator (serve/loadgen.py) driving real
      HTTP against it from this process; the verdict additionally
      carries the client's own observation (the zero-dropped
      cross-check).

    Either way the run dir carries the same manifest/events/verdict
    artifacts as ``serve-bench``, so the reference's ``watch``,
    ``summarize`` and ``compare`` read it. The ``http`` ``stop`` event
    carries ``forwards``: the forwards of every engine the run built."""
    from bdbnn_tpu_torch import resolve_device
    from bdbnn_tpu_torch.train.resilience import PreemptionHandler

    cfg = cfg.validate()
    resolve_device(cfg.device)
    # the SIGTERM latch covers the WHOLE run — a preemption during the
    # warmup must drain-and-report, not die with the default disposition
    with PreemptionHandler() as handler:
        return _serve_http_body(cfg, handler, degrade)


def _serve_http_body(cfg, handler, degrade=None) -> Dict[str, Any]:
    import datetime

    import numpy as np

    from bdbnn_tpu_torch.obs.events import EventWriter
    from bdbnn_tpu_torch.obs.manifest import write_manifest
    from bdbnn_tpu_torch.serve.admission import parse_quota, parse_tenant_quotas
    from bdbnn_tpu_torch.serve.engine import InferenceEngine, _pct
    from bdbnn_tpu_torch.serve.loadgen import (
        HttpLoadGenerator,
        _ArtifactMeta,
        _pool_replicas_block,
        _serve_provenance,
        build_schedule,
        http_slo_verdict,
        write_verdict_files,
    )

    # registry resolution: with --registry, the ARTIFACT argument may
    # name a published version (v0003 / 3) — resolved with digest
    # verification instead of trusted as a path
    registry = None
    artifact_dir = cfg.artifact
    version_label = None
    if cfg.registry:
        from bdbnn_tpu_torch.serve.registry import (
            ArtifactRegistry,
            looks_like_version,
            parse_version,
        )

        registry = ArtifactRegistry(cfg.registry)
        if looks_like_version(cfg.artifact or ""):
            version = parse_version(cfg.artifact)
            artifact_dir = registry.resolve(version)
            version_label = registry.label(version)
    if version_label is None:
        version_label = (
            os.path.basename(artifact_dir.rstrip(os.sep)) or "live"
        )

    # engine cold: the server comes up immediately with /healthz 200 +
    # /readyz 503 "warming", flipping ready only when every bucket has
    # run once — the load balancer sees the real warmup state. The
    # pooled path needs METADATA only (the replica engines are built
    # and warmed after the listener binds) — loading a full weight copy
    # here would pin a dead resident set on the card for the server's
    # whole life.
    if cfg.pooled:
        engine: Any = _ArtifactMeta(artifact_dir, cfg.buckets)
    else:
        engine = InferenceEngine(
            artifact_dir, buckets=cfg.buckets, warm=False, device=cfg.device,
            packed=cfg.packed_weights, packed_impl=cfg.packed_impl,
        )

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = os.path.join(cfg.log_path, stamp)
    os.makedirs(run_dir, exist_ok=True)
    prov = engine.artifact.get("provenance", {})
    recipe = prov.get("recipe") or {}
    manifest = write_manifest(
        run_dir,
        {
            "mode": "serve-http",
            "artifact": os.path.abspath(artifact_dir),
            # recipe fields flow through so `compare` aligns serving
            # runs on the same export provenance (None entries dropped,
            # spread FIRST — see serve-bench)
            **{k: v for k, v in recipe.items() if v is not None},
            "arch": engine.arch,
            "dataset": engine.dataset,
            "export_config_hash": prov.get("config_hash"),
            "buckets": list(cfg.buckets),
            "priorities": cfg.priorities,
            "queue_depth": cfg.queue_depth,
            "max_delay_ms": cfg.max_delay_ms,
            "scenario": cfg.scenario or None,
            "rate": cfg.rate,
            "requests": cfg.requests,
            "seed": cfg.seed,
            "default_quota": cfg.default_quota,
            "tenant_quotas": list(cfg.tenant_quotas),
            "replicas": cfg.replicas,
            "registry": os.path.abspath(cfg.registry) if cfg.registry
            else None,
            "swap_to": cfg.swap_to or None,
            "swap_at": cfg.swap_at or None,
            "canary_fraction": cfg.canary_fraction or None,
            "canary_replicas": (
                cfg.canary_replicas if cfg.canary_fraction else None
            ),
            "shadow_every": (
                cfg.shadow_every if cfg.canary_fraction else None
            ),
            "packed_weights": cfg.packed_weights,
            "packed_impl": cfg.packed_impl,
            "resident_models": cfg.resident_models,
            "models": list(cfg.models) or None,
            "rtrace": cfg.rtrace,
            "rtrace_sample_every": cfg.rtrace_sample_every,
        },
        device=cfg.device,
    )
    events = EventWriter(run_dir, max_bytes=int(cfg.events_max_mb * 2**20))

    # request-path tracing (obs/rtrace.py): full socket-to-socket
    # waterfalls — read/admit/queue/coalesce/dispatch/compute/respond —
    # with deterministic sampling + always-kept tail exemplars; sampled
    # waterfalls and periodic stage histograms flow as rtrace events
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

    default_rate, default_burst = parse_quota(cfg.default_quota)
    admission = AdmissionController(
        default_rate=default_rate,
        default_burst=default_burst,
        quotas=parse_tenant_quotas(cfg.tenant_quotas),
    )
    events.emit(
        "admission",
        phase="config",
        default_rate=default_rate,
        default_burst=default_burst,
        tenant_quotas={
            t: {"rate": r, "burst": b}
            for t, (r, b) in parse_tenant_quotas(cfg.tenant_quotas).items()
        },
    )

    # rolling p99 over a sliding latency window for the live `serve`
    # stats events `watch` renders (same shape as serve-bench, plus
    # the per-priority queue depths)
    window: List[float] = []
    win_lock = threading.Lock()
    batch_counter = [0]
    emit_every = max(
        cfg.requests // (20 * max(engine.buckets[-1], 1)), 1
    )

    def on_batch(stats: Dict[str, Any]) -> None:
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
                queue_depth_by_priority=stats["queue_depth_by_priority"],
                rolling_p99_ms=_pct(rolling, 99.0),
                completed=stats["completed"],
                shed=stats["shed"],
            )

    # one runner slot, two shapes: the single engine (a blocking call on
    # the batcher's worker thread) or the replica pool's async dispatch
    # (the runner returns the batch Future; the batcher chains it and
    # keeps collecting, so N replicas execute concurrently). The pool is
    # built AFTER the listener binds — pool_ref carries it in.
    pool_ref: List[Any] = []

    if cfg.pooled:

        def runner(samples: List[np.ndarray]):
            if not pool_ref:
                # a predict raced the replica warmup (readyz is still
                # 503 "warming" — a well-behaved LB isn't routing yet):
                # explicit shed, never a hang. "no healthy replica" so
                # the ledger files it as shed_unavailable — a server
                # with zero load must not read as queue-full overload
                raise LoadShedError("no healthy replica")
            return pool_ref[0].submit(samples)

    else:

        def runner(samples: List[np.ndarray]):
            return engine.predict_logits(np.stack(samples))

    batcher = MicroBatcher(
        runner,
        max_batch=engine.buckets[-1],
        max_queue=cfg.queue_depth,
        max_delay_ms=cfg.max_delay_ms,
        on_batch=on_batch,
        priorities=cfg.priorities,
        # async backpressure on the pooled path (~1 executing + 1
        # queued batch per replica): overload sheds at the front's
        # per-priority queues, and priority inversion is bounded to
        # the batches already dispatched
        max_pending_batches=2 * cfg.replicas if cfg.pooled else None,
    )

    shape = (engine.image_size, engine.image_size, 3)
    decode, encode = image_codec(engine.image_size)

    # readiness reads host state only (the warmed-bucket set, the pool
    # reference) — /readyz never touches the card
    ready_fn = (
        (lambda: bool(pool_ref)) if cfg.pooled
        else (lambda: engine.warmed)
    )
    # multi-model routing: x-model names a digest-verified registry
    # version; resolution (the sha256 chain walk) is memoized into
    # model_dirs, which the replica caches' loader also reads — one
    # verification per model per server life, never per request
    model_dirs: Dict[str, str] = {}
    model_router = None
    if cfg.resident_models > 1:
        from bdbnn_tpu_torch.serve.registry import parse_version

        def model_router(header):
            if header is None:
                return None
            try:
                version = parse_version(header)
            except ValueError as e:
                raise KeyError(str(e))
            label = registry.label(version)
            # x-model naming the server's default version routes to the
            # default resident engine — never a second copy of the same
            # weights in the cache
            current_default = (
                pool_ref[0].version if pool_ref else version_label
            )
            if label == current_default:
                return None
            if label not in model_dirs:
                try:
                    model_dirs[label] = registry.resolve(version)
                except Exception as e:
                    # unknown version, torn dir, digest mismatch — all
                    # 404 to the client, none may reach an engine
                    raise KeyError(str(e))
            return label

        # the scenario's model mix resolves BEFORE the listener binds:
        # a well-formed but unpublished/torn version must fail here as
        # a startup error, not after the socket is bound and the run
        # dir is open. Resolution is memoized into model_dirs, so the
        # warm loop and request path reuse it.
        for label in cfg.models:
            try:
                model_router(label)
            except KeyError as e:
                raise ValueError(
                    f"--models entry {label!r} cannot be served: "
                    f"{e.args[0] if e.args else e}"
                )

    # the canary monitor (serve/canary.py): one long-lived instance,
    # armed per rollout episode by the pool — the front end feeds it
    # served latencies, the replica workers feed it batch splits, and
    # its live verdict decides promote vs auto-rollback
    canary_monitor = None
    if cfg.canary_fraction > 0:
        from bdbnn_tpu_torch.serve.canary import (
            CanaryConfig,
            CanaryMonitor,
            apply_canary_overrides,
        )

        canary_monitor = CanaryMonitor(
            apply_canary_overrides(CanaryConfig(), cfg.canary_thresholds),
            priorities=cfg.priorities,
            on_event=lambda kind, **f: events.emit(kind, **f),
        )

    # the capacity observatory (obs/capacity.py): burn-rate windows
    # scale with the stats cadence — the pump is the only detector
    # clock, so ~5 ticks of fast window / ~30 of slow keeps the
    # warmup->debounce->hysteresis semantics stable whether the pump
    # runs at the production default or a test's tight interval
    cap_fast_s = max(5 * cfg.stats_interval_s, 1.0)
    cap_slow_s = max(30 * cfg.stats_interval_s, 3 * cap_fast_s)
    cap_window_s = max(20 * cfg.stats_interval_s, 2.0)
    capacity_plane = CapacityPlane(
        slo_p99_ms=cfg.slo_p99_ms,
        slo_shed_rate=cfg.slo_shed_rate,
        priorities=cfg.priorities,
        window_s=cap_window_s,
        fast_window_s=cap_fast_s,
        slow_window_s=cap_slow_s,
        # busy-fraction samples arrive once per pump tick; sizing the
        # gauge window to span the SAME wall-clock stretch as the
        # demand window keeps capacity_rps_est (completed over busy
        # mean) and offered_rps measured over the same interval
        util_window=max(10, int(round(cap_window_s / cfg.stats_interval_s))),
    )

    front = HttpFrontEnd(
        batcher,
        admission,
        ready_fn=ready_fn,
        decode=decode,
        encode=encode,
        host=cfg.host,
        port=cfg.port,
        max_body_bytes=int(cfg.max_body_mb * 2**20),
        model_router=model_router,
        tracer=tracer,
        server_id=cfg.server_id or None,
        capacity=capacity_plane,
        canary=canary_monitor,
    )
    host, port = front.start()
    events.emit(
        "http",
        phase="start",
        host=host,
        port=port,
        server_id=cfg.server_id or None,
        artifact=os.path.abspath(artifact_dir),
        arch=engine.arch,
        buckets=list(engine.buckets),
        priorities=cfg.priorities,
        queue_depth=cfg.queue_depth,
        max_delay_ms=cfg.max_delay_ms,
        scenario=cfg.scenario or None,
        rate_rps=cfg.rate if cfg.scenario else None,
        requests=cfg.requests if cfg.scenario else None,
        replicas=cfg.replicas if cfg.pooled else None,
        version=version_label if cfg.pooled else None,
    )
    factory = None
    admin = None
    if cfg.pooled:
        # build the replica set: one engine per card, warmed by the
        # factory — readyz stays 503 "warming" until the whole set is
        # resident, then flips
        from bdbnn_tpu_torch.parallel.mesh import replica_devices
        from bdbnn_tpu_torch.serve.pool import (
            PoolAdmin,
            ReplicaPool,
            first_warm_capture,
            make_engine_runner_factory,
            replica_stats_fields,
        )

        warm_compile, _on_engine = first_warm_capture()
        factory = make_engine_runner_factory(
            cfg.buckets,
            on_engine=_on_engine,
            packed=cfg.packed_weights,
            packed_impl=cfg.packed_impl,
            resident_models=cfg.resident_models,
            model_dirs=model_dirs,
            on_event=lambda kind, **f: events.emit(kind, **f),
            degrade=degrade,
        )
        pool = ReplicaPool(
            factory,
            list(replica_devices(cfg.replicas, cfg.device)),
            artifact_ref=artifact_dir,
            version=version_label,
            max_queue_batches=cfg.replica_queue_batches,
            wedge_timeout_s=cfg.wedge_timeout_s,
            on_event=lambda kind, **f: events.emit(kind, **f),
        )
        if cfg.models and model_router is not None:
            # the scenario's model mix is KNOWN up front: warm every
            # named co-resident model on every replica BEFORE readyz
            # flips, so no scheduled request pays a cold load mid-bench
            # (an UNNAMED x-model still loads lazily — that latency is
            # the client's explicit choice). A model key of None is the
            # default version — already resident.
            keys = {model_router(label) for label in cfg.models}
            for cache in factory.caches:
                for key in sorted(k for k in keys if k is not None):
                    cache.get(key)
        pool_ref.append(pool)  # readyz flips 200 from here
        admin = PoolAdmin(
            pool,
            registry=registry,
            # "shed caused during the swap window" across BOTH layers:
            # the front batcher's per-class queues and the pool's
            # replica queues — both in REQUEST units (the pool also
            # counts shed batches, a different unit)
            shed_counter=lambda: (
                batcher.stats()["shed"] + pool.stats()["shed_requests"]
            ),
            # --canary-fraction > 0 turns every triggered rollout into
            # a canary rollout: the monitor's live verdict promotes or
            # auto-rolls-back instead of an unconditional full shift
            canary=(
                {
                    "monitor": canary_monitor,
                    "fraction": cfg.canary_fraction,
                    "replicas": cfg.canary_replicas,
                    "shadow_every": cfg.shadow_every,
                    "seed": cfg.seed,
                }
                if canary_monitor is not None else None
            ),
        )
        front.admin = admin
        warmup_s = dict(warm_compile)
    else:
        pool = None
        warmup_s = engine.warmup()  # readyz flips 200 when this returns
    events.emit(
        "http", phase="ready", warmup_compile_s=dict(warmup_s),
        host=host, port=port,
        replicas=cfg.replicas if cfg.pooled else None,
    )

    from bdbnn_tpu_torch.serve.pool import (
        resident_block,
        single_engine_resident_block,
    )

    def _resident_snapshot():
        """The verdict's ``resident`` block (and the serve_resident
        memory event's source): per-model resident device bytes from
        the replica caches — or, on the single-engine path, the one
        engine's own residency report (shared shape, pool.py)."""
        if cfg.pooled:
            return resident_block(
                factory.caches,
                completed_by_model=(
                    front.accounting()["completed_by_model"] or None
                ),
            )
        return single_engine_resident_block(engine.residency())

    def _forwards() -> int:
        if cfg.pooled:
            return factory.forwards()
        return engine.forwards

    resident_now = _resident_snapshot()
    # per-bucket residency bytes are static after warmup: captured once
    # into the utilization windows (single engine: the engine's own
    # report; pooled: the cache summary — per-replica bytes live in the
    # resident block already)
    if cfg.pooled:
        capacity_plane.utilization.set_residency(
            {
                "resident_bytes_per_model_max": resident_now[
                    "bytes_per_model_max"
                ],
                "models": len(resident_now["models"]),
                "replicas": resident_now["replicas"],
            }
            if resident_now is not None else None
        )
    else:
        capacity_plane.utilization.set_residency(engine.residency())
    if resident_now is not None:
        events.emit(
            "memory",
            phase="serve_resident",
            available=True,
            devices=[],
            peak_bytes=None,
            limit_bytes=None,
            weights_mode="packed" if cfg.packed_weights else "dense",
            packed_impl=cfg.packed_impl if cfg.packed_weights else None,
            resident_bytes=resident_now["bytes_per_model_max"],
            models=len(resident_now["models"]),
            replicas=resident_now["replicas"],
        )

    # periodic live-state events: per-priority depths, per-tenant
    # sheds, readiness — what `watch` renders for a serving run
    stats_stop = threading.Event()

    def stats_pump():
        while not stats_stop.wait(cfg.stats_interval_s):
            s = front.stats()
            events.emit(
                "http",
                phase="stats",
                state=s["state"],
                inflight=s["inflight"],
                requests_seen=s["requests_seen"],
                queue_depth_by_priority=[
                    q["queue_depth"] for q in s["batcher"]["per_priority"]
                ],
                completed_by_priority=s["completed_by_priority"],
                shed_by_priority=s["shed_by_priority"],
                tenants={
                    t: {
                        "admitted": c["admitted"],
                        "over_quota": c["over_quota"],
                        "shed": c["shed"],
                    }
                    for t, c in s["admission"]["tenants"].items()
                },
            )
            if pool is not None:
                # the live per-replica heartbeat `watch` renders
                events.emit(
                    "replica", phase="stats",
                    **replica_stats_fields(pool.stats()),
                )
            if tracer is not None:
                # the live stage histograms: `watch` renders the
                # per-stage p99 waterfall from this heartbeat
                events.emit("rtrace", phase="stats", **tracer.stats())
            # capacity tick: sample the utilization gauges from the
            # snapshots already in hand, then advance the burn-rate
            # detectors — the pump is the ONLY detector clock
            busy_fraction = None
            if pool is not None:
                reps = pool.stats()["replicas"]
                if reps:
                    busy_fraction = sum(
                        1 for r in reps if r["busy"]
                    ) / len(reps)
            rtr = s.get("rtrace") or {}
            capacity_plane.sample(
                busy_fraction=busy_fraction,
                occupancy=s["batcher"].get("mean_occupancy"),
                queue_share=rtr.get("queue_share"),
                admission_headroom=admission.token_headroom(),
            )
            cap_tick = capacity_plane.evaluate()
            for row in cap_tick["fired"]:
                events.emit("capacity", phase="breach", **row)
            for row in cap_tick["recovered"]:
                events.emit("capacity", phase="recovered", **row)
            # re-snapshot AFTER sampling so the emitted gauges and the
            # headroom estimate reflect THIS tick, not the previous one
            cap_live = capacity_plane.live_block()
            events.emit(
                "capacity",
                phase="stats",
                offered_rps=cap_live["demand"]["offered_rps"],
                in_flight=cap_live["demand"]["in_flight_decisions"],
                demand_shed_ratio_max=cap_live["demand"][
                    "demand_shed_ratio_max"
                ],
                headroom=cap_live["headroom"],
                utilization={
                    g: cap_live["utilization"][g]["last"]
                    for g in ("busy_fraction", "occupancy",
                              "queue_share", "admission_headroom")
                },
                detectors=cap_tick["detectors"],
            )

    pump = threading.Thread(target=stats_pump, name="http-stats", daemon=True)
    pump.start()

    client_raw = None
    try:
        if cfg.scenario:
            rng = np.random.default_rng(cfg.seed)
            img_pool = rng.standard_normal((32, *shape)).astype(np.float32)
            bodies = [np.ascontiguousarray(x).tobytes() for x in img_pool]
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
                models=list(cfg.models) or None,
                model_weights=(
                    list(cfg.model_weights)
                    if cfg.model_weights else None
                ),
            )
            # swap-under-load: after --swap-at of the schedule has been
            # OFFERED, fire the same blue/green rollout the admin
            # endpoint exposes — the bench then shows every request
            # answered through the swap, and what it shed
            on_arrival = None
            if cfg.swap_at > 0 and admin is not None:
                threshold = max(int(cfg.swap_at * len(schedule)), 1)
                swap_fired: List[bool] = []
                from bdbnn_tpu_torch.serve.registry import (
                    looks_like_version,
                    parse_version,
                )

                if registry is not None and looks_like_version(
                    cfg.swap_to
                ):
                    swap_spec: Dict[str, Any] = {
                        "version": parse_version(cfg.swap_to)
                    }
                else:
                    swap_spec = {"artifact": cfg.swap_to}

                def on_arrival(i: int) -> None:
                    if not swap_fired and i + 1 >= threshold:
                        swap_fired.append(True)

                        # fire OFF the arrival-scheduling thread:
                        # start_swap digest-verifies the target before
                        # returning, and a stall here would offer every
                        # later arrival late — inflating exactly the
                        # latencies the swap-under-load bench measures
                        def _fire(at=i + 1):
                            status, payload = admin.start_swap(
                                swap_spec
                            )
                            if status != 202:
                                # a rejected SCHEDULED swap must land
                                # in the verdict as not-performed — a
                                # bad --swap-to exiting 0 would read
                                # as a met rollout contract
                                admin.note_request_failed(
                                    cfg.swap_to, payload.get("error")
                                )
                            events.emit(
                                "swap",
                                phase="trigger",
                                at_request=at,
                                of=len(schedule),
                                status=status,
                                **payload,
                            )

                        threading.Thread(
                            target=_fire, name="swap-trigger",
                            daemon=True,
                        ).start()

            gen = HttpLoadGenerator(
                host,
                port,
                schedule,
                body_fn=lambda i: bodies[i % len(bodies)],
                concurrency=cfg.concurrency,
                stop_fn=lambda: handler.preempted,
                slow_chunks=cfg.slow_chunks,
                slow_gap_s=cfg.slow_gap_ms / 1000.0,
                on_arrival=on_arrival,
            )
            client_raw = gen.run()
        else:
            while not handler.preempted:
                time.sleep(0.1)
    finally:
        preempted = handler.preempted
        events.emit(
            "http",
            phase="drain",
            signum=handler.signum,
            preempted=preempted,
        )
        drained_clean = front.drain(timeout=120.0)
        if admin is not None:
            # let an in-flight rollout settle before the pool winds
            # down — its report belongs in the verdict either way
            admin.wait(timeout=30.0)
        if pool is not None:
            drained_clean = pool.drain(timeout=60.0) and drained_clean
        stats_stop.set()
        pump.join(timeout=5.0)

    admission_stats = admission.stats()
    events.emit("admission", phase="summary", **admission_stats)
    resident_final = _resident_snapshot()
    packed_block = None
    if cfg.packed_weights and resident_final is not None:
        rows = list(resident_final["models"].values())
        p_bytes = max(
            (m["resident_bytes"] for m in rows
             if m.get("resident_bytes") is not None),
            default=None,
        )
        d_bytes = max(
            (m["dense_equiv_bytes"] for m in rows
             if m.get("dense_equiv_bytes") is not None),
            default=None,
        )
        packed_block = {
            "mode": "on",
            "impl": cfg.packed_impl,
            # serve-http measures no dense side (that A/B is
            # serve-bench's job); the dense resident figure is the
            # computed equivalent, honest about what was NOT measured
            "dense": {
                "resident_bytes": d_bytes, "step_ms": None,
                "throughput_rps": None, "p99_ms": None,
            },
            "packed": {
                "resident_bytes": p_bytes, "step_ms": None,
                "throughput_rps": None, "p99_ms": None,
            },
            "resident_ratio": (
                round(d_bytes / max(p_bytes, 1), 3)
                if d_bytes is not None and p_bytes is not None else None
            ),
            "step_ms_delta_pct": None,
        }
    accounting = front.accounting()
    verdict = http_slo_verdict(
        accounting,
        batcher.stats(),
        admission_stats,
        scenario=cfg.scenario or "serve",
        # scenario mode records the SCHEDULED rate (the knob the bench
        # was asked to drive); serve mode records the MEASURED offered
        # rate derived from observed arrival stamps
        rate=(
            cfg.rate if cfg.scenario
            else accounting["measured_rate_rps"]
        ),
        seed=cfg.seed,
        provenance=_serve_provenance(
            artifact_dir, engine, prov, recipe, manifest
        ),
        warmup_s=warmup_s,
        preempted=preempted,
        drained_clean=drained_clean,
        client=client_raw,
        slo_p99_ms=cfg.slo_p99_ms,
        replicas=(
            _pool_replicas_block(pool.stats()) if pool is not None
            else None
        ),
        swap=admin.swap_report() if admin is not None else None,
        resident=resident_final,
        packed=packed_block,
        attribution=(
            tracer.attribution() if tracer is not None else None
        ),
        canary=(
            admin.canary_report() if admin is not None else None
        ),
        capacity=capacity_plane.verdict_block(),
    )
    events.emit("serve", phase="verdict", **verdict)
    events.emit("http", phase="stop", host=host, port=port, forwards=_forwards())
    events.close()
    write_verdict_files(verdict, run_dir, cfg.out)
    return {
        "verdict": verdict,
        "run_dir": run_dir,
        "host": host,
        "port": port,
    }


__all__ = ["PREDICT_PATH", "HttpFrontEnd", "image_codec", "run_serve_http"]

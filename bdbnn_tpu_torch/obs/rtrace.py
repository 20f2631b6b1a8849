"""Request-path tracing: per-request lifecycle spans with tail
attribution — the port's copy of the in-process half of
``bdbnn_tpu/obs/rtrace.py`` (stdlib only).

The SLO verdict says *that* p99 moved; this module says *where a request
spent its time*: cheap span stamps at the owning sites, rolled up into
per-stage histograms, tail-exemplar waterfalls and a reconciliation
identity the verdict carries in its ``attribution`` block.

Stage taxonomy (one linear timeline per request; every duration is the
gap between consecutive stamps on ONE ``time.perf_counter`` clock):

==============  =========================================================
``read``        request line received -> body read + parsed (HTTP only)
``admit``       parse -> admission decision (HTTP only)
``queue``       submit -> picked out of the batcher's per-priority queue
                (serve/batching.py; on the pooled path it includes any
                ``max_pending_batches`` backpressure hold)
``coalesce``    picked -> the coalesced batch dispatches to the runner
                (the micro-batcher's deadline window)
``dispatch``    runner dispatch -> a replica worker picks the batch up
                (serve/pool.py replica-queue wait; empty -> null on the
                single-engine path)
``compute``     the engine call itself — the forward as the host
                observes it, the copy of the logits back included
                (serve/engine.py ``predict_logits``)
``respond``     results delivered -> response written (HTTP only)
==============  =========================================================

``serve-bench`` drives the stack in process, so its waterfalls hold
queue -> coalesce -> (dispatch) -> compute. Recording is cheap: one
``perf_counter`` read and a dict write per boundary, bounded rolling
windows, a slowest-K min-heap per priority (tail exemplars are always
kept), and deterministic seeded sampling (splitmix64 over the request
sequence number) deciding which full waterfalls become ``rtrace``
events. Percentiles reuse the None-propagating ``percentile``/``_pct``
of serve/loadgen.py, so an empty stage window lands as ``null``.

Two clocks meet in a verdict and they are not the same number: server
spans (this module) start at submit; client latency
(serve/loadgen.py) is charged from the SCHEDULED arrival. The
reconciliation identity (per-request stage sum == server-side
end-to-end latency, within tolerance) is checked on the server clock
only.

The HTTP front end (serve/http.py) speaks the reference's two wire
formats: it adopts an inbound ``x-rtrace`` trace context (its local
waterfall carries the caller's trace id) and answers a traced request
with its stage decomposition in the ``x-rtrace-stages`` response header.
Both parsers are hardened: a malformed, oversized or duplicated header
parses to ``None`` (a fresh local trace), never to an error.

The fleet router (serve/fleet.py) carries the same substrate across the
host boundary. :class:`FleetTracer` mints a trace id per proxied request,
stamps the router's own stages (:data:`FLEET_STAGES`: ``probe_wait`` ->
``pick`` -> ``connect`` -> one ``retry_hop`` per failed attempt, its
backoff sleep included) and stitches the answering host's
``x-rtrace-stages`` block into one cross-host waterfall; ``network`` is
the router's exchange wall less the backend's self-reported span, a
difference of two durations and never of two clocks. Its
``attribution()`` is the verdict's ``fleet_attribution`` block.
:class:`HostStatsWindows` keeps the stats pump's per-host windows of the
scraped ``/statsz`` ``rtrace`` blocks, and marks a host stale after
``stale_after`` failed scrapes in a row: the merged view leaves it out.
"""

from __future__ import annotations

import heapq
import math
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# the canonical stage order — every consumer (verdict, watch,
# summarize, compare) renders stages in this order
STAGES = (
    "read", "admit", "queue", "coalesce", "dispatch", "compute",
    "respond",
)

# the router-side stage order of a cross-host (fleet) waterfall — the
# backend's own STAGES ride along as a nested block, never flattened
# into this namespace
FLEET_STAGES = ("probe_wait", "pick", "connect", "retry_hop", "network")

# trace-context wire format: one request header, one response header,
# both ``k=v`` pairs joined by ``;`` — parseable without a JSON
# dependency in the byte-level proxy path, and bounded so a hostile
# client cannot make the parser do unbounded work
TRACE_HEADER = "x-rtrace"
STAGE_HEADER = "x-rtrace-stages"
TRACE_CTX_MAX_LEN = 256
STAGE_HEADER_MAX_LEN = 1024

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{16}$")
_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# reconciliation tolerance: stage sum within this fraction of the
# measured end-to-end latency (the acceptance gate), with an absolute
# floor below which the residual is scheduler slop (settle-callback and
# future-wakeup gaps), not misattribution
RECON_TOL_PCT = 5.0
RECON_FLOOR_MS = 0.25

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Deterministic 64-bit mix (same construction as
    data/pipeline.py's per-sample keying): the sampling decision for
    request ``seq`` is a pure function of (seed, seq) — reproducible
    across runs, no RNG state to contend on in the request path."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mint_trace_id(seed: int, seq: int) -> str:
    """A deterministic 16-hex trace id for request ``seq`` — a pure
    function of (seed, seq), same splitmix64 construction as the
    sampling decision, so a run's ids are reproducible."""
    return "%016x" % _splitmix64(_splitmix64(int(seed)) ^ int(seq))


def encode_trace_context(
    trace_id: str, seq: int, priority: int,
    tenant: Optional[str] = None,
) -> str:
    """The ``x-rtrace`` request-header value the router sends with a
    proxied request. Tenants that are not header-token-safe are
    simply omitted — the context is correlation metadata, never the
    routing source of truth (x-priority/x-tenant stay authoritative)."""
    out = f"v=1;id={trace_id};seq={int(seq)};p={int(priority)}"
    if tenant is not None and _TENANT_RE.match(str(tenant)):
        out += f";tn={tenant}"
    return out


def parse_trace_context(value: Any) -> Optional[Dict[str, Any]]:
    """Parse an inbound ``x-rtrace`` header; ``None`` on ANY
    malformation (wrong version, bad id, oversized, junk) — a garbage
    header from a non-fleet client must degrade to a fresh local
    trace, never to a 500."""
    if not isinstance(value, str) or not value:
        return None
    if len(value) > TRACE_CTX_MAX_LEN:
        return None
    fields: Dict[str, str] = {}
    for part in value.split(";"):
        key, sep, val = part.partition("=")
        if not sep or not key or key in fields:
            return None
        fields[key] = val
    if fields.get("v") != "1":
        return None
    trace_id = fields.get("id", "")
    if not _TRACE_ID_RE.match(trace_id):
        return None
    try:
        seq = int(fields.get("seq", ""))
        priority = int(fields.get("p", ""))
    except ValueError:
        return None
    if seq < 0 or not 0 <= priority < 64:
        return None
    tenant = fields.get("tn")
    if tenant is not None and not _TENANT_RE.match(tenant):
        return None
    return {
        "id": trace_id, "seq": seq, "priority": priority,
        "tenant": tenant,
    }


def encode_stage_header(
    trace_id: str, total_ms: float, stages: Dict[str, float]
) -> str:
    """The ``x-rtrace-stages`` response-header value a backend returns
    on a traced request: its self-reported span (``total``) and stage
    decomposition, all DURATIONS in ms — the only numbers that may
    legally cross the clock boundary back to the router."""
    parts = [f"v=1;id={trace_id};total={max(float(total_ms), 0.0):.3f}"]
    for stage in STAGES:
        ms = stages.get(stage)
        if ms is not None and math.isfinite(ms) and ms >= 0:
            parts.append(f"{stage}={float(ms):.3f}")
    return ";".join(parts)


def parse_stage_header(value: Any) -> Optional[Dict[str, Any]]:
    """Parse a backend's ``x-rtrace-stages`` header into
    ``{"id", "total_ms", "stages"}``; ``None`` on any malformation
    (the router then falls back to charging the whole exchange to
    ``network`` and counts the request unstitched)."""
    if not isinstance(value, str) or not value:
        return None
    if len(value) > STAGE_HEADER_MAX_LEN:
        return None
    fields: Dict[str, str] = {}
    for part in value.split(";"):
        key, sep, val = part.partition("=")
        if not sep or not key or key in fields:
            return None
        fields[key] = val
    if fields.get("v") != "1":
        return None
    trace_id = fields.get("id", "")
    if not _TRACE_ID_RE.match(trace_id):
        return None
    try:
        total_ms = float(fields.get("total", ""))
    except ValueError:
        return None
    if not math.isfinite(total_ms) or total_ms < 0:
        return None
    # the key set is CLOSED: v, id, total and the stage taxonomy —
    # an unknown key means a peer speaking some other dialect, and
    # half-understanding it is worse than the unstitched fallback
    if any(
        k not in ("v", "id", "total") and k not in STAGES
        for k in fields
    ):
        return None
    stages: Dict[str, float] = {}
    for stage in STAGES:
        raw = fields.get(stage)
        if raw is None:
            continue
        try:
            ms = float(raw)
        except ValueError:
            return None
        if not math.isfinite(ms) or ms < 0:
            return None
        stages[stage] = ms
    return {"id": trace_id, "total_ms": total_ms, "stages": stages}


# ---------------------------------------------------------------------------
# future-timing handoff: the replica pool measures the dispatch/compute
# split (replica-queue wait vs engine run) at the worker, one layer
# below the batcher that settles the per-request futures — the split
# rides the batch Future itself so no signature on the runner contract
# changes. concurrent.futures.Future is not slotted; a private
# attribute is the cheapest thread-safe channel (set before set_result,
# read in the settle callback).
# ---------------------------------------------------------------------------


def set_future_timing(
    fut: Any, dispatch_ms: float, compute_ms: float
) -> None:
    """Attach a (dispatch_ms, compute_ms) split to a batch Future —
    called by the replica worker BEFORE it resolves the future, so the
    batcher's settle callback always observes it."""
    fut._rtrace_timing = (float(dispatch_ms), float(compute_ms))


def pop_future_timing(fut: Any) -> Optional[tuple]:
    """The split attached by :func:`set_future_timing`, or None (the
    sync single-engine path)."""
    timing = getattr(fut, "_rtrace_timing", None)
    if timing is not None:
        try:
            del fut._rtrace_timing
        except AttributeError:
            pass
    return timing


def set_future_answered_by(fut: Any, version: str) -> None:
    """Attach the artifact version that ANSWERED a future — the replica
    worker labels its batch Future before resolving it, and the batcher
    relabels each per-request future at settle (the label a canary
    monitor reads per cohort). Same private-attribute channel as the
    timing split: thread-safe because it is written strictly before
    ``set_result`` and read strictly after the wait returns."""
    fut._rtrace_answered_by = str(version)


def pop_future_answered_by(fut: Any) -> Optional[str]:
    """The version label attached by :func:`set_future_answered_by`,
    or None (the single-engine path)."""
    version = getattr(fut, "_rtrace_answered_by", None)
    if version is not None:
        try:
            del fut._rtrace_answered_by
        except AttributeError:
            pass
    return version


class RequestTrace:
    """One request's append-only stage stamps.

    ``stamp(stage)`` charges the time since the previous stamp to
    ``stage`` and advances the cursor; ``add(stage, ms)`` records an
    externally measured duration (the pool's dispatch/compute split)
    WITHOUT advancing the cursor; ``sync()`` advances the cursor to
    now (after ``add``s, so the next ``stamp`` only charges its own
    gap). All stamps are on one ``perf_counter`` clock."""

    __slots__ = (
        "seq", "priority", "tenant", "t0", "_last", "stages", "ctx",
    )

    def __init__(
        self, seq: int, priority: int, tenant: Optional[str],
        t0: float,
    ):
        self.seq = seq
        self.priority = priority
        self.tenant = tenant
        self.t0 = t0
        self._last = t0
        self.stages: Dict[str, float] = {}
        # adopted trace context (parse_trace_context result) — set by
        # the HTTP front end when a well-formed x-rtrace header arrives;
        # None for direct clients
        self.ctx: Optional[Dict[str, Any]] = None

    def stamp(self, stage: str) -> None:
        now = time.perf_counter()
        self.stages[stage] = (
            self.stages.get(stage, 0.0) + (now - self._last) * 1000.0
        )
        self._last = now

    def add(self, stage: str, ms: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + float(ms)

    def sync(self, at: Optional[float] = None) -> None:
        """Advance the stamp cursor without charging a stage; ``at``
        pins the cursor to a wall already measured by the caller so
        span bookkeeping and the reconciliation total read the SAME
        instant (work done after ``at`` — response parsing, stitch
        arithmetic — is charged to nobody on purpose)."""
        self._last = time.perf_counter() if at is None else float(at)

    def waterfall(self) -> Dict[str, Any]:
        """The exemplar payload shape ``rtrace`` events and the
        verdict's tail table carry (strict-JSON-safe after jsonsafe)."""
        out = {
            "seq": self.seq,
            "priority": self.priority,
            "tenant": self.tenant,
            "total_ms": round((self._last - self.t0) * 1000.0, 3),
            "stages": {
                s: round(self.stages[s], 3)
                for s in STAGES if s in self.stages
            },
        }
        if self.ctx is not None:
            out["trace"] = self.ctx["id"]
        return out


class RequestTracer:
    """Per-process span recorder: hands out :class:`RequestTrace`
    objects, rolls finished ones into bounded live statistics, and
    assembles the verdict's ``attribution`` block.

    - ``sample_every`` — deterministic seeded sampling: request ``seq``
      is SAMPLED when ``splitmix64(seed ^ seq) % sample_every == 0``;
      sampled waterfalls fire ``on_sample`` (the orchestrations wire it
      to an ``rtrace`` event emit). 1 = every request.
    - ``tail_k`` — slowest-K exemplars per priority, kept ALWAYS
      (independent of sampling — the tail is the point).
    - ``window`` — rolling per-(priority, stage) sample windows the
      live histograms and verdict percentiles are computed over.

    Thread-safe: ``begin``/``finish``/``abort`` run on the event-loop
    thread, batcher worker and settle callbacks; ``stats`` and
    ``attribution`` snapshot under the same lock.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        sample_every: int = 16,
        tail_k: int = 5,
        window: int = 1024,
        on_sample: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        if tail_k < 0:
            raise ValueError("tail_k must be >= 0")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.seed = int(seed)
        self.sample_every = int(sample_every)
        self.tail_k = int(tail_k)
        self.window = int(window)
        self.on_sample = on_sample
        # ONE shared clock base per process: every span in every layer
        # stamps perf_counter deltas against the same timeline
        self.t_base = time.perf_counter()
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        # guarded-by: _lock: finished, aborted, sampled
        self.finished = 0
        self.aborted = 0
        self.sampled = 0
        # rolling sample windows (bounded deques — C-implemented
        # eviction keeps the request-path cost flat):
        # {priority: {stage: deque[ms]}} plus the end-to-end window
        self._stage_win: Dict[int, Dict[str, Any]] = {}  # guarded-by: _lock
        self._e2e_win: Dict[int, Any] = {}  # guarded-by: _lock
        # slowest-K min-heap per priority: (total_ms, seq, trace) —
        # the trace object itself; waterfalls render at REPORT time,
        # never in the request path
        self._tail: Dict[int, List[tuple]] = {}  # guarded-by: _lock
        # reconciliation accumulators over EVERY finished request
        # guarded-by: _lock: _recon_n, _recon_sum_err_ms,
        # guarded-by: _lock: _recon_sum_err_pct, _recon_max_err_pct
        self._recon_n = 0
        self._recon_sum_err_ms = 0.0
        self._recon_sum_err_pct = 0.0
        self._recon_max_err_pct = 0.0

    # -- request path --------------------------------------------------

    def begin(
        self,
        priority: int = 0,
        tenant: Optional[str] = None,
        t_start: Optional[float] = None,
    ) -> RequestTrace:
        """A new trace; ``t_start`` (a perf_counter reading — e.g. the
        moment the request line arrived) backdates the clock so the
        first stamp charges the read that already happened."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        return RequestTrace(
            seq, int(priority), tenant,
            time.perf_counter() if t_start is None else float(t_start),
        )

    def _keep(self, seq: int) -> bool:
        if self.sample_every <= 1:
            return True
        return (
            _splitmix64(self.seed ^ seq) % self.sample_every == 0
        )

    def finish(self, trace: RequestTrace) -> None:
        """Roll one completed request into the live statistics. The
        trace's cursor must already cover its last stage (the caller
        stamps ``respond`` — or the bench done-callback lands right
        after settle). Kept lean on purpose (the <2% budget): deque
        appends, one heap push, no rendering — waterfalls materialize
        only for sampled exemplars and at report time."""
        now = trace._last
        total_ms = (now - trace.t0) * 1000.0
        stage_sum = sum(trace.stages.values())
        err_ms = abs(total_ms - stage_sum)
        err_pct = (
            err_ms / total_ms * 100.0 if total_ms > 0 else 0.0
        )
        sampled = self._keep(trace.seq)
        with self._lock:
            self.finished += 1
            p = trace.priority
            wins = self._stage_win.get(p)
            if wins is None:
                wins = self._stage_win[p] = {}
            for stage, ms in trace.stages.items():
                win = wins.get(stage)
                if win is None:
                    win = wins[stage] = deque(maxlen=self.window)
                win.append(ms)
            e2e = self._e2e_win.get(p)
            if e2e is None:
                e2e = self._e2e_win[p] = deque(maxlen=self.window)
            e2e.append(total_ms)
            self._recon_n += 1
            self._recon_sum_err_ms += err_ms
            self._recon_sum_err_pct += err_pct
            if err_pct > self._recon_max_err_pct:
                self._recon_max_err_pct = err_pct
            if self.tail_k > 0:
                tail = self._tail.get(p)
                if tail is None:
                    tail = self._tail[p] = []
                heapq.heappush(tail, (total_ms, trace.seq, trace))
                if len(tail) > self.tail_k:
                    heapq.heappop(tail)
            if sampled:
                self.sampled += 1
        if sampled and self.on_sample is not None:
            try:
                self.on_sample(trace.waterfall())
            except Exception:
                pass  # telemetry must never break the request path

    def abort(self, trace: Optional[RequestTrace]) -> None:
        """A request that ended without a served response (shed,
        rejected, failed): counted, never rolled into the stage
        statistics — a 503 written in 50us must not read as a fast
        serve."""
        if trace is None:
            return
        with self._lock:
            self.aborted += 1

    def bind(
        self,
        submit_fn: Callable[..., Any],
        *,
        priority: int = 0,
    ) -> Callable[[Any], Any]:
        """Wrap a ``submit(payload, trace=...) -> Future`` callable so
        every submission carries a trace finished on the future's
        resolution — the in-process serve-bench wiring (no socket, so
        no read/admit/respond stages; queue -> coalesce -> dispatch ->
        compute is the whole waterfall)."""

        def submit(payload):
            tr = self.begin(priority)
            try:
                fut = submit_fn(payload, trace=tr)
            except Exception:
                self.abort(tr)
                raise

            def _done(f, tr=tr):
                if not f.cancelled() and f.exception() is None:
                    self.finish(tr)
                else:
                    self.abort(tr)

            fut.add_done_callback(_done)
            return fut

        return submit

    # -- reporting -----------------------------------------------------

    @staticmethod
    def _pcts(win: List[float]) -> Optional[Dict[str, Any]]:
        # lazy: loadgen imports the batcher, which imports this module
        from bdbnn_tpu_torch.serve.loadgen import _pct

        if not win:
            return None
        s = sorted(win)
        return {
            "p50_ms": _pct(s, 50.0),
            "p99_ms": _pct(s, 99.0),
            "mean_ms": round(sum(s) / len(s), 3),
            "n": len(s),
        }

    def _merged_stage_windows(self) -> Dict[str, List[float]]:  # requires-lock: _lock
        merged: Dict[str, List[float]] = {}
        for wins in self._stage_win.values():
            for stage, win in wins.items():
                merged.setdefault(stage, []).extend(win)
        return merged

    @staticmethod
    def _queue_share(
        stage_blocks: Dict[str, Optional[Dict[str, Any]]],
    ) -> Optional[float]:
        """Queue-boundedness: (queue + dispatch) mean over the summed
        stage means — the share `compare` judges so a p99 that moved
        from device-bound to queue-bound regresses even when the
        aggregate p99 is flat."""
        means = {
            s: b["mean_ms"] for s, b in stage_blocks.items()
            if b is not None
        }
        total = sum(means.values())
        if total <= 0:
            return None
        waiting = means.get("queue", 0.0) + means.get("dispatch", 0.0)
        return round(waiting / total, 4)

    def stats(self) -> Dict[str, Any]:
        """The live snapshot ``/statsz`` and the periodic ``rtrace``
        stats events carry: per-stage p50/p99 over the rolling windows
        (merged across priorities — compact on purpose), end-to-end
        p99 per priority, counts."""
        from bdbnn_tpu_torch.serve.loadgen import _pct

        with self._lock:
            # _merged_stage_windows already builds fresh lists — no
            # second copy under the lock the request path contends on
            merged = self._merged_stage_windows()
            e2e = {p: list(w) for p, w in self._e2e_win.items()}
            finished, aborted, sampled = (
                self.finished, self.aborted, self.sampled
            )
        stage_blocks = {
            s: self._pcts(merged.get(s)) for s in STAGES
        }
        return {
            "requests": finished,
            "aborted": aborted,
            "sampled": sampled,
            "stage_p99_ms": {
                s: (b or {}).get("p99_ms") for s, b in stage_blocks.items()
            },
            "e2e_p99_ms_by_priority": {
                str(p): _pct(sorted(w), 99.0)
                for p, w in sorted(e2e.items())
            },
            "queue_share": self._queue_share(stage_blocks),
        }

    def attribution(
        self, *, device: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """The v4 verdict's ``attribution`` block: per-priority
        p50/p99 decomposed by stage, the reconciliation identity
        (stage sum vs server-side end-to-end, over every finished
        request), the slowest-K tail-exemplar table per priority, and
        the clock documentation. ``device`` (optional) attaches the
        engine's own blocked-step statistics as the compute-stage
        cross-check."""
        with self._lock:
            per_p_windows = {
                p: {s: list(w) for s, w in wins.items()}
                for p, wins in self._stage_win.items()
            }
            e2e = {p: list(w) for p, w in self._e2e_win.items()}
            tails = {
                p: [
                    tr.waterfall()
                    for _, _, tr in sorted(
                        t, key=lambda x: (x[0], x[1]), reverse=True
                    )
                ]
                for p, t in self._tail.items()
            }
            merged = self._merged_stage_windows()
            finished, aborted, sampled = (
                self.finished, self.aborted, self.sampled
            )
            recon_n = self._recon_n
            mean_err_ms = (
                self._recon_sum_err_ms / recon_n if recon_n else None
            )
            mean_err_pct = (
                self._recon_sum_err_pct / recon_n if recon_n else None
            )
            max_err_pct = (
                self._recon_max_err_pct if recon_n else None
            )
        stage_blocks = {s: self._pcts(merged.get(s)) for s in STAGES}
        per_priority: Dict[str, Any] = {}
        for p in sorted(set(per_p_windows) | set(e2e)):
            blocks = {
                s: self._pcts(per_p_windows.get(p, {}).get(s))
                for s in STAGES
            }
            per_priority[str(p)] = {
                "e2e": self._pcts(e2e.get(p, [])),
                "stages": blocks,
                "queue_share": self._queue_share(blocks),
            }
        ok = None
        if recon_n:
            ok = bool(
                mean_err_pct <= RECON_TOL_PCT
                or mean_err_ms <= RECON_FLOOR_MS
            )
        return {
            # both clocks a serving verdict mixes, named explicitly so
            # nobody subtracts a client latency from a server span:
            "clocks": {
                "server": (
                    "time.perf_counter, one shared base per process; "
                    "spans stamped from request receipt — cannot see "
                    "connect/accept backlog"
                ),
                "client": (
                    "time.perf_counter charged from the SCHEDULED "
                    "arrival (serve/loadgen.py, no coordinated "
                    "omission) — includes network + backlog wait the "
                    "server never observes"
                ),
            },
            "sample_every": self.sample_every,
            "tail_k": self.tail_k,
            "window": self.window,
            "requests": finished,
            "aborted": aborted,
            "sampled": sampled,
            "stages": stage_blocks,
            "queue_share": self._queue_share(stage_blocks),
            "per_priority": per_priority,
            "reconciliation": {
                "requests": recon_n,
                "mean_abs_err_ms": (
                    round(mean_err_ms, 4)
                    if mean_err_ms is not None else None
                ),
                "mean_abs_err_pct": (
                    round(mean_err_pct, 3)
                    if mean_err_pct is not None else None
                ),
                "max_abs_err_pct": (
                    round(max_err_pct, 3)
                    if max_err_pct is not None else None
                ),
                "tolerance_pct": RECON_TOL_PCT,
                "floor_ms": RECON_FLOOR_MS,
                "ok": ok,
            },
            "tail": {str(p): t for p, t in sorted(tails.items())},
            "device": device,
        }



class FleetTrace(RequestTrace):
    """One proxied request's cross-host waterfall: the router's own
    stages (FLEET_STAGES order) plus the backend's stitched stage
    block. Same stamp/add/sync arithmetic as :class:`RequestTrace` —
    every router-side duration is on the router's ``perf_counter``;
    the backend block arrives as durations over the wire and is never
    mixed into router-clock arithmetic."""

    __slots__ = (
        "trace_id", "host", "attempts", "backend", "backend_total_ms",
    )

    def __init__(
        self, seq: int, priority: int, tenant: Optional[str],
        t0: float, trace_id: str,
    ):
        super().__init__(seq, priority, tenant, t0)
        self.trace_id = trace_id
        self.host: Optional[str] = None  # label of the answering host
        self.attempts = 0
        self.backend: Optional[Dict[str, float]] = None
        self.backend_total_ms: Optional[float] = None

    def slowest_stage(self) -> Optional[str]:
        """The single most expensive span of this request, across both
        sides of the hop — ``retry_hop`` / ``network`` name the router
        side, ``backend.compute`` etc. name the host side — so a tail
        exemplar always names host AND stage."""
        spans = {s: ms for s, ms in self.stages.items()}
        for s, ms in (self.backend or {}).items():
            spans[f"backend.{s}"] = ms
        if not spans:
            return None
        return max(spans.items(), key=lambda kv: kv[1])[0]

    def waterfall(self) -> Dict[str, Any]:
        out = {
            "trace": self.trace_id,
            "seq": self.seq,
            "priority": self.priority,
            "tenant": self.tenant,
            "host": self.host,
            "attempts": self.attempts,
            "total_ms": round((self._last - self.t0) * 1000.0, 3),
            "stages": {
                s: round(self.stages[s], 3)
                for s in FLEET_STAGES if s in self.stages
            },
            "backend_total_ms": (
                round(self.backend_total_ms, 3)
                if self.backend_total_ms is not None else None
            ),
            "backend": (
                {
                    s: round(self.backend[s], 3)
                    for s in STAGES if s in self.backend
                }
                if self.backend is not None else None
            ),
            "slowest_stage": self.slowest_stage(),
        }
        return out


class FleetTracer(RequestTracer):
    """The router-side span recorder: mints trace ids, stitches the
    backend's self-reported stage block into the router waterfall, and
    assembles the v7 verdict's ``fleet_attribution`` block.

    Stitching contract (the §13 two-clock discipline, one hop up): the
    router measures ``connect`` and the exchange wall on its OWN
    clock; the backend reports its span and stage decomposition as
    DURATIONS in the ``x-rtrace-stages`` header; ``network`` is the
    exchange wall minus the backend span — a difference of two
    durations. A missing/malformed header charges the whole exchange
    to ``network`` and counts the request ``unstitched`` (it still
    reconciles — the identity checks bookkeeping, not the backend)."""

    def __init__(
        self,
        *,
        seed: int = 0,
        sample_every: int = 16,
        tail_k: int = 5,
        window: int = 1024,
        on_sample: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        super().__init__(
            seed=seed, sample_every=sample_every, tail_k=tail_k,
            window=window, on_sample=on_sample,
        )
        # backend stage windows: {priority: {stage: deque[ms]}} and
        # {host: {stage: deque[ms]}} — the per-host view feeds the
        # host-stage-spread gate
        self._backend_win: Dict[int, Dict[str, Any]] = {}  # guarded-by: _lock
        self._host_win: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._host_n: Dict[str, int] = {}  # guarded-by: _lock
        # guarded-by: _lock: _stitched, _unstitched, _recon_violations
        self._stitched = 0
        self._unstitched = 0
        self._recon_violations = 0
        # cumulative retry-hop / e2e ms per priority (shares survive
        # window eviction) — guarded-by: _lock: _retry_ms, _e2e_ms
        self._retry_ms: Dict[int, float] = {}
        self._e2e_ms: Dict[int, float] = {}

    # -- request path --------------------------------------------------

    def begin(
        self,
        priority: int = 0,
        tenant: Optional[str] = None,
        t_start: Optional[float] = None,
    ) -> FleetTrace:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return FleetTrace(
            seq, int(priority), tenant,
            time.perf_counter() if t_start is None else float(t_start),
            mint_trace_id(self.seed, seq),
        )

    def stitch(
        self,
        trace: FleetTrace,
        exchange_ms: float,
        stage_header: Any,
        host: Optional[str],
    ) -> None:
        """Fold the answering host's response into the waterfall:
        parse its ``x-rtrace-stages`` header, derive ``network`` as
        exchange wall minus the backend's span (clamped at 0 — the
        backend span can only legally be SHORTER than the exchange
        that contains it), or charge the whole exchange to ``network``
        when the header is absent/malformed (unstitched)."""
        trace.host = host
        parsed = parse_stage_header(stage_header)
        if parsed is not None and parsed["id"] == trace.trace_id:
            trace.backend = parsed["stages"]
            trace.backend_total_ms = parsed["total_ms"]
            trace.add(
                "network",
                max(float(exchange_ms) - parsed["total_ms"], 0.0),
            )
        else:
            trace.backend = None
            trace.backend_total_ms = None
            trace.add("network", float(exchange_ms))

    def finish(self, trace: FleetTrace) -> None:  # type: ignore[override]
        """Roll one relayed-200 request into the fleet statistics.
        The reconciliation identity here is cross-hop: router stages
        (network included) + backend stage sum == router-observed
        end-to-end, within the same tolerance as the single-host
        identity."""
        now = trace._last
        total_ms = (now - trace.t0) * 1000.0
        backend_ms = sum((trace.backend or {}).values())
        stage_sum = sum(trace.stages.values()) + backend_ms
        err_ms = abs(total_ms - stage_sum)
        err_pct = (
            err_ms / total_ms * 100.0 if total_ms > 0 else 0.0
        )
        sampled = self._keep(trace.seq)
        with self._lock:
            self.finished += 1
            p = trace.priority
            wins = self._stage_win.get(p)
            if wins is None:
                wins = self._stage_win[p] = {}
            for stage, ms in trace.stages.items():
                win = wins.get(stage)
                if win is None:
                    win = wins[stage] = deque(maxlen=self.window)
                win.append(ms)
            e2e = self._e2e_win.get(p)
            if e2e is None:
                e2e = self._e2e_win[p] = deque(maxlen=self.window)
            e2e.append(total_ms)
            if trace.backend is not None:
                self._stitched += 1
                bwins = self._backend_win.get(p)
                if bwins is None:
                    bwins = self._backend_win[p] = {}
                hwins = None
                if trace.host is not None:
                    hwins = self._host_win.get(trace.host)
                    if hwins is None:
                        hwins = self._host_win[trace.host] = {}
                for stage, ms in trace.backend.items():
                    win = bwins.get(stage)
                    if win is None:
                        win = bwins[stage] = deque(maxlen=self.window)
                    win.append(ms)
                    if hwins is not None:
                        win = hwins.get(stage)
                        if win is None:
                            win = hwins[stage] = deque(
                                maxlen=self.window
                            )
                        win.append(ms)
            else:
                self._unstitched += 1
            if trace.host is not None:
                self._host_n[trace.host] = (
                    self._host_n.get(trace.host, 0) + 1
                )
            self._retry_ms[p] = (
                self._retry_ms.get(p, 0.0)
                + trace.stages.get("retry_hop", 0.0)
            )
            self._e2e_ms[p] = self._e2e_ms.get(p, 0.0) + total_ms
            self._recon_n += 1
            self._recon_sum_err_ms += err_ms
            self._recon_sum_err_pct += err_pct
            if err_pct > self._recon_max_err_pct:
                self._recon_max_err_pct = err_pct
            if err_pct > RECON_TOL_PCT and err_ms > RECON_FLOOR_MS:
                self._recon_violations += 1
            if self.tail_k > 0:
                tail = self._tail.get(p)
                if tail is None:
                    tail = self._tail[p] = []
                heapq.heappush(tail, (total_ms, trace.seq, trace))
                if len(tail) > self.tail_k:
                    heapq.heappop(tail)
            if sampled:
                self.sampled += 1
        if sampled and self.on_sample is not None:
            try:
                self.on_sample(trace.waterfall())
            except Exception:
                pass  # telemetry must never break the proxy path

    # -- reporting -----------------------------------------------------

    @staticmethod
    def _share(retry: float, e2e: float, n: int) -> Optional[float]:
        if n <= 0:
            return None
        if e2e <= 0:
            return 0.0
        return round(retry / e2e, 4)

    def _merged_backend_windows(self) -> Dict[str, List[float]]:  # requires-lock: _lock
        merged: Dict[str, List[float]] = {}
        for wins in self._backend_win.values():
            for stage, win in wins.items():
                merged.setdefault(stage, []).extend(win)
        return merged

    def stats(self) -> Dict[str, Any]:
        """The live router snapshot (``/statsz`` ``rtrace`` block and
        the ``fleet`` stats heartbeat): router-stage and backend-stage
        p99 over the rolling windows, e2e p99 per priority, cumulative
        retry-hop share, stitch counters."""
        from bdbnn_tpu_torch.serve.loadgen import _pct

        with self._lock:
            merged = self._merged_stage_windows()
            bmerged = self._merged_backend_windows()
            e2e = {p: list(w) for p, w in self._e2e_win.items()}
            finished, aborted, sampled = (
                self.finished, self.aborted, self.sampled
            )
            stitched, unstitched = self._stitched, self._unstitched
            retry = sum(self._retry_ms.values())
            e2e_sum = sum(self._e2e_ms.values())
        stage_blocks = {
            s: self._pcts(merged.get(s)) for s in FLEET_STAGES
        }
        backend_blocks = {
            s: self._pcts(bmerged.get(s)) for s in STAGES
        }
        return {
            "requests": finished,
            "aborted": aborted,
            "sampled": sampled,
            "stitched": stitched,
            "unstitched": unstitched,
            "stage_p99_ms": {
                s: (b or {}).get("p99_ms")
                for s, b in stage_blocks.items()
            },
            "backend_stage_p99_ms": {
                s: (b or {}).get("p99_ms")
                for s, b in backend_blocks.items()
            },
            "e2e_p99_ms_by_priority": {
                str(p): _pct(sorted(w), 99.0)
                for p, w in sorted(e2e.items())
            },
            "retry_hop_share": self._share(retry, e2e_sum, finished),
        }

    def attribution(
        self, *, device: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """The v7 verdict's ``fleet_attribution`` block: per-priority
        e2e p50/p99 decomposed into router stages + network + the
        backend stage block, retry-hop share, per-host backend-stage
        spread, slowest-K cross-host exemplars (each naming host AND
        stage), and the cross-hop reconciliation identity."""
        with self._lock:
            per_p = {
                p: {s: list(w) for s, w in wins.items()}
                for p, wins in self._stage_win.items()
            }
            per_p_backend = {
                p: {s: list(w) for s, w in wins.items()}
                for p, wins in self._backend_win.items()
            }
            per_host = {
                h: {s: list(w) for s, w in wins.items()}
                for h, wins in self._host_win.items()
            }
            host_n = dict(self._host_n)
            e2e = {p: list(w) for p, w in self._e2e_win.items()}
            tails = {
                p: [
                    tr.waterfall()
                    for _, _, tr in sorted(
                        t, key=lambda x: (x[0], x[1]), reverse=True
                    )
                ]
                for p, t in self._tail.items()
            }
            merged = self._merged_stage_windows()
            bmerged = self._merged_backend_windows()
            finished, aborted, sampled = (
                self.finished, self.aborted, self.sampled
            )
            stitched, unstitched = self._stitched, self._unstitched
            retry_by_p = dict(self._retry_ms)
            e2e_by_p = dict(self._e2e_ms)
            recon_n = self._recon_n
            violations = self._recon_violations
            mean_err_ms = (
                self._recon_sum_err_ms / recon_n if recon_n else None
            )
            mean_err_pct = (
                self._recon_sum_err_pct / recon_n if recon_n else None
            )
            max_err_pct = (
                self._recon_max_err_pct if recon_n else None
            )
        stage_blocks = {s: self._pcts(merged.get(s)) for s in FLEET_STAGES}
        backend_blocks = {s: self._pcts(bmerged.get(s)) for s in STAGES}
        per_priority: Dict[str, Any] = {}
        for p in sorted(set(per_p) | set(e2e)):
            n_p = len(e2e.get(p, []))
            per_priority[str(p)] = {
                "e2e": self._pcts(e2e.get(p, [])),
                "stages": {
                    s: self._pcts(per_p.get(p, {}).get(s))
                    for s in FLEET_STAGES
                },
                "backend_stages": {
                    s: self._pcts(per_p_backend.get(p, {}).get(s))
                    for s in STAGES
                },
                "retry_hop_share": self._share(
                    retry_by_p.get(p, 0.0), e2e_by_p.get(p, 0.0), n_p,
                ),
            }
        per_host_blocks = {
            h: {
                "requests": host_n.get(h, 0),
                "stages": {
                    s: self._pcts(per_host.get(h, {}).get(s))
                    for s in STAGES
                },
            }
            for h in sorted(set(per_host) | set(host_n))
        }
        # per-host stage spread: for each backend stage, the ratio of
        # the slowest host's p99 to the fastest host's — 1.0 means a
        # perfectly even fleet, and the MAX over stages is the compare
        # gate (a single host slow in a single stage must move it)
        spread: Dict[str, Optional[float]] = {}
        for s in STAGES:
            p99s = []
            for h, wins in per_host.items():
                blk = self._pcts(wins.get(s))
                if blk is not None and blk["p99_ms"] is not None:
                    p99s.append(blk["p99_ms"])
            if len(p99s) >= 2 and min(p99s) > 0:
                spread[s] = round(max(p99s) / min(p99s), 4)
            else:
                spread[s] = None
        spreads = [v for v in spread.values() if v is not None]
        spread_max = max(spreads) if spreads else None
        retry_sum = sum(retry_by_p.values())
        e2e_sum = sum(e2e_by_p.values())
        ok = None
        if recon_n:
            ok = bool(
                (
                    mean_err_pct <= RECON_TOL_PCT
                    or mean_err_ms <= RECON_FLOOR_MS
                )
                and violations == 0
            )
        return {
            "clocks": {
                "router": (
                    "time.perf_counter on the router process; spans "
                    "stamped from request parse — cannot see the "
                    "client's connect/backlog wait"
                ),
                "backend": (
                    "each host's own perf_counter base; its span "
                    "crosses the wire as DURATIONS in "
                    "x-rtrace-stages, never as timestamps"
                ),
                "contract": (
                    "no cross-clock subtraction: network = router "
                    "exchange wall minus the backend's self-reported "
                    "span (two durations)"
                ),
            },
            "sample_every": self.sample_every,
            "tail_k": self.tail_k,
            "window": self.window,
            "requests": finished,
            "aborted": aborted,
            "sampled": sampled,
            "stitched": stitched,
            "unstitched": unstitched,
            "stages": stage_blocks,
            "backend_stages": backend_blocks,
            "retry_hop_share": self._share(
                retry_sum, e2e_sum, finished,
            ),
            "per_priority": per_priority,
            "per_host": per_host_blocks,
            "host_stage_spread": spread,
            "host_stage_spread_max": spread_max,
            "reconciliation": {
                "requests": recon_n,
                "stitched": stitched,
                "unstitched": unstitched,
                "violations": violations,
                "mean_abs_err_ms": (
                    round(mean_err_ms, 4)
                    if mean_err_ms is not None else None
                ),
                "mean_abs_err_pct": (
                    round(mean_err_pct, 3)
                    if mean_err_pct is not None else None
                ),
                "max_abs_err_pct": (
                    round(max_err_pct, 3)
                    if max_err_pct is not None else None
                ),
                "tolerance_pct": RECON_TOL_PCT,
                "floor_ms": RECON_FLOOR_MS,
                "ok": ok,
            },
            "tail": {str(p): t for p, t in sorted(tails.items())},
            "device": device,
        }


class HostStatsWindows:
    """The fleet metrics plane's storage: per-(host, priority, stage)
    rolling windows merged from each host's scraped ``/statsz`` rtrace
    block, with per-host failure counters and staleness.

    The scrape loop (FleetRouter's stats pump) calls ``record`` after
    a successful bounded-timeout scrape and ``record_failure`` when
    one times out or errors; ``stale_after`` consecutive failures mark
    that host's window stale — the merged view then EXCLUDES it (an
    autoscaler must never act on a wedged host's frozen numbers) and
    ``watch`` renders the host as stale. A single wedged host can
    never stall the pump: every scrape carries its own timeout and a
    failure only moves counters."""

    def __init__(self, *, window: int = 64, stale_after: int = 3):
        if window < 1:
            raise ValueError("window must be >= 1")
        if stale_after < 1:
            raise ValueError("stale_after must be >= 1")
        self.window = int(window)
        self.stale_after = int(stale_after)
        self._lock = threading.Lock()
        # per-host scrape state:
        # {host: {"stage": {stage: deque[p99_ms]},
        #         "e2e": {priority: deque[p99_ms]},
        #         "last": <latest rtrace block>,
        #         "t_ok": perf_counter of the last good scrape}}
        self._hosts: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        # guarded-by: _lock: _scrapes, _failures, _fail_streak
        self._scrapes: Dict[str, int] = {}
        self._failures: Dict[str, int] = {}
        self._fail_streak: Dict[str, int] = {}

    def record(self, host: str, rtrace_block: Dict[str, Any]) -> None:
        """One good scrape: roll the host's reported per-stage and
        per-priority p99s into its windows and clear its fail streak."""
        if not isinstance(rtrace_block, dict):
            return self.record_failure(host)
        stage_p99 = rtrace_block.get("stage_p99_ms") or {}
        e2e_p99 = rtrace_block.get("e2e_p99_ms_by_priority") or {}
        now = time.perf_counter()
        with self._lock:
            state = self._hosts.get(host)
            if state is None:
                state = self._hosts[host] = {
                    "stage": {}, "e2e": {}, "last": None, "t_ok": None,
                }
            for stage, p99 in stage_p99.items():
                if not isinstance(p99, (int, float)):
                    continue
                if not math.isfinite(p99):
                    continue
                win = state["stage"].get(stage)
                if win is None:
                    win = state["stage"][stage] = deque(
                        maxlen=self.window
                    )
                win.append(float(p99))
            for prio, p99 in e2e_p99.items():
                if not isinstance(p99, (int, float)):
                    continue
                if not math.isfinite(p99):
                    continue
                win = state["e2e"].get(str(prio))
                if win is None:
                    win = state["e2e"][str(prio)] = deque(
                        maxlen=self.window
                    )
                win.append(float(p99))
            state["last"] = rtrace_block
            state["t_ok"] = now
            self._scrapes[host] = self._scrapes.get(host, 0) + 1
            self._fail_streak[host] = 0

    def record_failure(self, host: str) -> None:
        """A scrape that timed out or errored: counters only — the
        host's windows keep their last-known numbers but go stale
        after ``stale_after`` consecutive failures."""
        with self._lock:
            self._failures[host] = self._failures.get(host, 0) + 1
            self._fail_streak[host] = self._fail_streak.get(host, 0) + 1

    def _stale(self, host: str) -> bool:  # requires-lock: _lock
        return self._fail_streak.get(host, 0) >= self.stale_after

    def snapshot(self) -> Dict[str, Any]:
        """The live plane: per-host windowed stage/e2e percentiles
        with staleness, plus a merged view over FRESH hosts only (per
        stage and per priority, the worst fresh host's windowed p99 —
        the number the future autoscaler keys on)."""
        with self._lock:
            hosts = {
                h: {
                    "stage": {s: list(w) for s, w in st["stage"].items()},
                    "e2e": {p: list(w) for p, w in st["e2e"].items()},
                    "last": st["last"],
                    "t_ok": st["t_ok"],
                }
                for h, st in self._hosts.items()
            }
            scrapes = dict(self._scrapes)
            failures = dict(self._failures)
            streaks = dict(self._fail_streak)
        # a host we have only ever failed to scrape still shows up
        for h in set(failures) - set(hosts):
            hosts[h] = {"stage": {}, "e2e": {}, "last": None, "t_ok": None}
        now = time.perf_counter()
        out_hosts: Dict[str, Any] = {}
        merged_stage: Dict[str, List[float]] = {}
        merged_e2e: Dict[str, List[float]] = {}
        fresh = stale = 0
        for h in sorted(hosts):
            st = hosts[h]
            is_stale = streaks.get(h, 0) >= self.stale_after
            if is_stale:
                stale += 1
            else:
                fresh += 1
            stage_blocks = {
                s: RequestTracer._pcts(st["stage"].get(s))
                for s in STAGES
            }
            e2e_blocks = {
                p: RequestTracer._pcts(w)
                for p, w in sorted(st["e2e"].items())
            }
            out_hosts[h] = {
                "stale": is_stale,
                "scrapes": scrapes.get(h, 0),
                "failures": failures.get(h, 0),
                "fail_streak": streaks.get(h, 0),
                "age_s": (
                    round(now - st["t_ok"], 3)
                    if st["t_ok"] is not None else None
                ),
                "stage_p99_ms": {
                    s: (b or {}).get("p99_ms")
                    for s, b in stage_blocks.items()
                },
                "e2e_p99_ms_by_priority": {
                    p: (b or {}).get("p99_ms")
                    for p, b in e2e_blocks.items()
                },
                "queue_share": (st["last"] or {}).get("queue_share"),
            }
            if not is_stale:
                for s, win in st["stage"].items():
                    merged_stage.setdefault(s, []).extend(win)
                for p, win in st["e2e"].items():
                    merged_e2e.setdefault(p, []).extend(win)
        merged = {
            "stage_p99_ms": {
                s: (RequestTracer._pcts(merged_stage.get(s)) or {}).get(
                    "p99_ms"
                )
                for s in STAGES
            },
            "e2e_p99_ms_by_priority": {
                p: (RequestTracer._pcts(w) or {}).get("p99_ms")
                for p, w in sorted(merged_e2e.items())
            },
        }
        return {
            "window": self.window,
            "stale_after": self.stale_after,
            "hosts_fresh": fresh,
            "hosts_stale": stale,
            "hosts": out_hosts,
            "merged": merged,
        }


__all__ = [
    "FLEET_STAGES",
    "RECON_FLOOR_MS",
    "RECON_TOL_PCT",
    "STAGES",
    "STAGE_HEADER",
    "STAGE_HEADER_MAX_LEN",
    "TRACE_CTX_MAX_LEN",
    "TRACE_HEADER",
    "FleetTrace",
    "FleetTracer",
    "HostStatsWindows",
    "RequestTrace",
    "RequestTracer",
    "encode_stage_header",
    "encode_trace_context",
    "mint_trace_id",
    "parse_stage_header",
    "parse_trace_context",
    "pop_future_answered_by",
    "pop_future_timing",
    "set_future_answered_by",
    "set_future_timing",
]

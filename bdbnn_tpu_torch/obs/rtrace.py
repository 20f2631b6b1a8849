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
of serve/engine.py, so an empty stage window lands as ``null``.

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
parses to ``None`` (a fresh local trace), never to an error. The
cross-host ``FleetTrace``/``FleetTracer`` and ``HostStatsWindows`` wait
for the port's fleet router (ROADMAP A, Later 11).
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
        # lazy: the engine module imports torch, which the batcher's
        # users (and this module) need not load
        from bdbnn_tpu_torch.serve.engine import _pct

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
        from bdbnn_tpu_torch.serve.engine import _pct

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



__all__ = [
    "RECON_FLOOR_MS",
    "RECON_TOL_PCT",
    "STAGES",
    "STAGE_HEADER",
    "STAGE_HEADER_MAX_LEN",
    "TRACE_CTX_MAX_LEN",
    "TRACE_HEADER",
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

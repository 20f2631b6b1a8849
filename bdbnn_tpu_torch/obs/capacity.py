"""Capacity & demand observatory: traffic ledgers, utilization
windows, and the SLO error-budget burn-rate plane — the port's copy of
the host half of ``bdbnn_tpu/obs/capacity.py`` (stdlib only).

The signals come from accounting sites the HTTP front end
(serve/http.py) already owns — no device synchronisation:

- :class:`DemandLedger` — rolling per-(model, tenant, priority)
  traffic windows: offered vs admitted vs completed vs shed rps, with
  the ledger identity ``offered == admitted + rejected + shed``
  enforced per key (``completed``/``failed`` are terminal outcomes of
  the admitted population, not entry dispositions). The identity delta
  is the number of requests still mid-decision, so at any quiescent
  point (drain, end of a test) it is exactly zero.
- :class:`UtilizationWindows` — rolling host-utilization gauges:
  replica busy fraction and batch occupancy (serve/pool.py,
  serve/batching.py), rtrace queue share (obs/rtrace.py), admission
  token headroom (serve/admission.py), plus the engine's static
  residency block (``InferenceEngine.residency()``) captured once at
  startup.
- :class:`SLOBudget` — the per-priority error-budget plane. Each
  (priority, objective) pair runs a fast AND a slow burn-rate window
  through the :class:`~bdbnn_tpu_torch.obs.health.DetectorState`
  warmup -> debounce -> hysteresis machine; objectives come from
  ``--slo-p99-ms`` (latency: a p99 target budgets 1% of requests over
  it) and ``--slo-shed-rate`` (shed fraction). A breach emits a
  ``capacity`` event (phase ``breach``; ``recovered`` closes the
  episode) and the episode ledger lands in the verdict.
- :func:`saturation_headroom` — estimated capacity (completed rps over
  busy fraction), headroom rps (capacity minus offered demand —
  negative exactly while demand exceeds what the host serves), and
  seconds-to-saturation at the observed demand slope.
- :class:`CapacityPlane` — one host's composition of the three: the
  live ``/statsz`` ``capacity`` block and the verdict's nullable v8
  ``capacity`` block.

Burn rate = (observed bad fraction) / (budgeted bad fraction); a breach
requires BOTH windows over the threshold — the fast window proves it is
happening now, the slow one that it is not a blip.

One level up, :class:`FleetCapacityWindows` is the fleet router's merge
of the ``capacity`` blocks its stats pump scrapes from each host's
``/statsz`` (serve/fleet.py): per-host rows, and over the FRESH hosts
only the summed offered and headroom rps and the worst burn rate and
shed ratio. ``stale_after`` failed scrapes in a row take a host out of
the merge, as :class:`~bdbnn_tpu_torch.obs.rtrace.HostStatsWindows` does
for the trace windows.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from bdbnn_tpu_torch.obs.health import DetectorState

# rolling demand window (rps figures are computed over it)
DEFAULT_WINDOW_S = 30.0
# burn-rate windows: fast proves "now", slow proves "not a blip"
DEFAULT_FAST_WINDOW_S = 5.0
DEFAULT_SLOW_WINDOW_S = 30.0
# a p99 objective budgets exactly 1% of requests over the target
P99_BUDGET_FRACTION = 0.01
# budget spent exactly at the allowed rate; above this both windows
# must agree before the detector machine sees a breach
BURN_RATE_THRESHOLD = 1.0
# a zero-traffic denominator or a zero budget could mint inf; burn
# rates are capped so every emitted figure stays finite JSON
BURN_RATE_CAP = 1000.0
DEFAULT_WARMUP = 2
DEFAULT_DEBOUNCE = 2
# below this measured busy fraction a capacity estimate would divide
# by noise — report "unmeasurable" (None), never a fabricated figure
MIN_BUSY_FRACTION = 0.01

LATENCY_OBJECTIVE = "latency"
SHED_OBJECTIVE = "shed"

# entry dispositions (the identity's right-hand side) and terminal
# outcomes of the admitted population
DISPOSITIONS = ("admitted", "rejected", "shed")
COUNTERS = ("offered",) + DISPOSITIONS + ("completed", "failed")


def demand_key(model: str, tenant: str, priority: int) -> str:
    """The ledger's composite key: ``model|tenant|p<priority>`` —
    stable, sortable, and JSON-safe as a dict key."""
    return f"{model}|{tenant}|p{int(priority)}"


class DemandLedger:
    """Rolling per-(model, tenant, priority) traffic windows.

    One call per request at the disposition site the front end already
    owns: ``offered`` at arrival, then exactly one of ``admitted`` /
    ``rejected`` / ``shed`` once the request's fate at the
    admission/queue boundary is known — ``rejected`` and ``shed`` at
    their response sites, ``admitted`` when the request actually
    reached an engine (bumped at its terminal ``completed`` /
    ``failed``, so a queued request that a late shed turns away is
    never double-counted). The per-key identity delta
    ``offered - (admitted + rejected + shed)`` is therefore exactly
    the number of requests currently queued or computing: a live
    in-flight gauge while serving, zero at any quiescent point.
    Totals are monotonic; the rolling windows hold event stamps pruned
    to ``window_s`` so ``snapshot`` can report rps per key with no
    background thread.
    """

    def __init__(
        self,
        *,
        window_s: float = DEFAULT_WINDOW_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        # guarded-by: _lock: _totals, _stamps
        # {key: {counter: monotonic total}}
        self._totals: Dict[str, Dict[str, int]] = {}
        # {key: {counter: deque[monotonic stamp]}}
        self._stamps: Dict[str, Dict[str, deque]] = {}

    def _entry(self, key: str) -> Tuple[Dict[str, int], Dict[str, deque]]:  # requires-lock: _lock
        totals = self._totals.get(key)
        if totals is None:
            totals = self._totals[key] = {c: 0 for c in COUNTERS}
            self._stamps[key] = {c: deque() for c in COUNTERS}
        return totals, self._stamps[key]

    def _bump(
        self, model: str, tenant: str, priority: int, counter: str
    ) -> None:
        now = self._clock()
        key = demand_key(model, tenant, priority)
        horizon = now - self.window_s
        with self._lock:
            totals, stamps = self._entry(key)
            totals[counter] += 1
            win = stamps[counter]
            win.append(now)
            while win and win[0] < horizon:
                win.popleft()

    # -- the per-request feed (one call per disposition) ---------------

    def offered(self, model: str, tenant: str, priority: int) -> None:
        """A request arrived (the ``submitted`` site)."""
        self._bump(model, tenant, priority, "offered")

    def admitted(self, model: str, tenant: str, priority: int) -> None:
        """The request genuinely reached an engine (called alongside
        its terminal ``completed``/``failed``)."""
        self._bump(model, tenant, priority, "admitted")

    def rejected(self, model: str, tenant: str, priority: int) -> None:
        """Turned away as the tenant's own doing: over-quota (429) or
        a malformed body (400)."""
        self._bump(model, tenant, priority, "rejected")

    def shed(self, model: str, tenant: str, priority: int) -> None:
        """Server-side shed: draining, queue full, or no healthy
        replica (the 503 family)."""
        self._bump(model, tenant, priority, "shed")

    def completed(self, model: str, tenant: str, priority: int) -> None:
        self._bump(model, tenant, priority, "completed")

    def failed(self, model: str, tenant: str, priority: int) -> None:
        self._bump(model, tenant, priority, "failed")

    # -- reporting -----------------------------------------------------

    @staticmethod
    def _rps(win: deque, horizon: float, span: float) -> float:  # requires-lock: _lock
        # span = min(window_s, elapsed): a 2-second-old run reporting
        # over the full window would dilute every rate toward zero
        n = 0
        for t in reversed(win):
            if t < horizon:
                break
            n += 1
        return round(n / span, 4)

    def offered_slope_rps_per_s(self) -> Optional[float]:
        """The observed demand slope: offered rps in the newest half
        of the window minus the older half, over half a window — the
        d(demand)/dt figure :func:`saturation_headroom` extrapolates
        along. None until a full window of history exists."""
        now = self._clock()
        half = self.window_s / 2.0
        mid = now - half
        horizon = now - self.window_s
        with self._lock:
            oldest = None
            recent = older = 0
            for stamps in self._stamps.values():
                win = stamps["offered"]
                if win:
                    oldest = win[0] if oldest is None else min(oldest, win[0])
                for t in win:
                    if t < horizon:
                        continue
                    if t >= mid:
                        recent += 1
                    else:
                        older += 1
        if oldest is None or oldest > mid:
            return None  # not even the older half has history yet
        return round(((recent / half) - (older / half)) / half, 4)

    def snapshot(self) -> Dict[str, Any]:
        """The live demand table: per-key totals + windowed rps, the
        per-key identity check, and by-model / by-tenant rollups."""
        now = self._clock()
        horizon = now - self.window_s
        span = min(self.window_s, max(now - self._t0, 1e-9))
        with self._lock:
            keys = {
                key: (
                    dict(totals),
                    {c: self._rps(self._stamps[key][c], horizon, span)
                     for c in COUNTERS},
                )
                for key, totals in self._totals.items()
            }
        table: Dict[str, Any] = {}
        by_model: Dict[str, Dict[str, int]] = {}
        by_tenant: Dict[str, Dict[str, int]] = {}
        in_flight = 0
        identity_ok = True
        shed_ratio_max: Optional[float] = None
        offered_rps_total = 0.0
        for key in sorted(keys):
            totals, rps = keys[key]
            delta = totals["offered"] - (
                totals["admitted"] + totals["rejected"] + totals["shed"]
            )
            in_flight += max(delta, 0)
            if delta != 0:
                identity_ok = False
            model, tenant, _ = key.split("|", 2)
            for roll, name in ((by_model, model), (by_tenant, tenant)):
                agg = roll.setdefault(name, {c: 0 for c in COUNTERS})
                for c in COUNTERS:
                    agg[c] += totals[c]
            if totals["offered"]:
                ratio = round(totals["shed"] / totals["offered"], 6)
                shed_ratio_max = (
                    ratio if shed_ratio_max is None
                    else max(shed_ratio_max, ratio)
                )
            offered_rps_total += rps["offered"]
            table[key] = {
                **totals,
                "identity_delta": delta,
                **{f"{c}_rps": rps[c]
                   for c in ("offered", "admitted", "completed", "shed")},
            }
        return {
            "window_s": self.window_s,
            "keys": table,
            "by_model": by_model,
            "by_tenant": by_tenant,
            "offered_rps": round(offered_rps_total, 4),
            "in_flight_decisions": in_flight,
            "identity_ok": identity_ok,
            "demand_shed_ratio_max": shed_ratio_max,
        }


class UtilizationWindows:
    """Rolling host-utilization gauges, sampled by the stats pump at
    the cadence it already runs. Every gauge is optional per sample —
    a non-pooled front end has no replica busy fraction, a traced-off
    run has no queue share — and absent gauges report None, never a
    fabricated figure."""

    GAUGES = (
        "busy_fraction", "occupancy", "queue_share",
        "admission_headroom",
    )

    def __init__(self, *, window: int = 64):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self._lock = threading.Lock()
        # guarded-by: _lock: _win, _residency
        self._win: Dict[str, deque] = {
            g: deque(maxlen=self.window) for g in self.GAUGES
        }
        self._residency: Optional[Dict[str, Any]] = None

    def set_residency(self, block: Optional[Dict[str, Any]]) -> None:
        """The engine's packed-residency block (resident bytes,
        per-bucket activation bytes) — static after warmup, captured
        once at startup."""
        with self._lock:
            self._residency = block

    def sample(self, **gauges: Optional[float]) -> None:
        unknown = set(gauges) - set(self.GAUGES)
        if unknown:
            raise ValueError(f"unknown utilization gauge(s): {unknown}")
        with self._lock:
            for g, v in gauges.items():
                if v is None:
                    continue
                v = float(v)
                if math.isfinite(v):
                    self._win[g].append(v)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            wins = {g: list(w) for g, w in self._win.items()}
            residency = self._residency
        out: Dict[str, Any] = {}
        for g, w in wins.items():
            out[g] = {
                "last": round(w[-1], 4) if w else None,
                "mean": round(sum(w) / len(w), 4) if w else None,
                "n": len(w),
            }
        out["residency"] = residency
        return out


def saturation_headroom(
    *,
    offered_rps: Optional[float],
    completed_rps: Optional[float],
    busy_fraction: Optional[float],
    slope_rps_per_s: Optional[float] = None,
) -> Dict[str, Any]:
    """The saturation-headroom estimate.

    The host completes ``completed_rps`` using ``busy_fraction`` of
    its serving capacity, so at full utilization it could serve about
    ``completed_rps / busy_fraction`` — the capacity estimate.
    Headroom is capacity minus offered demand: negative exactly while
    demand exceeds what the host can serve (a flash crowd), positive
    in steady state. At the observed demand slope, the budget runs
    out in ``headroom / slope`` seconds. Every figure is None when
    its inputs are unmeasurable — an autoscaler must never act on a
    fabricated estimate."""
    capacity = None
    if (
        completed_rps is not None
        and busy_fraction is not None
        and busy_fraction >= MIN_BUSY_FRACTION
    ):
        capacity = round(float(completed_rps) / float(busy_fraction), 4)
    headroom = None
    if capacity is not None and offered_rps is not None:
        headroom = round(capacity - float(offered_rps), 4)
    seconds = None
    if (
        headroom is not None and headroom > 0
        and slope_rps_per_s is not None and slope_rps_per_s > 0
    ):
        seconds = round(headroom / slope_rps_per_s, 2)
    return {
        "capacity_rps_est": capacity,
        "headroom_rps": headroom,
        "demand_slope_rps_per_s": slope_rps_per_s,
        "seconds_to_saturation": seconds,
    }


def _burn(bad: int, total: int, budget_fraction: float) -> Optional[float]:
    """Burn rate over one window: observed bad fraction over the
    budgeted fraction, capped (finite JSON, always). None with no
    traffic — an empty window is "not measured", never a clean bill."""
    if total <= 0:
        return None
    frac = bad / total
    if budget_fraction <= 0:
        return BURN_RATE_CAP if frac > 0 else 0.0
    return round(min(frac / budget_fraction, BURN_RATE_CAP), 4)


class SLOBudget:
    """The per-priority error-budget burn-rate plane.

    One detector per (priority class, objective), each the shared
    :class:`~bdbnn_tpu_torch.obs.health.DetectorState` machine — warmup
    (first ticks are never judged), debounce (a breach must persist),
    hysteresis (fires once, re-arms on recovery). ``feed`` records
    one terminal request event (latency for completions, the shed
    flag for sheds); ``evaluate`` is called by the stats pump at its
    existing cadence and returns the fired/recovered transitions for
    the caller to emit as ``capacity`` events.
    """

    def __init__(
        self,
        *,
        slo_p99_ms: float = 0.0,
        slo_shed_rate: float = 0.0,
        priorities: int = 3,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        warmup: int = DEFAULT_WARMUP,
        debounce: int = DEFAULT_DEBOUNCE,
        burn_threshold: float = BURN_RATE_THRESHOLD,
        clock: Callable[[], float] = time.monotonic,
    ):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s}/{slow_window_s}"
            )
        self.slo_p99_ms = float(slo_p99_ms)
        self.slo_shed_rate = float(slo_shed_rate)
        self.priorities = int(priorities)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        # guarded-by: _lock: _events, _states, _peaks, _open, _episodes
        # per priority: deque[(stamp, latency_ms or None, shed)]
        self._events: Dict[int, deque] = {
            p: deque() for p in range(self.priorities)
        }
        self._states: Dict[str, DetectorState] = {}
        self._peaks: Dict[str, float] = {}
        self._open: Dict[str, Dict[str, Any]] = {}
        self._episodes: List[Dict[str, Any]] = []
        for p in range(self.priorities):
            for objective in self.objectives():
                self._states[self._detector(p, objective)] = (
                    DetectorState(warmup, debounce)
                )

    def objectives(self) -> Tuple[str, ...]:
        out = []
        if self.slo_p99_ms > 0:
            out.append(LATENCY_OBJECTIVE)
        if self.slo_shed_rate > 0:
            out.append(SHED_OBJECTIVE)
        return tuple(out)

    @staticmethod
    def _detector(priority: int, objective: str) -> str:
        return f"p{priority}:{objective}"

    def feed(
        self, priority: int, *, latency_ms: Optional[float] = None,
        shed: bool = False,
    ) -> None:
        """One terminal request event: a completion carries its
        latency, a shed carries the flag. Cheap append under the lock
        — safe at the front end's response sites."""
        p = int(priority)
        if not 0 <= p < self.priorities:
            return
        now = self._clock()
        horizon = now - self.slow_window_s
        with self._lock:
            win = self._events[p]
            win.append((now, latency_ms, bool(shed)))
            while win and win[0][0] < horizon:
                win.popleft()

    def _window_counts(
        self, win: deque, horizon: float
    ) -> Tuple[int, int, int]:  # requires-lock: _lock
        """(total, over-latency-target, shed) at or after horizon."""
        total = bad_lat = shed = 0
        for t, lat, was_shed in reversed(win):
            if t < horizon:
                break
            total += 1
            if was_shed:
                shed += 1
            elif lat is not None and lat > self.slo_p99_ms:
                bad_lat += 1
        return total, bad_lat, shed

    def _burn_rows(self, now: float) -> List[Tuple]:  # requires-lock: _lock
        """(name, priority, objective, burn_fast, burn_slow, breach,
        calm, worst) per detector — the shared computation ``peek``
        reads and ``evaluate`` feeds the machines."""
        rows: List[Tuple] = []
        for p in range(self.priorities):
            win = self._events[p]
            fast = self._window_counts(win, now - self.fast_window_s)
            slow = self._window_counts(win, now - self.slow_window_s)
            for objective in self.objectives():
                name = self._detector(p, objective)
                if objective == LATENCY_OBJECTIVE:
                    burn_fast = _burn(fast[1], fast[0], P99_BUDGET_FRACTION)
                    burn_slow = _burn(slow[1], slow[0], P99_BUDGET_FRACTION)
                else:
                    burn_fast = _burn(fast[2], fast[0], self.slo_shed_rate)
                    burn_slow = _burn(slow[2], slow[0], self.slo_shed_rate)
                breach = (
                    burn_fast is not None and burn_slow is not None
                    and burn_fast > self.burn_threshold
                    and burn_slow > self.burn_threshold
                )
                # recovery = the fast window back under budget (the
                # slow window may legitimately lag an ended burst)
                calm = burn_fast is not None and (
                    burn_fast <= self.burn_threshold
                )
                worst = max(
                    b for b in (burn_fast, burn_slow, 0.0)
                    if b is not None
                )
                rows.append(
                    (name, p, objective, burn_fast, burn_slow, breach,
                     calm, worst)
                )
        return rows

    def _row_dict(
        self, name: str, p: int, objective: str, burn_fast, burn_slow,
        breach: bool,
    ) -> Dict[str, Any]:  # requires-lock: _lock
        state = self._states[name]
        return {
            "priority": p,
            "objective": objective,
            "burn_rate_fast": burn_fast,
            "burn_rate_slow": burn_slow,
            "threshold": self.burn_threshold,
            "breach": breach,
            "latched": state.latched,
            "eligible": state.seen > state.warmup,
        }

    def peek(self) -> Dict[str, Any]:
        """The current per-detector burn-rate table WITHOUT ticking the
        detector machines — what ``/statsz`` serves. Only the stats
        pump's ``evaluate`` advances warmup/debounce state; a client
        scraping fast must not accelerate the debounce clock."""
        now = self._clock()
        with self._lock:
            return {
                name: self._row_dict(name, p, obj, bf, bs, breach)
                for name, p, obj, bf, bs, breach, _, _ in self._burn_rows(
                    now
                )
            }

    def evaluate(self) -> Dict[str, Any]:
        """One budget tick: burn rates per detector over both windows,
        run through the detector machines. Returns the live table plus
        the ``fired`` / ``recovered`` transitions of THIS tick (what
        the caller emits as ``capacity`` events)."""
        now = self._clock()
        fired: List[Dict[str, Any]] = []
        recovered: List[Dict[str, Any]] = []
        detectors: Dict[str, Any] = {}
        with self._lock:
            for (name, p, objective, burn_fast, burn_slow, breach,
                 calm, worst) in self._burn_rows(now):
                state = self._states[name]
                was_latched = state.latched
                just_fired = state.update(breach, recovered=calm)
                if worst > self._peaks.get(name, 0.0):
                    self._peaks[name] = worst
                row = self._row_dict(
                    name, p, objective, burn_fast, burn_slow, breach
                )
                detectors[name] = row
                if just_fired:
                    episode = {
                        "detector": name,
                        "priority": p,
                        "objective": objective,
                        "t_start": round(time.time(), 3),
                        "t_end": None,
                        "peak_burn_rate": worst,
                    }
                    self._open[name] = episode
                    fired.append({**row, "detector": name})
                elif name in self._open:
                    episode = self._open[name]
                    episode["peak_burn_rate"] = max(
                        episode["peak_burn_rate"], worst
                    )
                    if was_latched and not state.latched:
                        episode["t_end"] = round(time.time(), 3)
                        self._episodes.append(self._open.pop(name))
                        recovered.append({**row, "detector": name})
        return {
            "detectors": detectors,
            "fired": fired,
            "recovered": recovered,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The post-hoc budget ledger: objectives, per-detector peak
        burn rates, every closed episode plus the still-open ones."""
        with self._lock:
            peaks = {k: round(v, 4) for k, v in sorted(self._peaks.items())}
            episodes = [dict(e) for e in self._episodes]
            episodes += [dict(e) for _, e in sorted(self._open.items())]
        burn_max = max(peaks.values()) if peaks else None
        return {
            "objectives": {
                "slo_p99_ms": self.slo_p99_ms or None,
                "slo_shed_rate": self.slo_shed_rate or None,
            },
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "threshold": self.burn_threshold,
            "burn_rate_peaks": peaks,
            "burn_rate_max": burn_max,
            "episodes": episodes,
            "breaches": sum(
                1 for e in episodes if e.get("t_start") is not None
            ),
        }


class CapacityPlane:
    """One host's capacity observatory: the ledger + the utilization
    windows + the budget plane, composed into the live ``/statsz``
    block and the verdict's v8 ``capacity`` block. The front end feeds
    the parts directly (``plane.ledger.offered(...)``,
    ``plane.budget.feed(...)``); the stats pump calls ``sample`` +
    ``evaluate`` at its existing cadence."""

    def __init__(
        self,
        *,
        slo_p99_ms: float = 0.0,
        slo_shed_rate: float = 0.0,
        priorities: int = 3,
        window_s: float = DEFAULT_WINDOW_S,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        warmup: int = DEFAULT_WARMUP,
        debounce: int = DEFAULT_DEBOUNCE,
        util_window: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ledger = DemandLedger(window_s=window_s, clock=clock)
        self.utilization = UtilizationWindows(window=util_window)
        self.budget = SLOBudget(
            slo_p99_ms=slo_p99_ms,
            slo_shed_rate=slo_shed_rate,
            priorities=priorities,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
            warmup=warmup,
            debounce=debounce,
            clock=clock,
        )

    def sample(self, **gauges: Optional[float]) -> None:
        self.utilization.sample(**gauges)

    def evaluate(self) -> Dict[str, Any]:
        return self.budget.evaluate()

    def _headroom(self, demand: Dict[str, Any]) -> Dict[str, Any]:
        util = self.utilization.snapshot()
        completed_rps = sum(
            row.get("completed_rps") or 0.0
            for row in (demand.get("keys") or {}).values()
        )
        return saturation_headroom(
            offered_rps=demand.get("offered_rps"),
            completed_rps=round(completed_rps, 4),
            busy_fraction=(util.get("busy_fraction") or {}).get("mean"),
            slope_rps_per_s=self.ledger.offered_slope_rps_per_s(),
        )

    def live_block(self) -> Dict[str, Any]:
        """The ``/statsz`` ``capacity`` block: current demand table,
        utilization gauges, burn-rate state (a read-only ``peek`` —
        scrapes must not tick the detector machines) and the headroom
        estimate."""
        demand = self.ledger.snapshot()
        return {
            "demand": demand,
            "utilization": self.utilization.snapshot(),
            "slo_budget": {
                "detectors": self.budget.peek(),
                "objectives": {
                    "slo_p99_ms": self.budget.slo_p99_ms or None,
                    "slo_shed_rate": self.budget.slo_shed_rate or None,
                },
            },
            "headroom": self._headroom(demand),
        }

    def verdict_block(self) -> Dict[str, Any]:
        """The verdict's v8 ``capacity`` block. The three flat gates
        ``compare`` judges (``burn_rate_max``, ``headroom_rps``,
        ``demand_shed_ratio_max``) ride at the top level next to the
        full tables they summarize."""
        demand = self.ledger.snapshot()
        budget = self.budget.snapshot()
        headroom = self._headroom(demand)
        return {
            "demand": demand,
            "utilization": self.utilization.snapshot(),
            "slo_budget": budget,
            "headroom": headroom,
            "burn_rate_max": budget.get("burn_rate_max"),
            "headroom_rps": headroom.get("headroom_rps"),
            "demand_shed_ratio_max": demand.get("demand_shed_ratio_max"),
        }


class FleetCapacityWindows:
    """The router-side merge of scraped per-host ``capacity`` blocks,
    under the same staleness discipline as the rtrace metrics plane
    (obs/rtrace.py HostStatsWindows): ``stale_after`` consecutive
    scrape failures freeze a host out of the merged view — an
    autoscaler must never act on a wedged host's frozen numbers."""

    def __init__(self, *, stale_after: int = 3):
        if stale_after < 1:
            raise ValueError("stale_after must be >= 1")
        self.stale_after = int(stale_after)
        self._lock = threading.Lock()
        # guarded-by: _lock: _last, _scrapes, _failures, _fail_streak
        self._last: Dict[str, Optional[Dict[str, Any]]] = {}
        self._scrapes: Dict[str, int] = {}
        self._failures: Dict[str, int] = {}
        self._fail_streak: Dict[str, int] = {}

    def record(
        self, host: str, capacity_block: Optional[Dict[str, Any]]
    ) -> None:
        """One good scrape carrying the host's live capacity block (a
        host running without objectives still reports demand +
        utilization). A payload with no block is a failure — the host
        is not producing the plane."""
        if not isinstance(capacity_block, dict):
            return self.record_failure(host)
        with self._lock:
            self._last[host] = capacity_block
            self._scrapes[host] = self._scrapes.get(host, 0) + 1
            self._fail_streak[host] = 0

    def record_failure(self, host: str) -> None:
        with self._lock:
            self._failures[host] = self._failures.get(host, 0) + 1
            self._fail_streak[host] = self._fail_streak.get(host, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        """Per-host summaries with staleness plus the merged view over
        FRESH hosts only: offered/headroom rps summed (the fleet's
        aggregate demand and remaining capacity), burn-rate max taken
        as the worst fresh host's (one saturated host is a fleet
        problem even when peers are idle)."""
        with self._lock:
            last = dict(self._last)
            scrapes = dict(self._scrapes)
            failures = dict(self._failures)
            streaks = dict(self._fail_streak)
        for h in set(failures) - set(last):
            last[h] = None
        hosts: Dict[str, Any] = {}
        fresh = stale = 0
        merged_offered: Optional[float] = None
        merged_headroom: Optional[float] = None
        merged_burn: Optional[float] = None
        merged_shed: Optional[float] = None
        for h in sorted(last):
            block = last[h]
            is_stale = streaks.get(h, 0) >= self.stale_after
            if is_stale:
                stale += 1
            else:
                fresh += 1
            demand = (block or {}).get("demand") or {}
            headroom = (block or {}).get("headroom") or {}
            budget = (block or {}).get("slo_budget") or {}
            burn_vals = [
                b
                for row in (budget.get("detectors") or {}).values()
                for b in (row.get("burn_rate_fast"),
                          row.get("burn_rate_slow"))
                if isinstance(b, (int, float)) and math.isfinite(b)
            ]
            row = {
                "stale": is_stale,
                "scrapes": scrapes.get(h, 0),
                "failures": failures.get(h, 0),
                "fail_streak": streaks.get(h, 0),
                "offered_rps": demand.get("offered_rps"),
                "headroom_rps": headroom.get("headroom_rps"),
                "capacity_rps_est": headroom.get("capacity_rps_est"),
                "burn_rate_max": max(burn_vals) if burn_vals else None,
                "demand_shed_ratio_max": demand.get(
                    "demand_shed_ratio_max"
                ),
            }
            hosts[h] = row
            if is_stale or block is None:
                continue
            if row["offered_rps"] is not None:
                merged_offered = (merged_offered or 0.0) + row[
                    "offered_rps"
                ]
            if row["headroom_rps"] is not None:
                merged_headroom = (merged_headroom or 0.0) + row[
                    "headroom_rps"
                ]
            if row["burn_rate_max"] is not None:
                merged_burn = (
                    row["burn_rate_max"] if merged_burn is None
                    else max(merged_burn, row["burn_rate_max"])
                )
            if row["demand_shed_ratio_max"] is not None:
                merged_shed = (
                    row["demand_shed_ratio_max"] if merged_shed is None
                    else max(merged_shed, row["demand_shed_ratio_max"])
                )
        return {
            "stale_after": self.stale_after,
            "hosts_fresh": fresh,
            "hosts_stale": stale,
            "hosts": hosts,
            "merged": {
                "offered_rps": (
                    round(merged_offered, 4)
                    if merged_offered is not None else None
                ),
                "headroom_rps": (
                    round(merged_headroom, 4)
                    if merged_headroom is not None else None
                ),
                "burn_rate_max": merged_burn,
                "demand_shed_ratio_max": merged_shed,
            },
        }


__all__ = [
    "BURN_RATE_CAP",
    "BURN_RATE_THRESHOLD",
    "COUNTERS",
    "DISPOSITIONS",
    "LATENCY_OBJECTIVE",
    "P99_BUDGET_FRACTION",
    "SHED_OBJECTIVE",
    "CapacityPlane",
    "DemandLedger",
    "FleetCapacityWindows",
    "SLOBudget",
    "UtilizationWindows",
    "demand_key",
    "saturation_headroom",
]

"""Canary analysis: live-verdict health judgment for a staged rollout —
the port's copy of ``bdbnn_tpu/serve/canary.py``.

A blue/green swap (serve/pool.py) is all-or-nothing: once the
shift starts, every replica ends up on vN+1 whether or not vN+1 is any
good. This module closes the loop the ROADMAP calls "self-driving
rollouts": a **canary stage** routes a configurable traffic fraction
to vN+1 on a subset of replicas, a :class:`CanaryMonitor` compares the
canary's live request windows against the incumbent's, and the verdict
drives the state machine automatically — promote to the full
replica-by-replica shift, or auto-rollback with the registry left
untouched. No human watches ``compare`` output during the rollout; the
comparison IS the rollout gate.

**Detector discipline.** Every detector runs the training-side
warmup→debounce→hysteresis state machine (:class:`obs.health.
DetectorState` — the one machine, reused verbatim so the semantics of
"a breach must persist, then latch" cannot drift between the training
and serving health stacks). Eligibility gates on window sizes instead
of a warmup count: a detector never judges cohorts it has too few
samples to compare, and a smoke-scale canary ends before eligibility
rather than alerting on being small.

==================  ====================================================
``p99_p<P>``          per-priority tail latency: the canary cohort's
                      p99 over its rolling window vs the incumbent's,
                      judged as a ratio with an absolute floor (two
                      sub-ms p99s differing 3x are noise, not a
                      regression). THIS is the detector that catches a
                      canary degrading *only* the premium class while
                      the aggregate p99 stays flat — the exact
                      blindness request attribution exposed.
``unabsorbed``        the canary could not hold its assigned traffic
                      fraction: (sheds + incumbent fallbacks) over the
                      batches assigned to the canary cohort.
``error_rate``        canary engine-failure rate minus the
                      incumbent's (a broken artifact fails requests;
                      that is not load shedding and must not hide).
``fairness``          the canary degrades priorities UNEVENLY: max/min
                      over per-priority canary/incumbent p99 ratios.
``queue_share``       the canary turned queue-bound: its
                      dispatch/(dispatch+compute) share minus the
                      incumbent's, from the replica workers' measured
                      batch splits (obs/rtrace.py future timing).
``logit_drift``       the shadow-mirroring probe: sampled incumbent
                      batches are ALSO executed on the canary, the
                      incumbent's answer goes to the client, and the
                      logits are diffed off the hot path. Because
                      packed 1-bit inference is deterministic and
                      bitwise-exact (serve/engine.py
                      ``max_abs_logit_drift``), the threshold defaults to
                      EXACTLY ZERO — any drift is a real defect, a
                      quality gate no float-serving stack gets this
                      cheaply.
==================  ====================================================

**Decision rule.** Any fired (debounced) detector → ``rollback``, with
the detector as the recorded trigger. ``healthy_evals`` consecutive
clean evaluations with the canary having served at least
``min_samples`` requests → ``promote``. The observation budget
(``max_wait_s``) expiring first resolves conservatively: a canary that
never produced enough evidence is rolled back with trigger
``inconclusive`` — insufficient data is not a green light.

Stdlib-only (serving obs rule): the monitor consumes host floats and
counters; numpy appears only inside the pool's shadow comparator. The
whole episode — trigger, observation windows, per-detector evidence,
decision, rollback disposition — flows as ``canary`` events through
the injected ``on_event`` hook, and :meth:`CanaryMonitor.report` is
the nullable ``canary`` block of SLO verdict v5 that ``compare``
judges (``serve_canary_rollbacks``, ``serve_shadow_logit_drift_max``,
``serve_canary_promote_s``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from bdbnn_tpu_torch.obs.health import DetectorState

# cohort labels — the monitor's windows and the pool's counters key on
# these, and the verdict block renders them verbatim
INCUMBENT = "incumbent"
CANARY = "canary"

# decision values evaluate()/conclude() return and report() records
OBSERVE = "observe"
PROMOTE = "promote"
ROLLBACK = "rollback"

# the non-detector trigger for a rollback forced by an expired
# observation budget: not enough evidence to promote is a rollback,
# never a default-open
INCONCLUSIVE = "inconclusive"


@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """Canary detector thresholds + the observation-loop knobs. Every
    field can be overridden from the CLI via
    ``--canary-threshold NAME=VALUE`` (the obs/health.py override
    pattern, validated at config time)."""

    # observation loop: how often the monitor evaluates, how many
    # consecutive clean evaluations promote, and the hard budget after
    # which an undecided canary rolls back as inconclusive
    eval_interval_s: float = 0.25
    healthy_evals: int = 4
    max_wait_s: float = 60.0
    # eligibility: a detector never compares windows with fewer than
    # this many samples on EITHER side (smoke-scale traffic ends the
    # canary as inconclusive instead of judging noise)
    min_samples: int = 20
    # debounce: a breach must persist this many consecutive eligible
    # evaluations before the detector fires (logit_drift is exempt —
    # the comparison is exact, one drifted sample is a real defect)
    debounce: int = 2
    # rolling window size per (cohort, priority) latency / batch-split
    # deque
    window: int = 512
    # p99_p<P>: canary p99 > ratio x incumbent p99 AND the absolute gap
    # exceeds the floor (sub-ms percentiles differing 3x are noise)
    p99_ratio: float = 2.0
    p99_floor_ms: float = 5.0
    # unabsorbed: (canary sheds + fallbacks) / canary-assigned batches
    unabsorbed_rate: float = 0.5
    # error_rate: canary failure rate minus incumbent failure rate
    error_rate_abs: float = 0.02
    # fairness: max/min over per-priority canary/incumbent p99 ratios
    fairness_ratio_max: float = 3.0
    # queue_share: canary dispatch share minus incumbent dispatch share
    queue_share_abs: float = 0.25
    # logit_drift: max |canary - incumbent| logit difference. ZERO by
    # default on purpose: packed inference is deterministic and
    # bitwise-exact, so any drift is a real defect (see
    # serve/engine.py max_abs_logit_drift)
    logit_drift_abs: float = 0.0


def apply_canary_overrides(
    cfg: CanaryConfig, specs: Sequence[str]
) -> CanaryConfig:
    """``("p99_ratio=3", "min_samples=10", ...)`` -> a new
    CanaryConfig. Unknown names and unparseable values raise
    ValueError at config time, not mid-rollout."""
    if not specs:
        return cfg
    fields = {f.name: f for f in dataclasses.fields(CanaryConfig)}
    updates: Dict[str, Any] = {}
    for spec in specs:
        name, sep, raw = spec.partition("=")
        name = name.strip()
        if not sep or name not in fields:
            raise ValueError(
                f"bad --canary-threshold {spec!r}: want NAME=VALUE "
                f"with NAME one of {sorted(fields)}"
            )
        typ = fields[name].type
        try:
            updates[name] = (
                int(raw) if typ in (int, "int") else float(raw)
            )
        except ValueError as e:
            raise ValueError(
                f"bad --canary-threshold {spec!r}: {e}"
            ) from None
    return dataclasses.replace(cfg, **updates)


def _p99(window) -> Optional[float]:
    from bdbnn_tpu_torch.serve.loadgen import _pct

    return _pct(sorted(window), 99.0)


class CanaryMonitor:
    """Live-verdict comparison of a canary cohort against the
    incumbent, driving the pool's canary state machine.

    Feeds (all thread-safe; writers are the HTTP handler, the replica
    workers and the shadow comparator thread):

    - :meth:`record_served` — one completed request's (priority,
      latency, answered-by version) from the front end; the version
      label rides the request future (obs/rtrace.py
      ``set_future_answered_by``), so a canary-assigned batch that
      FELL BACK to the incumbent counts as incumbent — cohort truth is
      who answered, never who was asked.
    - :meth:`record_batch` — one executed batch's measured
      (dispatch_ms, compute_ms) split from the replica worker.
    - :meth:`record_drift` — one shadow comparison's max-abs logit
      difference.

    :meth:`evaluate` (called by the pool's observation loop with its
    cohort counters) runs every detector through its
    :class:`~bdbnn_tpu_torch.obs.health.DetectorState` and returns the
    decision; :meth:`report` is the verdict's ``canary`` block.
    """

    def __init__(
        self,
        cfg: Optional[CanaryConfig] = None,
        *,
        priorities: int = 3,
        on_event: Optional[Callable[..., Any]] = None,
    ):
        self.cfg = cfg or CanaryConfig()
        self.priorities = max(int(priorities), 1)
        self.on_event = on_event
        self._lock = threading.Lock()
        # episode identity + every rolling window and accumulator the
        # concurrent feeds write:
        # guarded-by: _lock: active, version_from, version_to, fraction,
        # guarded-by: _lock: canary_replicas, _lat, _disp, _comp, served,
        # guarded-by: _lock: drift_n, drift_max, evaluations, _clean_streak,
        # guarded-by: _lock: decision, trigger, _last_detectors, _t_armed,
        # guarded-by: _lock: _t_decided, _states
        self.active = False
        self.version_from: Optional[str] = None
        self.version_to: Optional[str] = None
        self.fraction: Optional[float] = None
        self.canary_replicas: Optional[List[int]] = None
        self._reset()

    def _reset(self) -> None:  # requires-lock: _lock
        cfg = self.cfg
        self._lat: Dict[Any, Any] = {}
        self._disp: Dict[str, Any] = {
            c: deque(maxlen=cfg.window) for c in (INCUMBENT, CANARY)
        }
        self._comp: Dict[str, Any] = {
            c: deque(maxlen=cfg.window) for c in (INCUMBENT, CANARY)
        }
        self.served = {INCUMBENT: 0, CANARY: 0}
        self.drift_n = 0
        self.drift_max: Optional[float] = None
        self.evaluations = 0
        self._clean_streak = 0
        self.decision: Optional[str] = None
        self.trigger: Optional[str] = None
        self._last_detectors: Dict[str, Dict[str, Any]] = {}
        self._t_armed: Optional[float] = None
        self._t_decided: Optional[float] = None
        names = [f"p99_p{p}" for p in range(self.priorities)] + [
            "unabsorbed", "error_rate", "fairness", "queue_share",
            "logit_drift",
        ]
        self._states = {
            name: DetectorState(
                0,
                # the drift comparison is exact — one drifted sample
                # is a real defect, never debounced away
                1 if name == "logit_drift" else cfg.debounce,
            )
            for name in names
        }

    def _emit(self, kind: str, **fields) -> None:
        if self.on_event is not None:
            try:
                self.on_event(kind, **fields)
            except Exception:
                pass  # telemetry must never take the rollout down

    # -- lifecycle -----------------------------------------------------

    def arm(
        self,
        *,
        version_from: str,
        version_to: str,
        fraction: float,
        replicas: Sequence[int],
    ) -> None:
        """Start one canary episode: clears every window and detector,
        records the cohort identity the feeds key on."""
        with self._lock:
            self._reset()
            self.active = True
            self.version_from = str(version_from)
            self.version_to = str(version_to)
            self.fraction = float(fraction)
            self.canary_replicas = [int(r) for r in replicas]
            self._t_armed = time.monotonic()

    def disarm(self) -> None:
        with self._lock:
            self.active = False

    # -- feeds ---------------------------------------------------------

    def _cohort(self, version: Optional[str]) -> Optional[str]:  # requires-lock: _lock
        if version is None:
            return None
        return CANARY if str(version) == self.version_to else INCUMBENT

    def record_served(
        self, priority: int, lat_ms: float, version: Optional[str]
    ) -> None:
        """One completed request. ``version`` is who ANSWERED (the
        future's answered-by label); None (single-engine path, no
        label) is ignored rather than guessed."""
        cohort = None
        with self._lock:
            if self.active:
                cohort = self._cohort(version)
            if cohort is None:
                return
            key = (cohort, int(priority))
            win = self._lat.get(key)
            if win is None:
                win = self._lat[key] = deque(maxlen=self.cfg.window)
            win.append(float(lat_ms))
            self.served[cohort] += 1

    def record_batch(
        self,
        version: Optional[str],
        dispatch_ms: float,
        compute_ms: float,
    ) -> None:
        """One executed batch's measured dispatch/compute split from
        the replica worker — the queue-share detector's feed. One
        sample per BATCH on purpose: the dispatch wait is a batch-level
        quantity (every request in the batch waited it together), so
        weighting by batch size would double-count the same wall."""
        with self._lock:
            if not self.active:
                return
            cohort = self._cohort(version)
            if cohort is None:
                return
            self._disp[cohort].append(float(dispatch_ms))
            self._comp[cohort].append(float(compute_ms))

    def record_drift(self, drift: Optional[float]) -> None:
        """One shadow comparison's max-abs logit difference (None =
        the pair was incomparable and is NOT a measurement)."""
        if drift is None:
            return
        with self._lock:
            if not self.active:
                return
            self.drift_n += 1
            d = float(drift)
            if self.drift_max is None or d > self.drift_max:
                self.drift_max = d

    # -- judgment ------------------------------------------------------

    def _detector_rows(  # requires-lock: _lock
        self, pool_counters: Optional[Dict[str, Dict[str, Any]]]
    ) -> Dict[str, Dict[str, Any]]:
        """One evidence row per detector: value, threshold, breach,
        eligible, recovered (the hysteresis re-arm signal) + the raw
        window evidence. Caller holds the lock
        (``# requires-lock: _lock`` on the def line above)."""
        cfg = self.cfg
        rows: Dict[str, Dict[str, Any]] = {}
        ratios: Dict[int, float] = {}
        for p in range(self.priorities):
            c_win = self._lat.get((CANARY, p)) or ()
            i_win = self._lat.get((INCUMBENT, p)) or ()
            eligible = (
                len(c_win) >= cfg.min_samples
                and len(i_win) >= cfg.min_samples
            )
            c99 = _p99(c_win)
            i99 = _p99(i_win)
            ratio = None
            breach = recovered = False
            if eligible and c99 is not None and i99 is not None:
                ratio = round(c99 / max(i99, 1e-9), 4)
                ratios[p] = ratio
                breach = (
                    ratio > cfg.p99_ratio
                    and (c99 - i99) > cfg.p99_floor_ms
                )
                recovered = ratio < 0.5 * cfg.p99_ratio
            rows[f"p99_p{p}"] = {
                "value": ratio,
                "threshold": cfg.p99_ratio,
                "breach": breach,
                "recovered": recovered,
                "eligible": eligible,
                "canary_p99_ms": c99,
                "incumbent_p99_ms": i99,
                "canary_n": len(c_win),
                "incumbent_n": len(i_win),
            }

        can_counts = (pool_counters or {}).get(CANARY) or {}
        assigned = int(can_counts.get("assigned_batches") or 0)
        unabsorbed = int(can_counts.get("sheds") or 0) + int(
            can_counts.get("fallbacks") or 0
        )
        eligible = assigned >= max(cfg.min_samples // 4, 4)
        value = round(unabsorbed / assigned, 4) if assigned else None
        rows["unabsorbed"] = {
            "value": value,
            "threshold": cfg.unabsorbed_rate,
            "breach": bool(
                eligible and value is not None
                and value > cfg.unabsorbed_rate
            ),
            "recovered": bool(
                value is not None and value < 0.5 * cfg.unabsorbed_rate
            ),
            "eligible": eligible,
            "assigned_batches": assigned,
            "unabsorbed_batches": unabsorbed,
        }

        def _cohort_total(cohort: str) -> int:
            counts = (pool_counters or {}).get(cohort) or {}
            return self.served[cohort] + int(
                counts.get("failed_requests") or 0
            )

        def _fail_rate(cohort: str) -> Optional[float]:
            counts = (pool_counters or {}).get(cohort) or {}
            failed = int(counts.get("failed_requests") or 0)
            total = self.served[cohort] + failed
            return failed / total if total else None

        c_rate = _fail_rate(CANARY)
        i_rate = _fail_rate(INCUMBENT)
        # BOTH cohorts need min_samples: a failure rate over a handful
        # of incumbent requests is not a comparison, and eligibility is
        # what keeps "promote" meaning "positively compared clean"
        eligible = (
            _cohort_total(CANARY) >= cfg.min_samples
            and _cohort_total(INCUMBENT) >= cfg.min_samples
        )
        value = (
            round(c_rate - i_rate, 4)
            if c_rate is not None and i_rate is not None
            else None
        )
        rows["error_rate"] = {
            "value": value,
            "threshold": cfg.error_rate_abs,
            "breach": bool(
                eligible and value is not None
                and value > cfg.error_rate_abs
            ),
            "recovered": bool(
                value is not None and value < 0.5 * cfg.error_rate_abs
            ),
            "eligible": eligible,
            "canary_fail_rate": c_rate,
            "incumbent_fail_rate": i_rate,
        }

        eligible = len(ratios) >= 2
        value = None
        if eligible:
            value = round(
                max(ratios.values()) / max(min(ratios.values()), 1e-9),
                4,
            )
        rows["fairness"] = {
            "value": value,
            "threshold": cfg.fairness_ratio_max,
            "breach": bool(
                eligible and value is not None
                and value > cfg.fairness_ratio_max
            ),
            "recovered": bool(
                value is not None
                and value < 0.5 * cfg.fairness_ratio_max
            ),
            "eligible": eligible,
            "per_priority_ratio": {
                str(p): r for p, r in sorted(ratios.items())
            },
        }

        def _share(cohort: str) -> Optional[float]:
            disp, comp = self._disp[cohort], self._comp[cohort]
            if len(disp) < max(cfg.min_samples // 4, 4):
                return None
            d = sum(disp) / len(disp)
            c = sum(comp) / max(len(comp), 1)
            total = d + c
            return d / total if total > 0 else None

        c_share = _share(CANARY)
        i_share = _share(INCUMBENT)
        eligible = c_share is not None and i_share is not None
        value = round(c_share - i_share, 4) if eligible else None
        rows["queue_share"] = {
            "value": value,
            "threshold": cfg.queue_share_abs,
            "breach": bool(
                eligible and value is not None
                and value > cfg.queue_share_abs
            ),
            "recovered": bool(
                value is not None and value < 0.5 * cfg.queue_share_abs
            ),
            "eligible": eligible,
            "canary_share": c_share,
            "incumbent_share": i_share,
        }

        rows["logit_drift"] = {
            "value": self.drift_max,
            "threshold": cfg.logit_drift_abs,
            "breach": bool(
                self.drift_n
                and self.drift_max is not None
                and self.drift_max > cfg.logit_drift_abs
            ),
            "recovered": False,  # exact comparisons never "recover"
            "eligible": self.drift_n > 0,
            "compared": self.drift_n,
        }
        return rows

    def evaluate(
        self,
        pool_counters: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> Dict[str, Any]:
        """One observation-loop tick: run every detector through its
        state machine and return ``{"decision", "trigger",
        "detectors"}``. The decision latches — once promoted or rolled
        back the monitor keeps answering the same verdict."""
        with self._lock:
            if self.decision is not None:
                return {
                    "decision": self.decision,
                    "trigger": self.trigger,
                    "detectors": dict(self._last_detectors),
                }
            self.evaluations += 1
            rows = self._detector_rows(pool_counters)
            fired: List[str] = []
            any_breach = False
            any_eligible = False
            for name, row in rows.items():
                st = self._states[name]
                row["fired"] = False
                if not row["eligible"]:
                    continue
                any_eligible = True
                any_breach = any_breach or row["breach"]
                if st.update(row["breach"], row["recovered"]):
                    row["fired"] = True
                    fired.append(name)
            decision = OBSERVE
            trigger = None
            if fired:
                decision, trigger = ROLLBACK, fired[0]
            else:
                # the promote streak counts only evaluations where at
                # least one detector actually COMPARED the cohorts —
                # "nothing was eligible" is absence of evidence, and
                # insufficient data must never accumulate into a green
                # light. A raw (undebounced) breach resets the streak:
                # "clean" means clean, not "not yet persistent".
                if any_breach:
                    self._clean_streak = 0
                elif any_eligible:
                    self._clean_streak += 1
                if (
                    self._clean_streak >= self.cfg.healthy_evals
                    and self.served[CANARY] >= self.cfg.min_samples
                ):
                    decision = PROMOTE
            self._last_detectors = rows
            if decision != OBSERVE:
                self.decision, self.trigger = decision, trigger
                self._t_decided = time.monotonic()
            evaluation = self.evaluations
            clean = self._clean_streak
        self._emit(
            "canary",
            phase="evaluate",
            evaluation=evaluation,
            decision=decision,
            trigger=trigger,
            clean_streak=clean,
            canary_served=self.served[CANARY],
            incumbent_served=self.served[INCUMBENT],
            detectors={
                name: {
                    k: row.get(k)
                    for k in (
                        "value", "threshold", "breach", "fired",
                        "eligible",
                    )
                }
                for name, row in rows.items()
            },
        )
        return {
            "decision": decision,
            "trigger": trigger,
            "detectors": rows,
        }

    def conclude(self, reason: str = "timeout") -> Dict[str, Any]:
        """Resolve an undecided canary at the observation budget:
        promote only when the evidence is positively sufficient (the
        canary served enough and the latest evaluation was clean);
        anything less rolls back as ``inconclusive`` — insufficient
        data is not a green light."""
        with self._lock:
            if self.decision is None:
                healthy = (
                    self._clean_streak >= 1
                    and self.served[CANARY] >= self.cfg.min_samples
                )
                self.decision = PROMOTE if healthy else ROLLBACK
                self.trigger = None if healthy else INCONCLUSIVE
                self._t_decided = time.monotonic()
            decision, trigger = self.decision, self.trigger
        self._emit(
            "canary", phase="decision", decision=decision,
            trigger=trigger, reason=reason,
            evaluations=self.evaluations,
        )
        return {
            "decision": decision,
            "trigger": trigger,
            "detectors": dict(self._last_detectors),
        }

    # -- reporting -----------------------------------------------------

    def live(self) -> Optional[Dict[str, Any]]:
        """The compact live snapshot ``/statsz`` serves while an
        episode is armed (None otherwise): state, fraction, served
        counts, drift so far, and each detector's latest status."""
        with self._lock:
            if not self.active:
                return None
            return {
                "state": self.decision or OBSERVE,
                "trigger": self.trigger,
                "fraction": self.fraction,
                "version_from": self.version_from,
                "version_to": self.version_to,
                "evaluations": self.evaluations,
                "served": dict(self.served),
                "drift_compared": self.drift_n,
                "max_abs_drift": self.drift_max,
                "detectors": {
                    name: {
                        k: row.get(k)
                        for k in ("value", "breach", "fired", "eligible")
                    }
                    for name, row in self._last_detectors.items()
                },
            }

    def shadow_block(
        self, pool_shadow: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """The ``shadow`` sub-block: mirror/compare accounting from the
        pool merged with the drift the monitor actually judged."""
        with self._lock:
            block = {
                "mirrored": (pool_shadow or {}).get("mirrored", 0),
                "compared": self.drift_n,
                "skipped": (pool_shadow or {}).get("skipped", 0),
                "failed": (pool_shadow or {}).get("failed", 0),
                "max_abs_drift": self.drift_max,
            }
        return block

    def report(
        self, pool_shadow: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """The verdict's nullable ``canary`` block (SLO verdict v5):
        the whole episode's evidence in one strict-JSON dict."""
        with self._lock:
            observe_s = None
            if self._t_armed is not None:
                end = self._t_decided or time.monotonic()
                observe_s = round(end - self._t_armed, 3)
            # the verdict carries the FULL evidence rows (window
            # percentiles, sample counts, cohort rates) — the episode
            # must be auditable from the verdict alone; the compact
            # value/threshold/fired view is the evaluate events' job
            detectors = {
                name: {k: v for k, v in row.items() if k != "recovered"}
                for name, row in self._last_detectors.items()
            }
            rec = {
                "fraction": self.fraction,
                "replicas_canary": self.canary_replicas,
                "version_from": self.version_from,
                "version_to": self.version_to,
                "decision": self.decision,
                "trigger": self.trigger,
                "rollbacks": 1 if self.decision == ROLLBACK else 0,
                "evaluations": self.evaluations,
                "observe_s": observe_s,
                "served": dict(self.served),
                "detectors": detectors,
            }
        rec["shadow"] = self.shadow_block(pool_shadow)
        return rec


def assign_canary(seed: int, seq: int, fraction: float) -> bool:
    """Deterministic seeded cohort assignment for batch ``seq``: the
    same (seed, seq) always lands in the same cohort — splitmix64 over
    the batch sequence number, the rtrace sampling construction — so a
    canary episode's traffic split is reproducible and contention-free
    (no RNG state in the dispatch path)."""
    from bdbnn_tpu_torch.obs.rtrace import _splitmix64

    if fraction <= 0.0:
        return False
    return (_splitmix64(int(seed) ^ int(seq)) % 1_000_000) < int(
        float(fraction) * 1_000_000
    )


__all__ = [
    "CANARY",
    "INCONCLUSIVE",
    "INCUMBENT",
    "OBSERVE",
    "PROMOTE",
    "ROLLBACK",
    "CanaryConfig",
    "CanaryMonitor",
    "apply_canary_overrides",
    "assign_canary",
]

"""Online training-health monitor — the port's copy of
``bdbnn_tpu/obs/health.py`` (stdlib only): per-drain pathology detectors
over signals the run already collects.

- **flip_collapse** (critical) — the mean per-step sign-flip rate falls
  to ~0 long before the schedule ends: the binarized weights froze.
- **flip_explosion** (critical) — a large fraction of binarized weights
  changes sign every step: oscillation under a too-hot LR.
- **kurt_divergence** (warning) — latent-weight kurtosis runs away from
  the configured target (armed only with the kurtosis loss).
- **loss_spike** (critical) — interval loss over a factor of its own
  trailing median.
- **loss_plateau** (warning) — loss flat at a high value in the first
  half of training.
- **throughput_regression** (warning) — img/s well below the run's own
  trailing median.
- **hbm_creep** (warning) — the device memory high-water mark grows past
  the post-first-step baseline (obs/memory.py's ``memory`` events).

Every detector runs :class:`DetectorState`: warmup (the first N
observations are never judged), debounce (a breach must persist K
consecutive observations), then a latch (hysteresis) until the signal
recovers. The same class drives the serving stacks' detectors (the
capacity plane's burn rates, obs/capacity.py; the canary monitor,
serve/canary.py), so "a breach must persist, then latch" means one
thing everywhere.

Alerts are ``alert`` events and can trigger auto-forensics (wired by
``train/loop.py``): a checkpoint under ``<run_dir>/forensics/`` and a
bounded ``TraceCapture`` window (obs/trace.py). A ``health`` summary
event lands at run end; the reference's ``summarize --strict`` turns
critical alerts into a nonzero exit. The monitor reads only host floats
the drain already fetched: it adds no device synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

# detector name -> severity. "critical" alerts are RUN-ENDING for
# gating purposes: `summarize --strict` exits nonzero on them.
SEVERITIES: Dict[str, str] = {
    "flip_collapse": "critical",
    "flip_explosion": "critical",
    "kurt_divergence": "warning",
    "loss_spike": "critical",
    "loss_plateau": "warning",
    "throughput_regression": "warning",
    "hbm_creep": "warning",
}
DETECTORS = tuple(SEVERITIES)
RUN_ENDING_SEVERITY = "critical"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds + shared warmup/debounce. Every field can be
    overridden from the CLI via ``--health-threshold NAME=VALUE``."""

    # shared state-machine knobs (flip/kurt detectors; the windowed
    # detectors gate on their own history length instead of warmup).
    # Warmup 10 drains: the first moments of a binary net are
    # legitimately weird (zero flips right after init on small layers,
    # kurtosis still near gaussian), and smoke-scale runs should end
    # before eligibility rather than alert on being small.
    warmup_intervals: int = 10
    debounce: int = 2
    # flip_collapse: mean per-step flip fraction below this while less
    # than flip_collapse_progress of the epoch budget has run
    flip_collapse_rate: float = 1e-5
    flip_collapse_progress: float = 0.9
    # flip_explosion: mean per-step flip fraction above this
    flip_explosion_rate: float = 0.25
    # kurt_divergence: |mean kurtosis - target| above this (armed only
    # when the kurtosis loss is configured)
    kurt_divergence_abs: float = 6.0
    # loss_spike: interval loss > factor x trailing median of the last
    # loss_window interval losses (needs >= 4 history)
    loss_spike_factor: float = 3.0
    loss_window: int = 8
    # loss_plateau: relative range of the last plateau_window interval
    # losses below this, before plateau_progress of training, at a mean
    # loss above plateau_min_loss (a plateau at ~0 is convergence)
    plateau_rel_range: float = 1e-3
    plateau_window: int = 6
    plateau_progress: float = 0.5
    plateau_min_loss: float = 0.05
    # throughput_regression: img/s below (1 - drop) x the trailing
    # median of the last throughput_window intervals
    throughput_drop: float = 0.3
    throughput_window: int = 8
    # hbm_creep: peak_bytes above (1 + frac) x the first watermark
    hbm_creep_frac: float = 0.08


def apply_overrides(
    cfg: HealthConfig, specs: Sequence[str]
) -> HealthConfig:
    """``("loss_spike_factor=5", ...)`` -> a new HealthConfig. Unknown
    names and unparseable values raise ValueError at config time, not
    at the first drain hours into a run."""
    if not specs:
        return cfg
    fields = {f.name: f for f in dataclasses.fields(HealthConfig)}
    updates: Dict[str, Any] = {}
    for spec in specs:
        name, sep, raw = spec.partition("=")
        name = name.strip()
        if not sep or name not in fields:
            raise ValueError(
                f"bad --health-threshold {spec!r}: want NAME=VALUE with "
                f"NAME one of {sorted(fields)}"
            )
        typ = fields[name].type
        try:
            updates[name] = (
                int(raw) if typ in (int, "int") else float(raw)
            )
        except ValueError as e:
            raise ValueError(
                f"bad --health-threshold {spec!r}: {e}"
            ) from None
    return dataclasses.replace(cfg, **updates)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _finite_mean(d: Optional[Dict[str, Any]]) -> Optional[float]:
    """Mean over a per-layer dict's finite values; None when empty."""
    vals = [
        float(v)
        for v in (d or {}).values()
        if isinstance(v, (int, float)) and math.isfinite(float(v))
    ]
    return sum(vals) / len(vals) if vals else None


class DetectorState:
    """The warmup + debounce + hysteresis state machine one detector
    runs per drain. ``update`` returns True exactly when an alert
    should fire.

    The training :class:`HealthMonitor` runs it per drain, and the
    serving stacks (the capacity plane's burn-rate detectors,
    obs/capacity.py; the canary monitor, serve/canary.py) over live
    request windows."""

    __slots__ = ("warmup", "debounce", "seen", "streak", "latched", "fired")

    def __init__(self, warmup: int, debounce: int) -> None:
        self.warmup = max(warmup, 0)
        self.debounce = max(debounce, 1)
        self.seen = 0
        self.streak = 0
        self.latched = False  # hysteresis: fired, waiting for recovery
        self.fired = 0

    def update(self, breach: bool, recovered: bool = False) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        if self.latched:
            if recovered:
                self.latched = False
                self.streak = 0
            return False
        if not breach:
            self.streak = 0
            return False
        self.streak += 1
        if self.streak < self.debounce:
            return False
        self.fired += 1
        self.latched = True
        self.streak = 0
        return True


class HealthMonitor:
    """Evaluates every detector at the drain points the loop already
    has. ``observe_interval`` consumes the same host floats the
    ``train_interval`` event carries; ``observe_memory`` consumes the
    emitted ``memory`` records. Both emit ``alert`` events and return
    the alerts fired, so the caller can trigger auto-forensics with the
    live train state in hand."""

    def __init__(
        self,
        cfg: HealthConfig,
        events,
        *,
        epochs: int,
        kurt_target: Optional[float] = None,
    ) -> None:
        self.cfg = cfg
        self.events = events
        self.epochs = max(epochs, 1)
        self.kurt_target = kurt_target  # None = kurtosis loss off
        self.intervals = 0
        self.alerts: List[Dict[str, Any]] = []
        w, d = cfg.warmup_intervals, cfg.debounce
        self._states = {
            "flip_collapse": DetectorState(w, d),
            "flip_explosion": DetectorState(w, d),
            "kurt_divergence": DetectorState(w, d),
            # a spike is instantaneous — debounce 1; history gates warmup
            "loss_spike": DetectorState(0, 1),
            "loss_plateau": DetectorState(0, 1),
            "throughput_regression": DetectorState(0, d),
            "hbm_creep": DetectorState(0, 1),
        }
        self._loss_hist: List[float] = []
        self._rate_hist: List[float] = []
        self._hbm_baseline: Optional[int] = None

    # ------------------------------------------------------------------
    def _fire(
        self, detector: str, *, epoch: int, step: int, value: float,
        threshold: float, message: str,
    ) -> Dict[str, Any]:
        rec = self.events.emit(
            "alert",
            detector=detector,
            severity=SEVERITIES[detector],
            epoch=epoch,
            step=step,
            value=value,
            threshold=threshold,
            message=message,
        )
        self.alerts.append(rec)
        return rec

    def observe_interval(
        self,
        *,
        epoch: int,
        step: int,
        loss: Optional[float],
        img_per_s: Optional[float],
        flip_rate: Optional[Dict[str, float]] = None,
        kurtosis: Optional[Dict[str, float]] = None,
    ) -> List[Dict[str, Any]]:
        """One drained print interval. Returns the alerts fired."""
        cfg = self.cfg
        self.intervals += 1
        fired: List[Dict[str, Any]] = []
        progress = epoch / self.epochs

        mean_flip = _finite_mean(flip_rate)
        if mean_flip is not None:
            st = self._states["flip_collapse"]
            breach = (
                mean_flip < cfg.flip_collapse_rate
                and progress < cfg.flip_collapse_progress
            )
            if st.update(breach, mean_flip > 2 * cfg.flip_collapse_rate):
                fired.append(self._fire(
                    "flip_collapse", epoch=epoch, step=step,
                    value=mean_flip, threshold=cfg.flip_collapse_rate,
                    message=(
                        f"mean sign-flip rate {mean_flip:.3g}/step < "
                        f"{cfg.flip_collapse_rate:.3g} at {progress:.0%} "
                        "of the epoch budget — binarized weights look "
                        "frozen"
                    ),
                ))
            st = self._states["flip_explosion"]
            if st.update(
                mean_flip > cfg.flip_explosion_rate,
                mean_flip < 0.5 * cfg.flip_explosion_rate,
            ):
                fired.append(self._fire(
                    "flip_explosion", epoch=epoch, step=step,
                    value=mean_flip, threshold=cfg.flip_explosion_rate,
                    message=(
                        f"mean sign-flip rate {mean_flip:.3g}/step > "
                        f"{cfg.flip_explosion_rate:.3g} — binarized "
                        "weights oscillating (LR too hot?)"
                    ),
                ))

        mean_kurt = _finite_mean(kurtosis)
        if self.kurt_target is not None and mean_kurt is not None:
            dist = abs(mean_kurt - self.kurt_target)
            st = self._states["kurt_divergence"]
            if st.update(
                dist > cfg.kurt_divergence_abs,
                dist < 0.8 * cfg.kurt_divergence_abs,
            ):
                fired.append(self._fire(
                    "kurt_divergence", epoch=epoch, step=step,
                    value=mean_kurt, threshold=cfg.kurt_divergence_abs,
                    message=(
                        f"mean latent kurtosis {mean_kurt:.3g} is "
                        f"{dist:.3g} from the target "
                        f"{self.kurt_target:g} (tolerance "
                        f"{cfg.kurt_divergence_abs:g}) — the bimodal "
                        "shape L_K enforces is not holding"
                    ),
                ))

        if loss is not None and math.isfinite(loss):
            hist = self._loss_hist
            if len(hist) >= 4:  # trailing median EXCLUDES this interval
                med = _median(hist[-cfg.loss_window:])
                st = self._states["loss_spike"]
                if med > 0 and st.update(
                    loss > cfg.loss_spike_factor * med,
                    loss < 1.5 * med,
                ):
                    fired.append(self._fire(
                        "loss_spike", epoch=epoch, step=step,
                        value=loss, threshold=cfg.loss_spike_factor * med,
                        message=(
                            f"interval loss {loss:.4g} > "
                            f"{cfg.loss_spike_factor:g}x the trailing "
                            f"median {med:.4g}"
                        ),
                    ))
            hist.append(loss)
            if len(hist) >= cfg.plateau_window:
                win = hist[-cfg.plateau_window:]
                mean = sum(win) / len(win)
                rel = (max(win) - min(win)) / max(abs(mean), 1e-9)
                st = self._states["loss_plateau"]
                if st.update(
                    rel < cfg.plateau_rel_range
                    and progress < cfg.plateau_progress
                    and mean > cfg.plateau_min_loss,
                    rel > 2 * cfg.plateau_rel_range,
                ):
                    fired.append(self._fire(
                        "loss_plateau", epoch=epoch, step=step,
                        value=mean, threshold=cfg.plateau_rel_range,
                        message=(
                            f"loss flat (relative range {rel:.2e} over "
                            f"{cfg.plateau_window} intervals) at "
                            f"{mean:.4g}, before "
                            f"{cfg.plateau_progress:.0%} of training"
                        ),
                    ))

        if img_per_s is not None and img_per_s > 0:
            rates = self._rate_hist
            if len(rates) >= cfg.throughput_window:
                med = _median(rates[-cfg.throughput_window:])
                st = self._states["throughput_regression"]
                floor = (1.0 - cfg.throughput_drop) * med
                if st.update(
                    img_per_s < floor,
                    img_per_s > (1.0 - 0.5 * cfg.throughput_drop) * med,
                ):
                    fired.append(self._fire(
                        "throughput_regression", epoch=epoch, step=step,
                        value=img_per_s, threshold=floor,
                        message=(
                            f"{img_per_s:.1f} img/s < "
                            f"{1 - cfg.throughput_drop:.0%} of this "
                            f"run's trailing median {med:.1f} img/s"
                        ),
                    ))
            rates.append(img_per_s)

        return fired

    def observe_memory(self, record: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One emitted ``memory`` event record. The first watermark
        (post-compile) is the baseline; growth past it alerts once."""
        peak = record.get("peak_bytes")
        if not peak:
            return []
        if self._hbm_baseline is None:
            self._hbm_baseline = int(peak)
            return []
        cfg = self.cfg
        ceiling = (1.0 + cfg.hbm_creep_frac) * self._hbm_baseline
        st = self._states["hbm_creep"]
        if st.update(peak > ceiling):  # latched for the rest of the run
            return [self._fire(
                "hbm_creep",
                epoch=int(record.get("epoch") or 0),
                step=0,
                value=float(peak),
                threshold=ceiling,
                message=(
                    f"HBM peak {peak / 2**30:.2f} GiB > "
                    f"{1 + cfg.hbm_creep_frac:.2f}x the post-compile "
                    f"baseline {self._hbm_baseline / 2**30:.2f} GiB"
                ),
            )]
        return []

    # ------------------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        return {
            name: st.fired
            for name, st in self._states.items()
            if st.fired
        }

    def emit_summary(self) -> Dict[str, Any]:
        """The run-end ``health`` event: totals by detector + severity,
        so `summarize`/CI can gate without re-scanning every alert."""
        critical = sum(
            1 for a in self.alerts
            if a.get("severity") == RUN_ENDING_SEVERITY
        )
        return self.events.emit(
            "health",
            intervals=self.intervals,
            alerts_total=len(self.alerts),
            alerts_critical=critical,
            by_detector=self.counts(),
        )


__all__ = [
    "DETECTORS",
    "RUN_ENDING_SEVERITY",
    "SEVERITIES",
    "DetectorState",
    "HealthConfig",
    "HealthMonitor",
    "apply_overrides",
]

"""Post-hoc run reports: ``python -m bdbnn_tpu_torch.cli summarize <run_dir>`` —
the port's copy of ``bdbnn_tpu/obs/summarize.py`` (the same summary and
report), whose attribution section reads ``torch.profiler`` traces with the
port's parser (obs/trace.py) and its MFU against the card's bf16 peak.

Consumes the three files a run directory accumulates —
``manifest.json`` (provenance), ``scalars.jsonl`` (per-epoch curves),
``events.jsonl`` (structured timeline) — and renders what a human
debugging a finished BNN run actually asks:

- was the run input-starved or compute-bound? (host step-phase shares)
- did the gradient signal survive the EDE anneal, or starve?
  (grad-norm trajectory — schedule-budget vs starvation)
- did the latent weights actually go bimodal? (per-layer kurtosis)
- did binarized weights churn? (per-layer sign-flip rates)
- how long to each accuracy level, and what did each loss term do?
- where did device time actually go, and how close to the HBM ceiling?
  (the "attribution" section — rendered whenever the run captured a
  ``--profile-at`` trace window and/or ``memory`` events: per-semantic-
  category device ms/step from the span-annotated trace, an MFU
  estimate, and the run-wide HBM peak against the device limit)
- is the run preemption-safe, and what is its restart history? (the
  "resilience" section: checkpoint cadence + age of the last
  checkpoint, restart lineage from the manifest, restore provenance
  incl. ``checkpoint.old`` fallbacks, preemptions, substituted
  corrupt samples)
- did the online health monitor fire? (the "health" section: alert
  counts by detector, the run-ending/critical alerts ``--strict``
  turns into a nonzero exit for CI, the run-end ``health`` roll-up)

Stdlib-only: summarizing a run loads neither torch nor numpy and touches
no device.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Tuple

from bdbnn_tpu_torch.obs.events import jsonsafe, read_events, read_jsonl
from bdbnn_tpu_torch.obs.manifest import read_manifest
from bdbnn_tpu_torch.obs.memory import hbm_watermark
from bdbnn_tpu_torch.obs.trace import (
    BF16_PEAK_TFLOPS,
    attribute_trace,
    find_trace_file,
)

# data-wait share of interval wall time above which a run is called
# input-bound: at 35% the host spends over a third of each interval
# blocked on the pipeline — batch-size/worker tuning, not compute, is
# the lever
INPUT_BOUND_SHARE = 0.35
# grad-norm collapse factor for the starvation flag: final epoch below
# 5% of the run's peak means the estimator passes almost no gradient
GRAD_COLLAPSE_RATIO = 0.05


def resolve_run_dir(path: str) -> str:
    """Accept either a run dir itself or a log root above it; pick the
    LATEST dir holding run files (timestamp-named dirs sort
    lexicographically, matching run_kd.py's convention)."""
    for name in ("events.jsonl", "scalars.jsonl", "manifest.json"):
        if os.path.exists(os.path.join(path, name)):
            return path
    hits: List[str] = []
    for name in ("events.jsonl", "scalars.jsonl", "manifest.json"):
        hits += glob.glob(os.path.join(path, "**", name), recursive=True)
    if not hits:
        raise FileNotFoundError(
            f"no run files (manifest.json / scalars.jsonl / events.jsonl) "
            f"under {path!r}"
        )
    return os.path.dirname(sorted(hits)[-1])


def read_scalars(run_dir: str) -> List[Dict[str, Any]]:
    return read_jsonl(os.path.join(run_dir, "scalars.jsonl"))


def _curve(scalars, tag) -> List[Tuple[int, float]]:
    pts = [(s["step"], s["value"]) for s in scalars if s.get("tag") == tag]
    return sorted(pts)


def _phase_totals(intervals) -> Dict[str, float]:
    tot = {"data_wait_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
           "interval_s": 0.0}
    for ev in intervals:
        for k in tot:
            tot[k] += float(ev.get(k, 0.0))
    tot = {k: round(v, 3) for k, v in tot.items()}
    wall = max(tot["interval_s"], 1e-9)
    tot["data_wait_share"] = round(tot["data_wait_s"] / wall, 4)
    tot["drain_share"] = round(tot["drain_s"] / wall, 4)
    return tot


def _starvation(phases, grad_curve) -> Dict[str, Any]:
    """The two starvations a BNN run stalls on, separated.

    Input starvation is a host-time fact (data-wait share); gradient
    starvation is a grad-norm-trajectory fact (the annealed EDE
    backward → 0 a.e.). Each gets its own flag plus one combined
    human-readable verdict line.
    """
    share = phases.get("data_wait_share", 0.0) if phases else 0.0
    input_bound = bool(phases) and share > INPUT_BOUND_SHARE
    grad_first = grad_curve[0][1] if grad_curve else None
    grad_last = grad_curve[-1][1] if grad_curve else None
    grad_peak = max(v for _, v in grad_curve) if grad_curve else None
    grad_starved = bool(
        grad_curve
        and len(grad_curve) >= 2
        and grad_peak > 0
        and grad_last < GRAD_COLLAPSE_RATIO * grad_peak
    )
    if input_bound:
        verdict = (
            f"INPUT-BOUND: {share:.0%} of hot-loop wall time waiting on "
            "the input pipeline — tune workers/backend before blaming "
            "compute"
        )
    elif grad_starved:
        verdict = (
            f"GRADIENT STARVATION suspected: epoch-mean grad norm fell "
            f"to {grad_last:.3g} from a peak of {grad_peak:.3g} "
            f"(<{GRAD_COLLAPSE_RATIO:.0%}) — the estimator anneal, not "
            "the schedule budget, is the limiter"
        )
    elif not phases and not grad_curve:
        verdict = "no verdict: run recorded neither phase timing nor grad norms"
    else:
        verdict = (
            f"not starved: data-wait share {share:.0%}"
            + (
                f", grad norm {grad_first:.3g} -> {grad_last:.3g}"
                if grad_curve
                else ", grad norm not recorded"
            )
        )
    return {
        "input_bound": input_bound,
        "data_wait_share": share,
        "grad_norm_first": grad_first,
        "grad_norm_last": grad_last,
        "grad_norm_peak": grad_peak,
        "gradient_starvation_suspected": grad_starved,
        "verdict": verdict,
    }


def _probe_trajectories(scalars, events) -> Dict[str, Dict[str, Any]]:
    """Per-layer first->last flip-rate / kurtosis. Prefers the per-epoch
    scalars (written by the train loop); falls back to the per-interval
    events of runs that died before epoch end."""
    out: Dict[str, Dict[str, Any]] = {}
    for s in scalars:
        tag = s.get("tag", "")
        for prefix, key in (("Probe flip ", "flip_rate"),
                            ("Probe kurt ", "kurtosis")):
            if tag.startswith(prefix):
                layer = tag[len(prefix):]
                d = out.setdefault(layer, {})
                d.setdefault(f"{key}_curve", []).append(
                    (s["step"], s["value"])
                )
    if not out:
        intervals = [e for e in events if e.get("kind") == "train_interval"]
        for ev in intervals:
            for field, key in (("flip_rate", "flip_rate"),
                               ("kurtosis", "kurtosis")):
                for layer, v in (ev.get(field) or {}).items():
                    # a NaN probe value lands as null in the event
                    # (jsonsafe); skip it rather than crash the report
                    # of exactly the broken run being post-mortemed
                    if v is None:
                        continue
                    d = out.setdefault(layer, {})
                    # step resets every epoch — key on (epoch, step) so
                    # first/last stay chronological across epochs
                    d.setdefault(f"{key}_curve", []).append(
                        ((ev.get("epoch", 0), ev.get("step", 0)), v)
                    )
    for layer, d in out.items():
        for key in ("flip_rate", "kurtosis"):
            curve = sorted(d.pop(f"{key}_curve", []))
            if curve:
                d[f"{key}_first"] = round(curve[0][1], 6)
                d[f"{key}_last"] = round(curve[-1][1], 6)
    return out


def _attribution(run_dir, manifest, events) -> Optional[Dict[str, Any]]:
    """The device-time + HBM section, present whenever the run captured
    a trace window (``profile`` event) or memory watermarks (``memory``
    events).

    Per-category ms/step comes from parsing the newest trace file under
    the run dir with the semantic-span parser; MFU pairs the trace's
    step total with the profile event's FLOPs (when recorded) or the
    trace's own per-op flops metadata, against the manifest device
    kind's published bf16 peak."""
    profile_evs = [e for e in events if e.get("kind") == "profile"]
    memory_evs = [e for e in events if e.get("kind") == "memory"]
    if not profile_evs and not memory_evs:
        return None
    out: Dict[str, Any] = {}
    if profile_evs:
        pe = profile_evs[-1]
        out["captured"] = {
            k: pe.get(k) for k in ("epoch", "start_step", "steps")
        }
        peak = None
        if manifest:
            peak = BF16_PEAK_TFLOPS.get(manifest.get("device_kind", ""))
        trace_path = None
        # the trace lives under the run dir (--profile-at default) or
        # wherever the profile event says the window was written
        for root in (run_dir, pe.get("trace_dir") or ""):
            if root and os.path.isdir(root):
                trace_path = find_trace_file(root)
                if trace_path:
                    break
        if trace_path:
            att = attribute_trace(
                trace_path,
                pe.get("steps") or 1,
                flops_per_step=pe.get("flops_per_step"),
                peak_tflops=peak,
            )
            out.update(att)
            out["trace_file"] = trace_path
        else:
            out["trace_file"] = None
    if memory_evs:
        out["hbm"] = hbm_watermark(memory_evs)
    return out


def _health(events) -> Optional[Dict[str, Any]]:
    """The health-monitor section: alert counts by detector/severity,
    the run-ending (critical) alerts `summarize --strict` gates on,
    and the run-end ``health`` roll-up when one landed. None when the
    run recorded no health telemetry at all."""
    alerts = [e for e in events if e.get("kind") == "alert"]
    roll = next(
        (e for e in reversed(events) if e.get("kind") == "health"), None
    )
    if not alerts and roll is None:
        return None
    by_detector: Dict[str, int] = {}
    for a in alerts:
        det = str(a.get("detector", "?"))
        by_detector[det] = by_detector.get(det, 0) + 1
    critical = [
        {
            k: a.get(k)
            for k in ("detector", "epoch", "step", "value", "threshold",
                      "message")
        }
        for a in alerts
        if a.get("severity") == "critical"
    ]
    return {
        "alerts_total": len(alerts),
        "alerts_critical": len(critical),
        "by_detector": dict(sorted(by_detector.items())),
        "critical": critical,
        "summary_event": (
            {
                k: roll.get(k)
                for k in ("intervals", "alerts_total", "alerts_critical",
                          "by_detector")
            }
            if roll
            else None
        ),
    }


def _serving(events) -> Optional[Dict[str, Any]]:
    """The serving section: ``export`` hand-offs recorded on a training
    run's timeline, and/or a ``serve-bench`` run's own start/stats/
    verdict trail. None when the run has no serving telemetry."""
    from bdbnn_tpu_torch.obs.events import serve_digest

    digest = serve_digest(events)
    exports = digest["exports"]
    start = digest["start"]
    stats = digest["stats"]
    verdict = digest["verdict"]
    http_start = digest["http_start"]
    fleet_start = digest["fleet_start"]
    if (
        not exports and start is None and not stats and verdict is None
        and http_start is None and fleet_start is None
    ):
        return None
    return {
        "exports": [
            {
                k: e.get(k)
                for k in ("artifact", "arch", "checkpoint", "integrity",
                          "binarized_convs", "compression_ratio",
                          "checkpoint_acc1")
            }
            for e in exports
        ],
        "bench": (
            {
                k: start.get(k)
                for k in ("artifact", "arch", "mode", "rate_rps",
                          "requests", "buckets", "queue_depth",
                          "max_delay_ms", "warmup_compile_s")
            }
            if start
            else None
        ),
        "http": (
            {
                k: http_start.get(k)
                for k in ("host", "port", "arch", "priorities",
                          "queue_depth", "buckets", "scenario",
                          "rate_rps", "requests")
            }
            if http_start
            else None
        ),
        "admission": (
            {
                "tenants": (
                    digest["admission_summary"].get("tenants") or {}
                ),
            }
            if digest["admission_summary"]
            else None
        ),
        "stats_events": len(stats) + len(digest["http_stats"]),
        "verdict": (
            {
                k: verdict.get(k)
                for k in ("p50_ms", "p95_ms", "p99_ms", "throughput_rps",
                          "mean_batch_occupancy", "shed_rate",
                          "requests_submitted", "requests_completed",
                          "requests_shed", "max_queue_depth_seen",
                          "max_queue", "preempted", "drained_clean",
                          "wall_s", "scenario", "per_priority",
                          "per_tenant", "fairness_ratio", "slo",
                          "replicas", "scaling", "swap", "attribution",
                          "canary", "fleet", "fleet_attribution",
                          "capacity")
            }
            if verdict
            else None
        ),
        "fleet": (
            {
                "hosts": fleet_start.get("hosts"),
                "router": (
                    f"{fleet_start.get('host')}:"
                    f"{fleet_start.get('port')}"
                ),
                "probe_transitions": len(digest["fleet_probes"]),
            }
            if fleet_start
            else None
        ),
        "replica_restarts": len(digest["replica_restarts"]),
        "canary_events": len(digest["canary_events"]),
        "shadow_mirrors": len(digest["shadow_mirrors"]),
        "capacity_breaches": len(digest["capacity_breaches"]),
        "capacity_recoveries": len(digest["capacity_recoveries"]),
    }


def _search(events) -> Optional[Dict[str, Any]]:
    """The recipe-search section (a sweep dir's events): the sweep's
    leaderboard verdict when one landed, otherwise the live trial
    states, plus the resumed-trial lineage (which trials survived a
    preemption and how many attempts they took). None when the
    timeline carries no search telemetry."""
    from bdbnn_tpu_torch.obs.events import search_digest

    digest = search_digest(events)
    if digest["start"] is None and digest["verdict"] is None:
        return None
    verdict = digest["verdict"]
    start = digest["start"] or {}
    out: Dict[str, Any] = {
        "trials_total": (verdict or start).get("trials_total"),
        "families": start.get("families"),
        "workers": start.get("workers"),
        "preempted": digest["preempted"] is not None,
    }
    if verdict is not None:
        trials = verdict.get("trials") or {}
        out.update({
            "completed": verdict.get("completed"),
            "failed": verdict.get("failed"),
            "common_acc_level": verdict.get("common_acc_level"),
            "ranking": verdict.get("ranking"),
            "winner": verdict.get("winner"),
            "trials": trials,
            # resumed-trial lineage: the trials that crossed a
            # preemption (attempts > 1) — the evidence `--resume`
            # continued rather than restarted the sweep
            "resumed_trials": {
                tid: {
                    "attempts": t.get("attempts"),
                    "status": t.get("status"),
                }
                for tid, t in sorted(trials.items())
                if t.get("resumed")
            },
        })
    else:
        states: Dict[str, str] = {}
        for tid, ev in sorted(digest["trial_latest"].items()):
            states[tid] = ev.get("phase")
        out["trial_states"] = states
        best = digest["best_done"]
        out["best_so_far"] = (
            {
                "trial": best.get("trial"),
                "family": best.get("family"),
                "lr": best.get("lr"),
                "best_top1": best.get("best_top1"),
            }
            if best
            else None
        )
    return out


def _perf(events) -> Optional[Dict[str, Any]]:
    """The performance-observatory section (obs/roofline.py): the
    sweep header from the ``perf`` start event, the measured
    (impl, bucket) cells that landed, and the roofline verdict's
    summary/ceilings/skips when one landed. None when the timeline
    carries no perf telemetry."""
    perf = [e for e in events if e.get("kind") == "perf"]
    if not perf:
        return None
    start = next((e for e in perf if e.get("phase") == "start"), None)
    verdict_ev = next(
        (e for e in reversed(perf) if e.get("phase") == "verdict"), None
    )
    cells = [
        {
            k: e.get(k)
            for k in ("impl", "bucket", "wall_ms", "attributed_ms",
                      "reconciled")
        }
        for e in perf
        if e.get("phase") == "bucket"
    ]
    out: Dict[str, Any] = {
        "start": (
            {
                k: start.get(k)
                for k in ("artifact", "arch", "dataset", "device_kind",
                          "buckets", "impls", "iters")
            }
            if start
            else None
        ),
        "cells": cells,
        "verdict": None,
    }
    if verdict_ev is not None:
        v = verdict_ev.get("verdict") or {}
        out["verdict"] = {
            "summary": v.get("summary"),
            "ceilings": v.get("ceilings"),
            "skipped": v.get("skipped"),
            "perf_layer_keys": len(v.get("perf_layers") or {}),
            "run_dir": verdict_ev.get("run_dir"),
        }
    return out


def _resilience(manifest, events) -> Dict[str, Any]:
    """Checkpoint/restart posture: how much work a preemption would
    cost right now, and how this run relates to its ancestors."""
    ckpts = [e for e in events if e.get("kind") == "checkpoint"]
    restores = [e for e in events if e.get("kind") == "restore"]
    preempts = [e for e in events if e.get("kind") == "preempt"]
    data_errors = [e for e in events if e.get("kind") == "data_error"]
    lineage = list((manifest or {}).get("restart_lineage") or [])
    last_age = None
    if ckpts and events:
        # age of the newest checkpoint at the run's last sign of life —
        # the work a preemption at that moment would have thrown away
        last_age = round(float(events[-1]["t"]) - float(ckpts[-1]["t"]), 1)
    return {
        "checkpoints": len(ckpts),
        "mid_epoch_checkpoints": sum(
            1 for e in ckpts if e.get("step_in_epoch")
        ),
        "last_checkpoint_age_s": last_age,
        "restart_count": len(lineage),
        "resumed_from": (manifest or {}).get("resumed_from"),
        "restart_lineage": lineage,
        "restores": [
            {
                k: r.get(k)
                for k in ("source", "fallback", "integrity", "epoch",
                          "step_in_epoch", "topology_from", "topology_to",
                          "resharded")
            }
            for r in restores
        ],
        "preempts": [
            {
                k: p.get(k)
                for k in ("signum", "epoch", "step_in_epoch", "coordinated")
            }
            for p in preempts
        ],
        "data_errors": len(data_errors),
    }


def summarize_run(path: str) -> Tuple[str, Dict[str, Any]]:
    """Returns ``(report_text, summary_dict)`` for a run directory."""
    run_dir = resolve_run_dir(path)
    manifest = read_manifest(run_dir)
    scalars = read_scalars(run_dir)
    events = read_events(run_dir)

    intervals = [e for e in events if e.get("kind") == "train_interval"]
    compile_ev = next((e for e in events if e.get("kind") == "compile"), None)
    evals = [e for e in events if e.get("kind") == "eval"]
    nonfinite = [e for e in events if e.get("kind") == "nonfinite"]
    t0 = events[0]["t"] if events else None

    phases = _phase_totals(intervals) if intervals else {}
    grad_curve = _curve(scalars, "Train grad_norm")
    starvation = _starvation(phases, grad_curve)

    # time-to-accuracy from eval events (wall clock vs run start);
    # scalar-only runs still get the accuracy trajectory, just untimed
    val_curve = _curve(scalars, "Val Acc1")
    tta = [
        {
            "epoch": e.get("epoch"),
            "acc1": round(float(e.get("acc1", 0.0)), 3),
            "elapsed_s": round(e["t"] - t0, 1) if t0 is not None else None,
        }
        for e in evals
    ]
    if not tta and val_curve:
        tta = [
            {"epoch": ep, "acc1": round(v, 3), "elapsed_s": None}
            for ep, v in val_curve
        ]
    best = max(tta, key=lambda r: r["acc1"]) if tta else None

    components = {}
    for s in scalars:
        tag = s.get("tag", "")
        if tag.startswith("Train loss_"):
            components.setdefault(tag[len("Train "):], []).append(
                (s["step"], s["value"])
            )
    components = {
        k: [round(v, 5) for _, v in sorted(pts)]
        for k, pts in sorted(components.items())
    }

    probes = _probe_trajectories(scalars, events)
    attribution = _attribution(run_dir, manifest, events)
    resilience = _resilience(manifest, events)
    health = _health(events)
    serving = _serving(events)
    search = _search(events)
    perf = _perf(events)
    # the LAST static-analysis verdict recorded on this timeline
    # (`check --events-into RUN_DIR`, the static analysis)
    analysis_ev = next(
        (e for e in reversed(events) if e.get("kind") == "analysis"),
        None,
    )
    analysis = (
        {
            k: analysis_ev.get(k)
            for k in ("verdict", "checkers", "files_scanned",
                      "findings", "suppressed", "by_checker")
        }
        if analysis_ev is not None else None
    )

    summary: Dict[str, Any] = {
        "run_dir": run_dir,
        "provenance": (
            {
                k: manifest.get(k)
                for k in (
                    "config_hash", "jax_version", "jaxlib_version",
                    "backend", "device_kind", "device_count",
                    "process_count", "created",
                )
            }
            if manifest
            else None
        ),
        "compile_s": (
            round(float(compile_ev["seconds"]), 3) if compile_ev else None
        ),
        "phases": phases or None,
        "starvation": starvation,
        "time_to_accuracy": tta,
        "best": best,
        "loss_components": components,
        "probes": probes,
        "attribution": attribution,
        "resilience": resilience,
        "health": health,
        "serving": serving,
        "search": search,
        "perf": perf,
        "analysis": analysis,
        "nonfinite_intervals": len(nonfinite),
    }
    # strict JSON out the other end too: a warn-policy run's NaN
    # scalars must not make `summarize --json` unparseable
    summary = jsonsafe(summary)

    lines: List[str] = [f"== Run summary: {run_dir}"]
    if manifest:
        lines.append(
            "provenance: config {config_hash}  jax {jax_version} "
            "(jaxlib {jaxlib_version})  backend {backend} "
            "[{device_kind} x{device_count}, {process_count} proc]".format(
                **{k: manifest.get(k) for k in (
                    "config_hash", "jax_version", "jaxlib_version",
                    "backend", "device_kind", "device_count",
                    "process_count",
                )}
            )
        )
    else:
        lines.append("provenance: no manifest.json (pre-telemetry run?)")
    if summary["compile_s"] is not None:
        lines.append(f"compile: first-step trace+compile {summary['compile_s']:.2f}s")
    if phases:
        lines.append(
            "host phases: data-wait {data_wait_s:.2f}s "
            "({data_wait_share:.0%})  dispatch {dispatch_s:.2f}s  "
            "drain {drain_s:.2f}s ({drain_share:.0%}) of "
            "{interval_s:.2f}s hot-loop wall".format(**phases)
        )
    lines.append(f"starvation verdict: {starvation['verdict']}")
    if nonfinite:
        lines.append(
            f"!! non-finite loss intervals: {len(nonfinite)} "
            f"(policy {nonfinite[0].get('policy', '?')})"
        )
    if health:
        if health["alerts_total"]:
            lines.append(
                f"health: {health['alerts_total']} alert(s) — "
                + ", ".join(
                    f"{k} x{v}"
                    for k, v in health["by_detector"].items()
                )
                + (
                    f"; {health['alerts_critical']} run-ending"
                    if health["alerts_critical"]
                    else ""
                )
            )
            for a in health["critical"]:
                lines.append(
                    f"  !! {a['detector']} at epoch {a.get('epoch')} "
                    f"step {a.get('step')}: {a.get('message')}"
                )
        else:
            lines.append("health: monitored, no alerts")
    if analysis:
        lines.append(
            f"static analysis: {str(analysis.get('verdict')).upper()} "
            f"({analysis.get('findings')} open, "
            f"{analysis.get('suppressed')} suppressed over "
            f"{analysis.get('files_scanned')} files; "
            + ", ".join(analysis.get("checkers") or []) + ")"
        )
    if search:
        lines.append(
            f"recipe search: {search.get('trials_total')} trial(s)"
            + (
                f" over families {', '.join(search.get('families') or [])}"
                if search.get("families")
                else ""
            )
            + (
                f" | {search.get('workers')} worker(s)"
                if search.get("workers")
                else ""
            )
            + (" | PREEMPTED mid-sweep" if search.get("preempted") else "")
        )
        ranking = search.get("ranking")
        if ranking is not None:
            lines.append(
                f"  leaderboard ({search.get('completed')} completed, "
                f"{search.get('failed')} failed; common acc level "
                f"{search.get('common_acc_level')}):"
            )
            lines.append(
                f"  {'rank':<5} {'trial':<26} {'family':<22} "
                f"{'lr':>8} {'best':>7} {'final':>7} {'t->common':>10}"
            )
            trials_meta = search.get("trials") or {}
            for row in ranking:
                meta = trials_meta.get(row.get("trial")) or {}
                ttca = meta.get("time_to_common_acc_s")
                lines.append(
                    f"  {row.get('rank'):<5} {row.get('trial'):<26} "
                    f"{row.get('family'):<22} {row.get('lr'):>8g} "
                    f"{row.get('best_top1'):>7} {row.get('final_top1'):>7} "
                    f"{(str(ttca) + 's') if ttca is not None else '-':>10}"
                )
            winner = search.get("winner")
            if winner:
                lines.append(
                    f"  winner: {winner.get('trial')} "
                    f"({winner.get('family')} @ lr {winner.get('lr')}) "
                    f"best {winner.get('best_top1')} -> "
                    f"{winner.get('run_dir')}"
                )
            resumed = search.get("resumed_trials") or {}
            for tid, info in resumed.items():
                lines.append(
                    f"  resumed lineage: {tid} took "
                    f"{info.get('attempts')} attempt(s) "
                    f"({info.get('status')}) — completed trials were "
                    "never re-run"
                )
        else:
            states = search.get("trial_states") or {}
            if states:
                lines.append(
                    "  live trial states: "
                    + ", ".join(f"{t}={s}" for t, s in states.items())
                )
            best = search.get("best_so_far")
            if best:
                lines.append(
                    f"  best so far: {best.get('trial')} "
                    f"({best.get('family')} @ lr {best.get('lr')}) "
                    f"best_top1 {best.get('best_top1')}"
                )
    if perf:
        ps = perf.get("start") or {}
        lines.append(
            f"perf observatory: roofline sweep on {ps.get('arch')} "
            f"({ps.get('artifact')}) | buckets {ps.get('buckets')} x "
            f"impls {ps.get('impls')} | {ps.get('iters')} iters on "
            f"{ps.get('device_kind')}"
        )
        pv = perf.get("verdict")
        if pv:
            s = pv.get("summary") or {}
            ceil = pv.get("ceilings") or {}
            lines.append(
                f"  ceilings: {ceil.get('matched')} — "
                f"{ceil.get('peak_flops')} FLOP/s peak, "
                f"{ceil.get('hbm_gbs')} GB/s HBM (ridge "
                f"{ceil.get('ridge_intensity')} flop/byte)"
            )
            lines.append(
                f"  best {s.get('step_ms_best')} ms/step @ b"
                f"{s.get('bucket')} | dense {s.get('step_ms_dense')} / "
                f"packed {s.get('step_ms_packed')} ms | roof "
                f"efficiency {s.get('efficiency_mean')} | attributed "
                f"{s.get('attributed_share')} | mfu {s.get('mfu_best')}"
                f" | {pv.get('perf_layer_keys')} per-layer key(s)"
            )
            for skip in pv.get("skipped") or []:
                lines.append(
                    f"  skipped {skip.get('impl')}: {skip.get('reason')}"
                )
        for c in perf.get("cells") or []:
            recon = c.get("reconciled")
            lines.append(
                f"  {c.get('impl')} b{c.get('bucket')}: "
                f"{c.get('wall_ms')} ms/step, attributed "
                f"{c.get('attributed_ms')} ms "
                + (
                    "(reconciled)" if recon
                    else "(RECONCILIATION BROKEN)" if recon is False
                    else "(unreconciled)"
                )
            )
    if serving:
        for ex in serving["exports"]:
            lines.append(
                f"export: {ex.get('artifact')} (arch {ex.get('arch')}, "
                f"{ex.get('binarized_convs')} binary convs, "
                f"{ex.get('compression_ratio')}x smaller, integrity "
                f"{ex.get('integrity')}, recorded acc1 "
                f"{ex.get('checkpoint_acc1')})"
            )
        bench = serving.get("bench")
        if bench:
            lines.append(
                f"serving: {bench.get('mode')} load on {bench.get('arch')} "
                f"| buckets {bench.get('buckets')} | queue bound "
                f"{bench.get('queue_depth')} | coalesce "
                f"{bench.get('max_delay_ms')}ms"
            )
        http = serving.get("http")
        if http:
            lines.append(
                f"serving: http front end {http.get('host')}:"
                f"{http.get('port')} on {http.get('arch')} | "
                f"{http.get('priorities')} priority classes x queue "
                f"{http.get('queue_depth')} | buckets "
                f"{http.get('buckets')}"
                + (
                    f" | scenario {http.get('scenario')} @ "
                    f"{http.get('rate_rps')} req/s"
                    if http.get("scenario")
                    else ""
                )
            )
        fleet_info = serving.get("fleet")
        if fleet_info:
            lines.append(
                f"serving: fleet router {fleet_info.get('router')} "
                f"over {len(fleet_info.get('hosts') or [])} host(s) | "
                f"{fleet_info.get('probe_transitions')} health "
                "transition(s)"
            )
        sv = serving.get("verdict")
        if sv:
            lines.append(
                f"  SLO: p50 {sv.get('p50_ms')} / p95 {sv.get('p95_ms')} "
                f"/ p99 {sv.get('p99_ms')} ms | "
                f"{sv.get('throughput_rps')} req/s | occupancy "
                f"{sv.get('mean_batch_occupancy')} | shed "
                f"{sv.get('requests_shed')}/{sv.get('requests_submitted')}"
                + (
                    " | PREEMPTED, drained cleanly"
                    if sv.get("preempted") and sv.get("drained_clean")
                    else ""
                )
            )
            if sv.get("max_queue_depth_seen") is not None:
                lines.append(
                    f"  queue: peak depth {sv.get('max_queue_depth_seen')}"
                    f" of bound {sv.get('max_queue')}"
                )
            # the per-priority latency table (v2 / serve-http verdicts)
            per_priority = sv.get("per_priority") or {}
            if per_priority:
                lines.append(
                    f"  {'class':<8} {'p50':>8} {'p95':>8} {'p99':>8} "
                    f"{'ok':>7} {'shed':>6} {'of':>7}"
                )
                for p in sorted(per_priority, key=int):
                    v = per_priority[p]

                    def _ms(x):
                        return "-" if x is None else f"{x:.1f}"

                    lines.append(
                        f"  p{p:<7} {_ms(v.get('p50_ms')):>8} "
                        f"{_ms(v.get('p95_ms')):>8} "
                        f"{_ms(v.get('p99_ms')):>8} "
                        f"{v.get('completed'):>7} {v.get('shed'):>6} "
                        f"{v.get('submitted'):>7}"
                    )
            per_tenant = sv.get("per_tenant") or {}
            for t in sorted(per_tenant):
                v = per_tenant[t]
                lines.append(
                    f"  tenant {t}: {v.get('completed')}/"
                    f"{v.get('submitted')} ok | "
                    f"{v.get('over_quota')} over-quota | "
                    f"{v.get('shed_queue')} queue-shed "
                    f"(shed rate {v.get('shed_rate')})"
                )
            if sv.get("fairness_ratio") is not None:
                lines.append(
                    "  fairness: max/min tenant service ratio "
                    f"{sv.get('fairness_ratio')}"
                )
            slo = sv.get("slo")
            if slo is not None:
                lines.append(
                    "  slo: priority-0 p99 "
                    f"{slo.get('p99_ms_priority0')} ms vs target "
                    f"{slo.get('p99_ms_target_priority0')} ms — "
                    + ("MET" if slo.get("met") else "MISSED")
                )
            # the v3 replica-pool blocks: per-replica occupancy table,
            # the --replicas scaling sweep, and the swap disposition
            reps = sv.get("replicas")
            if reps:
                lines.append(
                    f"  replicas: {reps.get('n')} on "
                    f"{reps.get('version')} | "
                    f"{reps.get('dispatched_batches')} batches "
                    f"dispatched | {reps.get('restarts')} restart(s)"
                )
                for r in reps.get("per_replica") or []:
                    lines.append(
                        f"    r{r.get('replica')} "
                        f"[{r.get('device')}] {r.get('version')}: "
                        f"{r.get('completed')} done "
                        f"({r.get('share'):.0%} share)"
                        + (
                            f", {r.get('restarts')} restart(s)"
                            if r.get("restarts") else ""
                        )
                    )
            scaling = sv.get("scaling")
            if scaling:
                lines.append(
                    "  scaling: "
                    + "  ".join(
                        f"{n}x -> "
                        f"{scaling['throughput_rps'].get(str(n))} rps"
                        for n in scaling.get("replicas") or []
                    )
                    + f" | efficiency {scaling.get('efficiency')} at "
                    f"{max(scaling.get('replicas') or [0])} replicas"
                    + (
                        "" if scaling.get("monotone")
                        else " | NOT MONOTONE"
                    )
                )
            swap = sv.get("swap")
            if swap:
                lines.append(
                    f"  swap: {swap.get('version_from')} -> "
                    f"{swap.get('version_to')} "
                    + (
                        f"DONE in {swap.get('seconds')}s"
                        if swap.get("performed")
                        else f"{swap.get('state')} "
                        f"({swap.get('error')})"
                    )
                    + f" | {swap.get('replicas_shifted')} shifted | "
                    f"shed during swap {swap.get('shed')}"
                )
                by = swap.get("answered_by") or {}
                if by:
                    lines.append(
                        "    answered by: "
                        + "  ".join(
                            f"{v}: {n}" for v, n in sorted(by.items())
                        )
                    )
            # the v5 canary episode: decision + trigger, the
            # observation windows, the per-detector evidence table and
            # the shadow-probe accounting — the rollout's whole story
            # reconstructable from the run dir alone
            can = sv.get("canary")
            if can:
                decision = can.get("decision")
                lines.append(
                    f"  canary: {can.get('version_from')} -> "
                    f"{can.get('version_to')} | fraction "
                    f"{can.get('fraction')} on replicas "
                    f"{can.get('replicas_canary')} | "
                    + (
                        f"ROLLED BACK (trigger {can.get('trigger')})"
                        if decision == "rollback"
                        else f"PROMOTED in {can.get('promote_s')}s"
                        if decision == "promote"
                        else str(decision)
                    )
                    + f" after {can.get('evaluations')} evaluation(s)"
                    f" over {can.get('observe_s')}s"
                )
                served = can.get("served") or {}
                lines.append(
                    "    served: canary "
                    f"{served.get('canary')} / incumbent "
                    f"{served.get('incumbent')}"
                )
                dets = can.get("detectors") or {}
                if dets:
                    lines.append(
                        f"    {'detector':<14} {'value':>10} "
                        f"{'threshold':>10} {'status':>10}"
                    )
                    for name in sorted(dets):
                        d = dets[name] or {}
                        status = (
                            "FIRED" if d.get("fired")
                            else "breach" if d.get("breach")
                            else "ok" if d.get("eligible")
                            else "no data"
                        )
                        val = d.get("value")
                        thr = d.get("threshold")
                        lines.append(
                            f"    {name:<14} "
                            f"{'-' if val is None else format(val, '.4g'):>10} "
                            f"{'-' if thr is None else format(thr, '.4g'):>10} "
                            f"{status:>10}"
                        )
                shadow = can.get("shadow") or {}
                lines.append(
                    f"    shadow: {shadow.get('mirrored')} mirrored, "
                    f"{shadow.get('compared')} compared, max drift "
                    f"{shadow.get('max_abs_drift')}"
                    + (
                        " (bitwise-exact — any nonzero drift is a "
                        "real defect)"
                        if (shadow.get('compared') or 0) > 0 else ""
                    )
                )
            # the v6 fleet block: per-host ledgers, the cross-host
            # retry accounting, the per-host p99 spread and the
            # summed-across-hosts drop count — the whole fleet episode
            # reconstructable from the run dir alone
            flt = sv.get("fleet")
            if flt:
                cons = flt.get("ledger_consistent")
                lines.append(
                    f"  fleet: {flt.get('n_hosts')} host(s) | "
                    f"{flt.get('completed_total')} completed | "
                    f"{flt.get('retries_total')} retries (rate "
                    f"{flt.get('retry_rate')}) | p99 spread "
                    f"{flt.get('host_p99_spread')} | dropped "
                    f"{flt.get('dropped')} | ledger "
                    + (
                        "CONSISTENT" if cons
                        else "TORN" if cons is False else "unchecked"
                    )
                )
                for label in sorted(flt.get("hosts") or {}):
                    h = (flt.get("hosts") or {})[label]
                    retries = sum((h.get("retries") or {}).values())
                    lines.append(
                        f"    {label} [{h.get('state')}] "
                        f"{h.get('host')}:{h.get('port')}: "
                        f"{h.get('completed')} done / "
                        f"{h.get('proxied')} proxied | p99 "
                        f"{h.get('p99_ms')} ms | {retries} retry(s) | "
                        f"{h.get('probe_transitions')} transition(s)"
                    )
                fswap = flt.get("swap")
                if fswap:
                    unshifted = fswap.get("hosts_unshifted") or []
                    lines.append(
                        f"    fleet swap: {fswap.get('state')} "
                        f"({len(fswap.get('hosts_shifted') or [])}/"
                        f"{fswap.get('hosts_total')} hosts shifted, "
                        f"{fswap.get('seconds')}s)"
                        + (
                            f" — {fswap.get('error')}"
                            if fswap.get("error") else ""
                        )
                        + (
                            " | !! NOT shifted (still on the old "
                            f"version if they rejoin): {unshifted}"
                            if unshifted else ""
                        )
                    )
            # the v7 fleet_attribution block: the cross-host
            # waterfall — router stages + network + the stitched
            # backend decomposition, the retry-hop share, the
            # per-host stage spread, the cross-hop reconciliation
            # identity and the slowest exemplars naming host AND
            # stage
            fat = sv.get("fleet_attribution")
            if fat:
                recon = fat.get("reconciliation") or {}
                share = fat.get("retry_hop_share")
                lines.append(
                    f"  fleet trace: {fat.get('requests')} requests "
                    f"traced (stitched {fat.get('stitched')}, "
                    f"unstitched {fat.get('unstitched')})"
                    + (
                        f" | retry-hop share {share:.1%}"
                        if share is not None else ""
                    )
                    + (
                        f" | cross-hop recon: mean err "
                        f"{recon.get('mean_abs_err_pct')}%, "
                        f"{recon.get('violations')} violation(s) "
                        + ("OK" if recon.get("ok") else "BROKEN")
                        if recon.get("mean_abs_err_pct") is not None
                        else ""
                    )
                )
                stage_parts = [
                    f"{stage} {b['p99_ms']:.1f}"
                    for stage, b in (fat.get("stages") or {}).items()
                    if b is not None and b.get("p99_ms") is not None
                ]
                if stage_parts:
                    lines.append(
                        "    router p99/stage ms  "
                        + " > ".join(stage_parts)
                    )
                bparts = [
                    f"{stage} {b['p99_ms']:.1f}"
                    for stage, b in (
                        fat.get("backend_stages") or {}
                    ).items()
                    if b is not None and b.get("p99_ms") is not None
                ]
                if bparts:
                    lines.append(
                        "    backend p99/stage ms  " + " > ".join(bparts)
                    )
                per_host_fat = fat.get("per_host") or {}
                spread_max = fat.get("host_stage_spread_max")
                if per_host_fat:
                    lines.append(
                        "    per-host backend stage p99 (ms)"
                        + (
                            f" | spread max {spread_max}"
                            if spread_max is not None else ""
                        )
                    )
                    for label in sorted(per_host_fat):
                        hb = per_host_fat[label]
                        hparts = [
                            f"{stage} {b['p99_ms']:.1f}"
                            for stage, b in (
                                hb.get("stages") or {}
                            ).items()
                            if b is not None
                            and b.get("p99_ms") is not None
                        ]
                        lines.append(
                            f"      {label} "
                            f"({hb.get('requests')} req): "
                            + (
                                " > ".join(hparts)
                                if hparts else "no stitched samples"
                            )
                        )
                for p, wfs in sorted((fat.get("tail") or {}).items()):
                    for wf in wfs[:1]:
                        waterfall = " + ".join(
                            f"{stage} {ms:.1f}"
                            for stage, ms in (
                                wf.get("stages") or {}
                            ).items()
                        )
                        lines.append(
                            f"    slowest p{p}: {wf.get('trace')} on "
                            f"{wf.get('host')} "
                            f"({wf.get('attempts')} attempt(s)) "
                            f"{wf.get('total_ms')}ms = {waterfall} | "
                            f"slowest stage {wf.get('slowest_stage')}"
                        )
            # the v4 request-path attribution: per-priority p99
            # decomposed by lifecycle stage, the reconciliation
            # identity, and the slowest exemplars' waterfalls
            att = sv.get("attribution")
            if att:
                recon = att.get("reconciliation") or {}
                share = att.get("queue_share")
                lines.append(
                    f"  trace: {att.get('requests')} requests traced "
                    f"(sampled {att.get('sampled')}, 1/"
                    f"{att.get('sample_every')})"
                    + (
                        f" | queue share {share:.0%}"
                        if share is not None else ""
                    )
                    + (
                        f" | stage sum vs e2e: mean err "
                        f"{recon.get('mean_abs_err_pct')}% "
                        + ("OK" if recon.get("ok") else "BROKEN")
                        if recon.get("mean_abs_err_pct") is not None
                        else ""
                    )
                )
                stage_names = list((att.get("stages") or {}).keys())
                per_priority_att = att.get("per_priority") or {}
                if per_priority_att and stage_names:
                    lines.append(
                        "  "
                        + f"{'class':<9}"
                        + "".join(f"{s:>10}" for s in stage_names)
                        + f"{'e2e':>10}"
                    )

                    def _a(block):
                        if not block or block.get("p99_ms") is None:
                            return "-"
                        return f"{block['p99_ms']:.1f}"

                    for p in sorted(per_priority_att, key=int):
                        v = per_priority_att[p]
                        stages_p = v.get("stages") or {}
                        lines.append(
                            "  "
                            + f"p99 p{p:<4}"
                            + "".join(
                                f"{_a(stages_p.get(s)):>10}"
                                for s in stage_names
                            )
                            + f"{_a(v.get('e2e')):>10}"
                        )
                for p, wfs in sorted((att.get("tail") or {}).items()):
                    for wf in wfs[:1]:
                        waterfall = " + ".join(
                            f"{stage} {ms:.1f}"
                            for stage, ms in (
                                wf.get("stages") or {}
                            ).items()
                        )
                        lines.append(
                            f"    slowest p{p}: #{wf.get('seq')} "
                            f"{wf.get('total_ms')}ms = {waterfall}"
                        )
            # the v8 capacity block (obs/capacity.py): the demand
            # ledger's per-key rates, utilization gauges, the SLO
            # burn-rate episodes and the saturation-headroom estimate
            cap = sv.get("capacity")
            if cap:
                burn_max = cap.get("burn_rate_max")
                headroom_rps = cap.get("headroom_rps")
                shed_max = cap.get("demand_shed_ratio_max")
                lines.append(
                    "  capacity:"
                    + (
                        f" burn max {burn_max}"
                        if burn_max is not None else " burn max -"
                    )
                    + (
                        f" | headroom {headroom_rps} rps"
                        if headroom_rps is not None else ""
                    )
                    + (
                        f" | worst shed ratio {shed_max:.1%}"
                        if shed_max is not None else ""
                    )
                )
                demand = cap.get("demand") or {}
                keys = demand.get("keys") or {}
                if keys:
                    lines.append(
                        "    "
                        + f"{'model|tenant|prio':<28}"
                        + f"{'offered':>9}{'admit':>9}"
                        + f"{'done':>9}{'shed':>9}"
                    )
                    for key in sorted(keys):
                        row = keys[key]
                        lines.append(
                            "    "
                            + f"{key:<28}"
                            + f"{row.get('offered_rps', 0):>9}"
                            + f"{row.get('admitted_rps', 0):>9}"
                            + f"{row.get('completed_rps', 0):>9}"
                            + f"{row.get('shed_rps', 0):>9}"
                        )
                budget = cap.get("slo_budget") or {}
                for ep in budget.get("episodes") or []:
                    t_end = ep.get("t_end")
                    lines.append(
                        f"    burn episode: {ep.get('detector')} "
                        f"peak {ep.get('peak_burn_rate')} "
                        + (
                            f"({ep.get('t_end') - ep.get('t_start'):.1f}s)"
                            if t_end is not None else "(still open)"
                        )
                    )
                hr = cap.get("headroom") or {}
                if hr.get("capacity_rps_est") is not None:
                    tts = hr.get("seconds_to_saturation")
                    lines.append(
                        f"    est capacity {hr['capacity_rps_est']} rps"
                        + (
                            f" | saturates in {tts:.0f}s at current slope"
                            if tts is not None else ""
                        )
                    )
                # fleet-merged producer: per-host freshness + gates
                flc = cap.get("fleet")
                if flc:
                    lines.append(
                        f"    fleet: {flc.get('hosts_fresh')} fresh / "
                        f"{flc.get('hosts_stale')} stale host(s)"
                    )
                    for label in sorted(flc.get("hosts") or {}):
                        hb = (flc.get("hosts") or {})[label]
                        lines.append(
                            f"      {label}: "
                            + ("STALE" if hb.get("stale") else "fresh")
                            + f" | offered {hb.get('offered_rps')} rps"
                            + f" | burn {hb.get('burn_rate_max')}"
                            + f" | headroom {hb.get('headroom_rps')}"
                        )
    if tta:
        lines.append("time-to-accuracy (val top-1):")
        for r in tta:
            elapsed = (
                f"{r['elapsed_s']:9.1f}s" if r["elapsed_s"] is not None
                else "        -"
            )
            lines.append(
                f"  epoch {r['epoch']:>4}  {elapsed}  acc1 {r['acc1']:6.2f}"
            )
        if best:
            lines.append(
                f"  best: {best['acc1']:.2f} @ epoch {best['epoch']}"
            )
    if components:
        lines.append("loss components (per-epoch means, first -> last):")
        for name, vals in components.items():
            lines.append(
                f"  {name:<12} {vals[0]:.5g} -> {vals[-1]:.5g} "
                f"({len(vals)} epochs)"
            )
    if attribution:
        cats = attribution.get("categories_ms_per_step") or {}
        if cats:
            cap = attribution.get("captured") or {}
            lines.append(
                "device attribution (ms/step over "
                f"{attribution.get('n_steps')} traced steps @ epoch "
                f"{cap.get('epoch')} step {cap.get('start_step')}):"
            )
            total = attribution.get("step_total_ms")
            for name, ms in cats.items():
                share = f" ({ms / total:.0%})" if total else ""
                lines.append(f"  {name:<16} {ms:8.3f} ms{share}")
            if total:
                lines.append(f"  {'step total':<16} {total:8.3f} ms")
            if attribution.get("mfu") is not None:
                lines.append(
                    f"  MFU {attribution['mfu']:.1%} of "
                    f"{attribution.get('peak_tflops')} TFLOP/s bf16 peak"
                )
        host = attribution.get("host_phases_ms_per_step") or {}
        if host:
            lines.append(
                "host phases in window: "
                + "  ".join(f"{k} {v:.3f} ms" for k, v in host.items())
            )
        hbm = attribution.get("hbm")
        if hbm:
            if hbm.get("limit_gib"):
                lines.append(
                    f"hbm: peak {hbm['peak_gib']:.2f} GiB of "
                    f"{hbm['limit_gib']:.2f} GiB "
                    f"({hbm['utilization']:.0%})"
                )
            else:
                lines.append(f"hbm: peak {hbm['peak_gib']:.2f} GiB")
    res = resilience
    if (
        res["checkpoints"]
        or res["restart_count"]
        or res["restores"]
        or res["preempts"]
        or res["data_errors"]
    ):
        parts = []
        if res["checkpoints"]:
            mid = res["mid_epoch_checkpoints"]
            parts.append(
                f"{res['checkpoints']} checkpoint(s)"
                + (f" ({mid} mid-epoch)" if mid else "")
                + (
                    f", last {res['last_checkpoint_age_s']:.0f}s before "
                    "the run's last event"
                    if res["last_checkpoint_age_s"] is not None
                    else ""
                )
            )
        if res["restart_count"]:
            parts.append(f"restart #{res['restart_count']} in lineage")
        lines.append("resilience: " + ("  ".join(parts) or "events only"))
        for r in res["restores"]:
            lines.append(
                f"  restored from {r.get('source')} (epoch "
                f"{r.get('epoch')} step {r.get('step_in_epoch')}, "
                f"integrity {r.get('integrity')}"
                + (", FELL BACK to checkpoint.old" if r.get("fallback") else "")
                + ")"
            )
            if r.get("resharded"):
                tf, tt = r.get("topology_from") or {}, r.get("topology_to") or {}
                lines.append(
                    "    elastic resume: "
                    f"{tf.get('processes')} proc x {tf.get('devices')} dev"
                    f" -> {tt.get('processes')} proc x {tt.get('devices')}"
                    " dev (global arrays resharded)"
                )
        for p in res["preempts"]:
            lines.append(
                f"  preempted by signal {p.get('signum')} at epoch "
                f"{p.get('epoch')} step {p.get('step_in_epoch')} "
                + (
                    "(coordinated pod-wide mid-epoch checkpoint saved)"
                    if p.get("coordinated")
                    else "(mid-epoch checkpoint saved)"
                )
            )
        if res["data_errors"]:
            lines.append(
                f"  !! {res['data_errors']} corrupt sample(s) substituted "
                "(data_error events)"
            )
    if probes:
        lines.append(
            "binarization probes (per-layer, first -> last interval/epoch):"
        )
        lines.append(
            f"  {'layer':<28} {'flip rate':>22} {'kurtosis':>22}"
        )
        for layer, d in sorted(probes.items()):
            fr = (
                f"{d.get('flip_rate_first', float('nan')):.2e} -> "
                f"{d.get('flip_rate_last', float('nan')):.2e}"
            )
            ku = (
                f"{d.get('kurtosis_first', float('nan')):8.3f} -> "
                f"{d.get('kurtosis_last', float('nan')):8.3f}"
            )
            lines.append(f"  {layer:<28} {fr:>22} {ku:>22}")
    return "\n".join(lines), summary

"""Cross-run regression comparison: ``compare`` CLI engine — the port's
copy of ``bdbnn_tpu/obs/compare.py``, whose trace-derived step ms and MFU
come from the port's parser (obs/trace.py) and the card's bf16 peak.

The repo accumulates run directories and artifact JSONs
(``ACCURACY_*.json`` accuracy curves, ``BENCH_*.json`` bench lines)
that until now were compared by eyeball. This module turns "did this
change regress the run?" into a machine-checkable verdict:

- :func:`extract_run` normalizes any source — a telemetry run dir
  (manifest + events + scalars; serve-bench run dirs included), an
  ``ACCURACY_*``-shaped artifact, a ``BENCH_*``-shaped artifact, or a
  serve-bench SLO ``verdict.json`` — into one ``{provenance, metrics}``
  record;
- :func:`compare_runs` aligns candidates against a baseline on
  manifest provenance (arch, dataset, recipe fields — serve sources
  align on the recipe their export embedded), then judges each shared
  metric against a configurable tolerance: time-to-accuracy, best/final
  top-1, jit step ms, img/s, MFU, HBM peak, wall time, run-ending alert
  counts, and the serving SLO (p99 latency, throughput, shed rate);
- :func:`render_comparison` renders the human table; the verdict dict
  itself is strict JSON (``--json``) and deterministic — no clocks, no
  absolute paths beyond what the caller passed — so it can be diffed,
  committed, and used as a CI/perf gate (nonzero exit on regression).

Stdlib-only (obs-package rule): comparisons load neither torch nor
numpy and touch no device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from bdbnn_tpu_torch.obs.events import jsonsafe, read_events
from bdbnn_tpu_torch.obs.health import RUN_ENDING_SEVERITY
from bdbnn_tpu_torch.obs.manifest import read_manifest
from bdbnn_tpu_torch.obs.memory import hbm_watermark
from bdbnn_tpu_torch.obs.trace import attribute_trace, find_trace_file

# config fields that define "the same experiment": two runs disagreeing
# on any of these are a recipe change, not a regression — compare
# refuses (exit 2) unless --allow-mismatch. Unknown (None/absent on
# either side) never counts as a mismatch: artifacts carry partial
# provenance.
RECIPE_FIELDS: Tuple[str, ...] = (
    "arch", "dataset", "ede", "w_kurtosis", "w_kurtosis_target",
    "kurtosis_mode", "imagenet_setting_step_2_ts", "react", "twoblock",
    "dtype", "batch_size", "epochs", "lr", "opt_policy",
    # the binarizer family spec (nn/binarize.py registry; config
    # validate() canonicalizes it, so "ste" vs "proximal:delta1=0.25"
    # runs never silently compare as same-recipe). Pre-registry
    # manifests lack the key -> None -> never a mismatch.
    "binarizer",
)

# metric -> (direction, tolerance kind). Directions: "higher" is
# better or "lower" is better. Tolerance kinds: "acc" = absolute
# percentage points (tol_acc_pp), "rel" = fraction of the baseline
# (tol_rel), "hbm" = fraction of the baseline (tol_hbm), "count" =
# any increase is a regression.
METRIC_SPECS: Tuple[Tuple[str, str, str], ...] = (
    ("best_acc1", "higher", "acc"),
    ("final_acc1", "higher", "acc"),
    ("time_to_common_acc_s", "lower", "rel"),
    ("time_to_target_s", "lower", "rel"),
    ("wall_s", "lower", "rel"),
    ("img_per_s", "higher", "rel"),
    ("jit_step_ms", "lower", "rel"),
    ("mfu", "higher", "rel"),
    ("hbm_peak_bytes", "lower", "hbm"),
    ("alerts_critical", "lower", "count"),
    # serving SLO metrics (serve-bench verdicts / serve run dirs):
    # judged under --tol-rel like the other perf metrics; a shed-rate
    # increase against a zero-shed baseline is always a regression
    # (rel tolerance of 0 is 0)
    ("serve_p99_ms", "lower", "rel"),
    ("serve_throughput_rps", "higher", "rel"),
    ("serve_shed_rate", "lower", "rel"),
    # v2 (serve-http) verdicts: PER-PRIORITY p99 for classes 0-2 (the
    # front end's default class count; the metric skeleton must stay
    # static for the deterministic golden verdict, so runs with MORE
    # classes are judged per-class only up to p2 — classes beyond that
    # are covered by the aggregate p99/shed_rate alone) — a regression
    # in a judged class exits 3 even when the aggregate hides it
    # behind a flood of cheap low-priority traffic — plus the max/min
    # tenant fairness ratio and the worst tenant's shed rate (both
    # lower = better, --tol-rel). v1 verdicts leave these None
    # (skipped).
    ("serve_p99_ms_p0", "lower", "rel"),
    ("serve_p99_ms_p1", "lower", "rel"),
    ("serve_p99_ms_p2", "lower", "rel"),
    ("serve_fairness_ratio", "lower", "rel"),
    ("serve_tenant_shed_rate_max", "lower", "rel"),
    # v3 (replica pool, serve/pool.py) verdicts: the --replicas sweep's
    # scaling efficiency (throughput at N_max over ideal linear scaling
    # from N_min — higher is better, --tol-rel) and the blue/green
    # rollout's shed+dropped total under ZERO tolerance: a hot-swap
    # that loses even one request is a regression no tolerance can
    # wave through. v1/v2 verdicts leave both None (skipped).
    ("serve_scaling_efficiency", "higher", "rel"),
    ("serve_swap_dropped", "lower", "count"),
    # packed residency (nn/packed.py, serve/engine.py packed mode):
    # resident device bytes per model (the multi-tenant capacity
    # figure — lower is better; a change that silently re-densifies
    # the resident set regresses here even when latency holds) and
    # the packed forward's measured per-step ms (the honest cost of
    # the on-the-fly unpack — lower, --tol-rel). v1/v2 and
    # v3-without-packed verdicts leave both None (skipped).
    ("serve_resident_bytes_per_model", "lower", "rel"),
    ("serve_packed_step_ms", "lower", "rel"),
    # v4 request-path attribution (obs/rtrace.py): the stage-share
    # regression gates. serve_p99_queue_ms / serve_p99_compute_ms are
    # the queue-wait and device-compute stage p99s (rolling windows,
    # merged across priorities); serve_queue_share is the
    # (queue + dispatch) share of the summed stage means. A p99 that
    # moved from device-bound to queue-bound regresses here — exit 3 —
    # even when the aggregate serve_p99_ms is flat. v1-v3 verdicts
    # (no attribution block) leave all three None (skipped).
    ("serve_p99_queue_ms", "lower", "rel"),
    ("serve_p99_compute_ms", "lower", "rel"),
    ("serve_queue_share", "lower", "rel"),
    # v5 canary rollouts (serve/canary.py): a canary that ROLLED BACK
    # is a regression no tolerance can wave through — the whole point
    # of the doctored-run gate is that the rollback is visible even
    # when the aggregate p99 is unchanged (the degradation hit only a
    # priority-class window). Shadow logit drift is likewise
    # zero-tolerance: packed inference is deterministic and
    # bitwise-exact, so ANY drift between an incumbent and a
    # republished-identical canary is a real defect, never float
    # noise. Promote wall seconds is an ordinary perf metric
    # (--tol-rel). v1-v4 verdicts (no canary block) leave all three
    # None (skipped).
    ("serve_canary_rollbacks", "lower", "count"),
    ("serve_shadow_logit_drift_max", "lower", "count"),
    ("serve_canary_promote_s", "lower", "rel"),
    # v6 fleet verdicts (serve/fleet.py): the summed-across-hosts
    # dropped count is the zero-tolerance drain contract one topology
    # level up — a fleet that lost even one request to a host failure
    # is a regression no tolerance can wave through. The cross-host
    # retry rate (retries per routed request, --tol-rel) catches a
    # build that quietly started burning peer retries to hide a flaky
    # host, and the per-host p99 spread (max/min host p99, --tol-rel)
    # catches dispatch skew — one slow host hiding behind a healthy
    # fleet aggregate. v1-v5 verdicts (no fleet block) leave all
    # three None, so they skip cleanly in BOTH directions.
    ("serve_fleet_dropped", "lower", "count"),
    ("serve_fleet_retry_rate", "lower", "rel"),
    ("serve_fleet_host_p99_spread", "lower", "rel"),
    # v7 fleet_attribution (obs/rtrace.py FleetTracer): the cross-host
    # waterfall's three tail-attribution gates. Network-stage p99
    # catches proxy/transport regressions the backend's own stages
    # can't see; retry-hop share catches tails minted by re-dispatch
    # (a clean baseline's share is 0.0, so ANY wedged increase is a
    # regression regardless of --tol-rel — rel tolerance of a zero
    # baseline is zero); per-host stage-spread max catches one host
    # going slow in one stage behind a healthy fleet aggregate. v1-v6
    # verdicts (no fleet_attribution block) leave all three None, so
    # they skip cleanly in BOTH directions.
    ("serve_fleet_p99_network_ms", "lower", "rel"),
    ("serve_fleet_retry_hop_share", "lower", "rel"),
    ("serve_fleet_stage_spread_max", "lower", "rel"),
    # v8 capacity block (obs/capacity.py): the capacity observatory's
    # three flat gates. Worst burn rate catches a build that started
    # torching its error budget (burn is already normalized against
    # the objective, so ANY wedged increase against a calm baseline is
    # a regression — rel tolerance of a zero baseline is zero);
    # headroom rps (higher — shrinking saturation margin at the same
    # offered load is a capacity regression even when the p99 held);
    # worst per-key shed ratio catches one (model, tenant, priority)
    # key being starved behind a healthy aggregate. v1-v7 verdicts
    # (no capacity block) leave all three None, so they skip cleanly
    # in BOTH directions.
    ("serve_burn_rate_max", "lower", "rel"),
    ("serve_headroom_rps", "higher", "rel"),
    ("serve_demand_shed_ratio_max", "lower", "rel"),
    # recipe-search leaderboards: the winning
    # trial's best top-1 (absolute pp tolerance, like the training
    # accuracies) and its time to the sweep's common-accuracy level —
    # the same time-to-common-accuracy judgment compare applies
    # run-vs-run, here sweep-vs-sweep. Non-search sources leave both
    # None, so they skip cleanly in both directions.
    ("search_best_top1", "higher", "acc"),
    ("search_time_to_common_acc_s", "lower", "rel"),
    # v8 perf verdicts (obs/roofline.py): the performance
    # observatory's flat aggregates — best/dense/packed step ms at the
    # summary bucket (lower, --tol-rel), the mean per-layer roofline
    # efficiency (higher — a drop means kernels moved AWAY from their
    # roof even if walls held), and the attributed share of device
    # time (higher — a drop means the trace join degraded and the
    # per-layer gates below are seeing less of the step). On top of
    # these STATIC keys, compare_runs judges every (layer, bucket,
    # impl) ms the two perf sources share as a dynamic
    # ``perf_ms[...]`` row under --tol-rel — the per-layer regression
    # gate: a kernel swap that holds the aggregate while regressing
    # one layer exits 3. Non-perf sources leave all of these None, so
    # they skip cleanly in both directions.
    ("perf_step_ms_best", "lower", "rel"),
    ("perf_step_ms_dense", "lower", "rel"),
    ("perf_step_ms_packed", "lower", "rel"),
    ("perf_efficiency_mean", "higher", "rel"),
    ("perf_attributed_share", "higher", "rel"),
)

# serve-verdict field -> compare metric name (flat v1 aggregates)
_SERVE_METRIC_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("p99_ms", "serve_p99_ms"),
    ("throughput_rps", "serve_throughput_rps"),
    ("shed_rate", "serve_shed_rate"),
)

# how many priority classes get their own compare metric (the default
# class count of the serve-http front end; verdicts with fewer classes
# simply leave the tail None)
_SERVE_PRIORITY_CLASSES = 3


def _serve_metrics(verdict: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one serve verdict (v1 or v2) into the compare metric
    namespace — shared by the run-dir and artifact extraction paths."""
    out: Dict[str, Any] = {}
    for field, name in _SERVE_METRIC_FIELDS:
        out[name] = verdict.get(field)
    per_priority = verdict.get("per_priority") or {}
    for p in range(_SERVE_PRIORITY_CLASSES):
        out[f"serve_p99_ms_p{p}"] = (
            (per_priority.get(str(p)) or {}).get("p99_ms")
        )
    out["serve_fairness_ratio"] = verdict.get("fairness_ratio")
    shed_rates = [
        t.get("shed_rate")
        for t in (verdict.get("per_tenant") or {}).values()
        if t.get("shed_rate") is not None
    ]
    out["serve_tenant_shed_rate_max"] = (
        max(shed_rates) if shed_rates else None
    )
    # v3 blocks: replica-pool scaling + swap disposition
    out["serve_scaling_efficiency"] = (
        (verdict.get("scaling") or {}).get("efficiency")
    )
    # packed-residency blocks: resident bytes per model from the
    # `resident` block (max over models — the binding per-chip figure),
    # packed step ms from the A/B `packed` block's packed side
    resident = verdict.get("resident")
    out["serve_resident_bytes_per_model"] = (
        (resident or {}).get("bytes_per_model_max")
    )
    packed = verdict.get("packed")
    out["serve_packed_step_ms"] = (
        ((packed or {}).get("packed") or {}).get("step_ms")
    )
    # v4 attribution block (obs/rtrace.py): the stage decomposition's
    # queue/compute p99s + the queue share — None on v1-v3 verdicts
    # and traced-off v4 runs, so they skip cleanly
    att = verdict.get("attribution")
    stages = (att or {}).get("stages") or {}
    out["serve_p99_queue_ms"] = (
        (stages.get("queue") or {}).get("p99_ms")
    )
    out["serve_p99_compute_ms"] = (
        (stages.get("compute") or {}).get("p99_ms")
    )
    out["serve_queue_share"] = (att or {}).get("queue_share")
    # v5 canary block (serve/canary.py): rollback count, the shadow
    # probe's max-abs logit drift (None when no mirror ever compared —
    # "not measured", never a fabricated 0.0), and the promote wall
    # seconds (None on rollbacks). Absent block -> all None, so v1-v4
    # verdicts skip cleanly.
    can = verdict.get("canary")
    out["serve_canary_rollbacks"] = (
        None if can is None else int(can.get("rollbacks") or 0)
    )
    out["serve_shadow_logit_drift_max"] = (
        (can or {}).get("shadow") or {}
    ).get("max_abs_drift")
    out["serve_canary_promote_s"] = (can or {}).get("promote_s")
    # v6 fleet block (serve/fleet.py): the summed-across-hosts dropped
    # count (None when no client observed the run — "not measured",
    # never a fabricated 0), the cross-host retry rate and the
    # per-host p99 spread. Absent block -> all None, so v1-v5
    # verdicts skip the fleet gates cleanly.
    fleet = verdict.get("fleet")
    fleet_dropped = (fleet or {}).get("dropped")
    out["serve_fleet_dropped"] = (
        None if fleet is None or fleet_dropped is None
        else int(fleet_dropped)
    )
    out["serve_fleet_retry_rate"] = (fleet or {}).get("retry_rate")
    out["serve_fleet_host_p99_spread"] = (
        (fleet or {}).get("host_p99_spread")
    )
    # v7 fleet_attribution block (obs/rtrace.py): network-stage p99
    # from the router's stitched cross-host windows, the retry-hop
    # share of cumulative e2e, and the max per-stage cross-host p99
    # spread. Absent block -> all None, so v1-v6 verdicts skip the
    # attribution gates cleanly.
    fa = verdict.get("fleet_attribution")
    out["serve_fleet_p99_network_ms"] = (
        ((fa or {}).get("stages") or {}).get("network") or {}
    ).get("p99_ms")
    out["serve_fleet_retry_hop_share"] = (
        (fa or {}).get("retry_hop_share")
    )
    out["serve_fleet_stage_spread_max"] = (
        (fa or {}).get("host_stage_spread_max")
    )
    # v8 capacity block (obs/capacity.py): the observatory publishes
    # its three gates FLAT at the block's top level (host and fleet
    # producers alike) exactly so these reads stay constant-subscript.
    # Absent block -> all None, so v1-v7 verdicts skip the capacity
    # gates cleanly in both directions.
    cap = verdict.get("capacity")
    out["serve_burn_rate_max"] = (cap or {}).get("burn_rate_max")
    out["serve_headroom_rps"] = (cap or {}).get("headroom_rps")
    out["serve_demand_shed_ratio_max"] = (
        (cap or {}).get("demand_shed_ratio_max")
    )
    swap = verdict.get("swap")
    if swap is None:
        out["serve_swap_dropped"] = None
    else:
        # everything a rollout may have cost: requests shed while the
        # swap rolled plus client-observed drops on a swap run — the
        # zero-tolerance number. A rollout that never COMPLETED counts
        # as at least one lost unit: a failed swap must not score 0
        # and slip past the gate just because traffic stayed on vN.
        dropped = (verdict.get("client") or {}).get("dropped") or 0
        not_performed = 0 if swap.get("performed") else 1
        out["serve_swap_dropped"] = (
            (swap.get("shed") or 0) + dropped + not_performed
        )
    return out

# perf-verdict summary field -> compare metric name (obs/roofline.py
# ``summary`` block; the table shape keeps the flattener AST-scannable
# by analysis/verdictcheck.py)
_PERF_METRIC_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("step_ms_best", "perf_step_ms_best"),
    ("step_ms_dense", "perf_step_ms_dense"),
    ("step_ms_packed", "perf_step_ms_packed"),
    ("efficiency_mean", "perf_efficiency_mean"),
    ("attributed_share", "perf_attributed_share"),
)


def _perf_metrics(verdict: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one perf verdict (obs/roofline.py schema v1) into the
    compare metric namespace — shared by the run-dir and artifact
    extraction paths. A static-only run has no summary aggregates:
    every key stays None (skipped), never a fabricated 0."""
    summary = verdict.get("summary") or {}
    out: Dict[str, Any] = {}
    for field, name in _PERF_METRIC_FIELDS:
        out[name] = summary.get(field)
    return out


def _search_metrics(leaderboard: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one recipe-search leaderboard into
    the compare metric namespace — shared by the sweep-dir and
    leaderboard-artifact extraction paths. A sweep with no completed
    trial has no winner: both metrics stay None (skipped), never a
    fabricated 0."""
    winner = leaderboard.get("winner") or {}
    return {
        "search_best_top1": winner.get("best_top1"),
        "search_time_to_common_acc_s": winner.get(
            "time_to_common_acc_s"
        ),
    }


# the metric-key skeleton every extracted source carries (None = the
# source does not know this metric; _judge skips it). time_to_common_acc
# is derived pairwise in compare_runs, never stored per source.
_EMPTY_METRICS: Dict[str, Any] = {
    name: None
    for name, _, _ in METRIC_SPECS
    if name != "time_to_common_acc_s"
}
_EMPTY_METRICS["alerts_total"] = None


def _recipe_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    return {k: cfg.get(k) for k in RECIPE_FIELDS}


def _extract_run_dir(path: str) -> Dict[str, Any]:
    from bdbnn_tpu_torch.obs.summarize import resolve_run_dir

    run_dir = resolve_run_dir(path)
    manifest = read_manifest(run_dir) or {}
    events = read_events(run_dir)
    cfg = manifest.get("config") or {}

    evals = [e for e in events if e.get("kind") == "eval"]
    intervals = [e for e in events if e.get("kind") == "train_interval"]
    memory = [e for e in events if e.get("kind") == "memory"]
    alerts = [e for e in events if e.get("kind") == "alert"]
    end = next((e for e in events if e.get("kind") == "run_end"), None)
    t0 = events[0]["t"] if events else None

    best_acc1 = None
    if end is not None and end.get("best_acc1") is not None:
        best_acc1 = float(end["best_acc1"])
    elif evals:
        best_acc1 = max(float(e.get("acc1") or 0.0) for e in evals)
    final_acc1 = float(evals[-1]["acc1"]) if evals else None

    # time-to-accuracy curve (elapsed seconds vs run start) kept raw so
    # compare_runs can evaluate it at whatever level both runs reached
    acc_curve = [
        (float(e.get("acc1") or 0.0), round(float(e["t"]) - t0, 1))
        for e in evals
        if t0 is not None and e.get("t") is not None
    ]

    img_rates = [
        float(e["img_per_s"])
        for e in intervals[1:]  # skip the compile-tainted first interval
        if isinstance(e.get("img_per_s"), (int, float))
    ] or [
        float(e["img_per_s"])
        for e in intervals
        if isinstance(e.get("img_per_s"), (int, float))
    ]
    img_per_s = (
        round(sorted(img_rates)[len(img_rates) // 2], 2)
        if img_rates else None
    )

    jit_step_ms = mfu = None
    profile_evs = [e for e in events if e.get("kind") == "profile"]
    if profile_evs:
        pe = profile_evs[-1]
        trace = None
        for root in (run_dir, pe.get("trace_dir") or ""):
            if root and os.path.isdir(root):
                trace = find_trace_file(root)
                if trace:
                    break
        if trace:
            from bdbnn_tpu_torch.obs.trace import BF16_PEAK_TFLOPS

            att = attribute_trace(
                trace,
                pe.get("steps") or 1,
                flops_per_step=pe.get("flops_per_step"),
                peak_tflops=BF16_PEAK_TFLOPS.get(
                    manifest.get("device_kind", "")
                ),
            )
            jit_step_ms = att.get("step_total_ms")
            mfu = att.get("mfu")

    wm = hbm_watermark(memory)
    metrics = dict(_EMPTY_METRICS)
    metrics.update({
        "best_acc1": best_acc1,
        "final_acc1": final_acc1,
        "time_to_target_s": (end or {}).get("time_to_target_s"),
        "wall_s": (end or {}).get("wall_s"),
        "img_per_s": img_per_s,
        "jit_step_ms": jit_step_ms,
        "mfu": mfu,
        "hbm_peak_bytes": (wm or {}).get("peak_bytes"),
        "alerts_total": len(alerts),
        "alerts_critical": sum(
            1 for a in alerts
            if a.get("severity") == RUN_ENDING_SEVERITY
        ),
    })
    # a serve-bench run dir: the final `serve` verdict event carries
    # the SLO metrics; alignment uses the recipe the serve manifest
    # copied from the export's provenance
    from bdbnn_tpu_torch.obs.events import serve_digest

    serve_verdict = serve_digest(events)["verdict"]
    if serve_verdict is not None:
        metrics.update(_serve_metrics(serve_verdict))
    # a recipe-search sweep dir: the final `search` verdict event
    # carries the leaderboard; judged on the
    # winner's metrics, aligned on the sweep's shared recipe
    search_verdict = next(
        (
            e for e in reversed(events)
            if e.get("kind") == "search" and e.get("phase") == "verdict"
        ),
        None,
    )
    if search_verdict is not None:
        metrics.update(_search_metrics(search_verdict))
    # a perf run dir (obs/roofline.py): the final `perf` verdict event
    # embeds the full perf_verdict; alignment uses the recipe the
    # verdict copied from the artifact's provenance (the PerfConfig
    # manifest itself carries no arch/dataset)
    perf_ev = next(
        (
            e for e in reversed(events)
            if e.get("kind") == "perf" and e.get("phase") == "verdict"
        ),
        None,
    )
    perf_layers: Dict[str, Any] = {}
    recipe = _recipe_from_config(cfg)
    if perf_ev is not None:
        pv = perf_ev.get("verdict") or {}
        metrics.update(_perf_metrics(pv))
        perf_layers = pv.get("perf_layers") or {}
        pv_recipe = (pv.get("provenance") or {}).get("recipe")
        if pv_recipe:
            recipe = _recipe_from_config(pv_recipe)
    fmt = "run_dir"
    if serve_verdict is not None:
        fmt = "serve_run_dir"
    elif search_verdict is not None:
        fmt = "search_run_dir"
    elif perf_ev is not None:
        fmt = "perf_run_dir"
    return {
        "source": path,
        "format": fmt,
        "provenance": {
            "config_hash": manifest.get("config_hash"),
            "device_kind": manifest.get("device_kind"),
            "recipe": recipe,
        },
        "metrics": metrics,
        "acc_curve": acc_curve,
        "perf_layers": perf_layers,
    }


def _extract_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        d = json.load(f)
    if "serve_verdict" in d:
        # a serve-bench SLO verdict (serve/loadgen.py): aligned on the
        # export provenance it embeds, judged on p99/throughput/shed
        prov = d.get("provenance") or {}
        metrics = dict(_EMPTY_METRICS)
        metrics.update(_serve_metrics(d))
        return {
            "source": path,
            "format": "serve_verdict",
            "provenance": {
                "config_hash": prov.get("config_hash"),
                "device_kind": None,
                "recipe": _recipe_from_config(prov.get("recipe") or {}),
            },
            "metrics": metrics,
            "acc_curve": [],
        }
    if "search_verdict" in d:
        # a recipe-search leaderboard JSON: judged
        # on the winner's best top-1 + time-to-common-accuracy,
        # aligned on the sweep's shared recipe provenance
        prov = d.get("provenance") or {}
        metrics = dict(_EMPTY_METRICS)
        metrics.update(_search_metrics(d))
        return {
            "source": path,
            "format": "search_leaderboard",
            "provenance": {
                "config_hash": prov.get("config_hash"),
                "device_kind": None,
                "recipe": _recipe_from_config(prov.get("recipe") or {}),
            },
            "metrics": metrics,
            "acc_curve": [],
        }
    if "perf_verdict" in d:
        # a roofline perf verdict (obs/roofline.py): aligned on the
        # artifact provenance it embeds, judged on summary aggregates
        # plus per-(layer, bucket, impl) device ms via perf_layers
        prov = d.get("provenance") or {}
        metrics = dict(_EMPTY_METRICS)
        metrics.update(_perf_metrics(d))
        return {
            "source": path,
            "format": "perf_verdict",
            "provenance": {
                "config_hash": prov.get("config_hash"),
                "device_kind": prov.get("device_kind"),
                "recipe": _recipe_from_config(prov.get("recipe") or {}),
            },
            "metrics": metrics,
            "acc_curve": [],
            "perf_layers": d.get("perf_layers") or {},
        }
    parsed = d.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed:
        # BENCH_*.json shape: a bench harness line under "parsed"
        recipe = _recipe_from_config(
            {"dtype": parsed.get("dtype")}
        )
        metrics = dict(_EMPTY_METRICS)
        metrics.update({
            "img_per_s": parsed.get("value") or None,
            "jit_step_ms": parsed.get("device_ms_per_step"),
            "mfu": parsed.get("device_mfu"),
        })
        return {
            "source": path,
            "format": "bench_artifact",
            "provenance": {
                "config_hash": None,
                "device_kind": parsed.get("device_kind"),
                "recipe": recipe,
            },
            "metrics": metrics,
            "acc_curve": [],
        }
    if "best_val_top1" in d:
        # ACCURACY_*.json shape
        recipe = _recipe_from_config(d)
        curve = d.get("val_top1_curve") or []
        metrics = dict(_EMPTY_METRICS)
        metrics.update({
            "best_acc1": d.get("best_val_top1"),
            "final_acc1": curve[-1] if curve else None,
            "time_to_target_s": d.get("time_to_target_s"),
            "wall_s": d.get("wall_seconds"),
        })
        return {
            "source": path,
            "format": "accuracy_artifact",
            "provenance": {
                "config_hash": None,
                "device_kind": d.get("device_kind"),
                "recipe": recipe,
            },
            "metrics": metrics,
            "acc_curve": [],
        }
    raise ValueError(
        f"{path!r}: not a recognized artifact (want a BENCH_*.json "
        "'parsed' bench line, an ACCURACY_*.json with best_val_top1, "
        "a serve-bench verdict.json, a search leaderboard.json, or a "
        "perf_verdict.json)"
    )


def extract_run(path: str) -> Dict[str, Any]:
    """Normalize one source (run dir OR artifact JSON) into
    ``{source, format, provenance, metrics, acc_curve}``. Directories
    go through ``resolve_run_dir`` (which raises on a dir with no run
    files); files must be a recognized artifact shape."""
    if os.path.isdir(path):
        return _extract_run_dir(path)
    if os.path.isfile(path):
        return _extract_artifact(path)
    raise FileNotFoundError(f"compare source not found: {path!r}")


def _time_to_acc(curve: List, level: float) -> Optional[float]:
    for acc, elapsed in curve:
        if acc >= level:
            return elapsed
    return None


def _mismatches(base: Dict[str, Any], cand: Dict[str, Any]) -> List[str]:
    """Recipe fields where BOTH sides know a value and they differ."""
    out = []
    br = base["provenance"]["recipe"]
    cr = cand["provenance"]["recipe"]
    for field in RECIPE_FIELDS:
        b, c = br.get(field), cr.get(field)
        if b is not None and c is not None and b != c:
            out.append(f"{field}: {b!r} vs {c!r}")
    return out


def _judge(
    name: str, direction: str, kind: str,
    base: Optional[float], cand: Optional[float],
    *, tol_acc_pp: float, tol_rel: float, tol_hbm: float,
) -> Optional[Dict[str, Any]]:
    if base is None or cand is None:
        return None
    base, cand = float(base), float(cand)
    tol = {
        "acc": tol_acc_pp,
        "rel": tol_rel * abs(base),
        "hbm": tol_hbm * abs(base),
        "count": 0.0,
    }[kind]
    delta = round(cand - base, 6)
    worse = -delta if direction == "higher" else delta
    if worse > tol:
        verdict = "regression"
    elif worse < -tol:
        verdict = "improvement"
    else:
        verdict = "ok"
    return {
        "metric": name,
        "baseline": base,
        "candidate": cand,
        "delta": delta,
        "tolerance": round(tol, 6),
        "direction": direction,
        "verdict": verdict,
    }


def compare_runs(
    paths: Sequence[str],
    *,
    tol_acc_pp: float = 0.5,
    tol_rel: float = 0.10,
    tol_hbm: float = 0.05,
    allow_mismatch: bool = False,
) -> Dict[str, Any]:
    """First path is the baseline; every other path is judged against
    it. Returns the full verdict dict (strict JSON, deterministic)."""
    if len(paths) < 2:
        raise ValueError("compare needs a baseline and >= 1 candidate")
    runs = [extract_run(p) for p in paths]
    base, cands = runs[0], runs[1:]

    comparisons = []
    any_regression = False
    any_incomparable = False
    for cand in cands:
        mism = _mismatches(base, cand)
        comparable = not mism or allow_mismatch
        metrics: List[Dict[str, Any]] = []
        if comparable:
            # time-to-common-accuracy: elapsed seconds to the highest
            # top-1 BOTH runs reached — the run-vs-run version of the
            # north-star time-to-accuracy metric
            bb = base["metrics"].get("best_acc1")
            cb = cand["metrics"].get("best_acc1")
            ttca_b = ttca_c = None
            if (
                bb is not None and cb is not None
                and base["acc_curve"] and cand["acc_curve"]
            ):
                level = min(float(bb), float(cb))
                ttca_b = _time_to_acc(base["acc_curve"], level)
                ttca_c = _time_to_acc(cand["acc_curve"], level)
            for name, direction, kind in METRIC_SPECS:
                if name == "time_to_common_acc_s":
                    b, c = ttca_b, ttca_c
                else:
                    b = base["metrics"].get(name)
                    c = cand["metrics"].get(name)
                row = _judge(
                    name, direction, kind, b, c,
                    tol_acc_pp=tol_acc_pp, tol_rel=tol_rel,
                    tol_hbm=tol_hbm,
                )
                if row is not None:
                    metrics.append(row)
            # dynamic per-(layer, bucket, impl) device-ms rows from the
            # perf observatory: a single layer can regress while every
            # aggregate above stays flat, so each shared key gets its
            # own lower-is-better relative gate
            bl = base.get("perf_layers") or {}
            cl = cand.get("perf_layers") or {}
            for key in sorted(set(bl) & set(cl)):
                row = _judge(
                    f"perf_ms[{key}]", "lower", "rel",
                    bl[key], cl[key],
                    tol_acc_pp=tol_acc_pp, tol_rel=tol_rel,
                    tol_hbm=tol_hbm,
                )
                if row is not None:
                    metrics.append(row)
        regressed = any(m["verdict"] == "regression" for m in metrics)
        if not comparable:
            verdict = "incomparable"
            any_incomparable = True
        elif regressed:
            verdict = "regression"
            any_regression = True
        elif not metrics:
            # zero shared metrics means zero validation happened — a CI
            # gate must NOT report green for a comparison that compared
            # nothing (e.g. an accuracy artifact against a bench
            # artifact, or a run dir whose events are torn)
            verdict = "no_shared_metrics"
            any_incomparable = True
        else:
            verdict = "pass"
        comparisons.append({
            "source": cand["source"],
            "format": cand["format"],
            "mismatches": mism,
            "metrics": metrics,
            "verdict": verdict,
        })

    overall = (
        "incomparable" if any_incomparable
        else "regression" if any_regression
        else "pass"
    )
    out = {
        "baseline": {
            k: base[k] for k in ("source", "format", "provenance", "metrics")
        },
        "tolerances": {
            "acc_pp": tol_acc_pp,
            "rel": tol_rel,
            "hbm": tol_hbm,
        },
        "comparisons": comparisons,
        "verdict": overall,
    }
    return jsonsafe(out)


def render_comparison(result: Dict[str, Any]) -> str:
    """The human-readable table for one compare_runs() verdict."""
    lines = [f"== Run comparison (baseline: {result['baseline']['source']})"]
    tol = result["tolerances"]
    lines.append(
        f"tolerances: acc {tol['acc_pp']:g}pp  rel {tol['rel']:.0%}  "
        f"hbm {tol['hbm']:.0%}"
    )
    for comp in result["comparisons"]:
        lines.append(f"candidate: {comp['source']}")
        if comp["mismatches"]:
            tag = (
                "compared anyway (--allow-mismatch)"
                if comp["verdict"] != "incomparable"
                else "NOT comparable (pass --allow-mismatch to force)"
            )
            lines.append(f"  !! recipe mismatch — {tag}:")
            for m in comp["mismatches"]:
                lines.append(f"     {m}")
        if comp["metrics"]:
            lines.append(
                f"  {'metric':<22} {'baseline':>12} {'candidate':>12} "
                f"{'delta':>10}  verdict"
            )
            for m in comp["metrics"]:
                mark = {
                    "regression": "REGRESSION",
                    "improvement": "improvement",
                    "ok": "ok",
                }[m["verdict"]]
                lines.append(
                    f"  {m['metric']:<22} {m['baseline']:>12.4g} "
                    f"{m['candidate']:>12.4g} {m['delta']:>+10.4g}  {mark}"
                )
        lines.append(f"  verdict: {comp['verdict'].upper()}")
    lines.append(f"overall verdict: {result['verdict'].upper()}")
    return "\n".join(lines)


__all__ = [
    "METRIC_SPECS",
    "RECIPE_FIELDS",
    "compare_runs",
    "extract_run",
    "render_comparison",
]

"""``watch`` — live status of a running (or finished) run directory; the
port's copy of ``bdbnn_tpu/obs/watch.py``.

``python -m bdbnn_tpu_torch.cli watch RUN_DIR [--interval S] [--once]``
tails ``events.jsonl`` and re-renders a compact status block whenever
the file grows: current epoch/step, last eval accuracy, flip-rate
drift, the input-starvation flag, non-finite incidents, checkpoint
freshness (seconds since the last committed checkpoint — the work a
preemption RIGHT NOW would throw away — plus the run's restart count),
live health alerts (count by detector + seconds since the newest,
obs/health.py), and the final verdict once ``run_end`` lands. Where ``summarize`` is
the post-mortem, ``watch`` is the heartbeat — same files, no torch and
no device, so it can run on a laptop against a job's synced log dir.

Stdlib-only (obs-package rule).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from bdbnn_tpu_torch.obs.events import EVENTS_NAME, read_events
from bdbnn_tpu_torch.obs.manifest import read_manifest
from bdbnn_tpu_torch.obs.summarize import INPUT_BOUND_SHARE


def _mean(vals: List[float]) -> Optional[float]:
    return sum(vals) / len(vals) if vals else None


def _serve_lines(events) -> List[str]:
    """The serving view: when a timeline carries ``serve`` events (a
    ``serve-bench`` run dir) render live queue depth, batch occupancy,
    rolling p99 and shed count; a ``serve-http`` run dir additionally
    gets the front end's readiness state, per-priority queue depths
    and per-tenant shed counters (the ``http``/``admission`` trail);
    ``export`` events on a TRAINING run's timeline get a one-line
    hand-off note."""
    from bdbnn_tpu_torch.obs.events import serve_digest

    digest = serve_digest(events)
    lines: List[str] = []
    for e in digest["exports"]:
        lines.append(
            f"export: {e.get('artifact')} (arch {e.get('arch')}, "
            f"{e.get('binarized_convs')} binary convs, "
            f"{e.get('compression_ratio')}x smaller, recorded acc1 "
            f"{e.get('checkpoint_acc1')})"
        )
    start = digest["start"]
    stats = digest["stats"]
    verdict = digest["verdict"]
    http_start = digest["http_start"]
    http_stats = digest["http_stats"]
    http_drain = digest["http_drain"]
    if start:
        lines.append(
            f"serve: {start.get('mode')} load on {start.get('arch')} | "
            f"buckets {start.get('buckets')} | queue bound "
            f"{start.get('queue_depth')} | {start.get('requests')} requests"
        )
    if http_start:
        lines.append(
            f"http:  {http_start.get('host')}:{http_start.get('port')} "
            f"on {http_start.get('arch')} | "
            f"{http_start.get('priorities')} priority classes x queue "
            f"{http_start.get('queue_depth')} | buckets "
            f"{http_start.get('buckets')}"
            + (
                f" | scenario {http_start.get('scenario')}"
                if http_start.get("scenario")
                else ""
            )
        )
    fleet_start = digest["fleet_start"]
    fleet_stats = digest["fleet_stats"]
    if fleet_start:
        lines.append(
            f"fleet: router {fleet_start.get('host')}:"
            f"{fleet_start.get('port')} over "
            f"{len(fleet_start.get('hosts') or [])} host(s)"
            + (
                f" | scenario {fleet_start.get('scenario')}"
                if fleet_start.get("scenario") else ""
            )
        )
    if fleet_stats and verdict is None:
        # the live per-host health/occupancy table: one row per host —
        # state, in-flight, proxied/completed, retries burned — plus a
        # loud banner for every host the prober has declared dead
        age = time.time() - float(fleet_stats.get("t", time.time()))
        lines.append(
            f"hosts: {fleet_stats.get('hosts_ready')}/"
            f"{fleet_stats.get('hosts_total')} ready | inflight "
            f"{fleet_stats.get('inflight')} | unrouteable "
            f"{fleet_stats.get('unrouteable')} | {age:.0f}s ago"
        )
        lines.append(
            f"  {'id':<4} {'host':<18} {'state':<9} {'infl':>5} "
            f"{'proxied':>8} {'done':>8} {'retries':>8}"
        )
        for label in sorted(fleet_stats.get("hosts") or {}):
            h = (fleet_stats.get("hosts") or {})[label]
            retries = sum((h.get("retries") or {}).values())
            lines.append(
                f"  {label:<4} "
                f"{str(h.get('host')) + ':' + str(h.get('port')):<18} "
                f"{str(h.get('state')):<9} {h.get('inflight'):>5} "
                f"{h.get('proxied'):>8} {h.get('completed'):>8} "
                f"{retries:>8}"
            )
            if h.get("state") == "dead":
                lines.append(
                    f"  !! host {label} DEAD — its traffic is being "
                    "answered by peers (retry ledger above)"
                )
        fswap = fleet_stats.get("swap")
        if fswap and fswap.get("state") in ("replicating", "shifting"):
            lines.append(
                f">> FLEET SWAP {fswap.get('state')}: "
                f"{len(fswap.get('hosts_shifted') or [])}/"
                f"{fswap.get('hosts_total')} hosts shifted "
                "(one at a time — dispatch never loses two hosts)"
            )
        frt = fleet_stats.get("rtrace")
        if frt:
            # the live cross-host waterfall: the router's own stage
            # windows (probe_wait/pick/connect/retry_hop/network) plus
            # the stitched backend decomposition, WHILE it happens
            parts = [
                f"{stage} {ms:.1f}"
                for stage, ms in (frt.get("stage_p99_ms") or {}).items()
                if ms is not None
            ]
            share = frt.get("retry_hop_share")
            lines.append(
                "trace: fleet p99/stage ms  " + " > ".join(parts)
                + (
                    f" | retry-hop share {share:.1%}"
                    if share is not None else ""
                )
                + f" | stitched {frt.get('stitched')}"
                + f"/{frt.get('requests')}"
            )
            bparts = [
                f"{stage} {ms:.1f}"
                for stage, ms in (
                    frt.get("backend_stage_p99_ms") or {}
                ).items()
                if ms is not None
            ]
            if bparts:
                lines.append(
                    "       backend p99/stage ms  " + " > ".join(bparts)
                )
        fwin = fleet_stats.get("host_windows")
        if fwin and fwin.get("hosts"):
            # the scraped per-host stage table — a host whose /statsz
            # stopped answering is marked STALE (its window is frozen
            # and excluded from the merged view), never rendered as
            # live data
            lines.append(
                f"scrape: {fwin.get('hosts_fresh')} fresh / "
                f"{fwin.get('hosts_stale')} stale host window(s)"
            )
            for label in sorted(fwin.get("hosts") or {}):
                hw = (fwin.get("hosts") or {})[label]
                parts = [
                    f"{stage} {ms:.1f}"
                    for stage, ms in (
                        hw.get("stage_p99_ms") or {}
                    ).items()
                    if ms is not None
                ]
                lines.append(
                    f"  {label:<4} "
                    + (
                        "STALE "
                        f"({hw.get('fail_streak')} failed scrape(s))"
                        if hw.get("stale")
                        else " > ".join(parts) if parts
                        else "no samples yet"
                    )
                )
        fcap = fleet_stats.get("capacity")
        if fcap and fcap.get("hosts"):
            # the fleet-merged capacity view: summed demand/headroom
            # over FRESH hosts, worst burn rate across the fleet
            merged = fcap.get("merged") or {}
            lines.append(
                f"capacity: fleet offered {merged.get('offered_rps')} "
                f"rps | headroom {merged.get('headroom_rps')} rps | "
                f"burn max {merged.get('burn_rate_max')} "
                f"({fcap.get('hosts_fresh')} fresh / "
                f"{fcap.get('hosts_stale')} stale)"
            )
    if digest["fleet_drain"] and verdict is None:
        lines.append(
            f"!! fleet draining (signal "
            f"{digest['fleet_drain'].get('signum')}) — in-flight "
            "proxies finishing, router readyz is 503"
        )
    replica_stats = digest["replica_stats"]
    swap_last = digest["swap_last"]
    if replica_stats and verdict is None:
        # the live per-replica table: one row per replica — version,
        # health state, queue depth, completed — plus the
        # completed-by-version ledger once a swap has split it
        lines.append(
            f"replicas ({replica_stats.get('version')}): "
            f"{replica_stats.get('completed')} done | "
            f"{replica_stats.get('restarts')} restart(s)"
        )
        lines.append(
            f"  {'id':<4} {'device':<14} {'version':<10} {'state':<10} "
            f"{'queue':>5} {'done':>8}"
        )
        for r in replica_stats.get("replicas") or []:
            lines.append(
                f"  {r.get('replica'):<4} {str(r.get('device')):<14} "
                f"{str(r.get('version')):<10} {str(r.get('state')):<10} "
                f"{r.get('queue_depth'):>5} {r.get('completed'):>8}"
            )
        by_version = replica_stats.get("completed_by_version") or {}
        if len(by_version) > 1:
            lines.append(
                "  answered by: "
                + "  ".join(
                    f"{v}: {n}" for v, n in sorted(by_version.items())
                )
            )
    if swap_last and verdict is None:
        phase = swap_last.get("phase")
        if phase == "trigger" and swap_last.get("status") not in (
            None, 202,
        ):
            # a rejected scheduled trigger (400/404/409) is TERMINAL
            # for THIS trigger — no start/failed event ever follows it,
            # so an in-progress banner here would stick for the rest of
            # the run. But a 409 can mean a swap is ALREADY in flight
            # (operator-initiated), so only the other statuses may
            # claim no rollout is running.
            status = swap_last.get("status")
            tail = (
                "this trigger started nothing (another rollout "
                "may be mid-flight)"
                if status == 409 else "no rollout is running"
            )
            lines.append(
                f"!! swap trigger REJECTED (HTTP {status}): "
                f"{swap_last.get('error')} — {tail}"
            )
        elif phase in ("trigger", "start", "warm", "shift"):
            progress = ""
            swap_state = (replica_stats or {}).get("swap") or {}
            if swap_state.get("replicas_total"):
                progress = (
                    f" [{swap_state.get('replicas_shifted', 0)}/"
                    f"{swap_state.get('replicas_total')} shifted]"
                )
            lines.append(
                f">> SWAP in progress: "
                f"{swap_last.get('version_from') or '...'} -> "
                f"{swap_last.get('version_to')}{progress} "
                f"(phase {phase}) — traffic keeps flowing"
            )
        elif phase == "done":
            lines.append(
                f"swap: {swap_last.get('version_from')} -> "
                f"{swap_last.get('version_to')} DONE in "
                f"{swap_last.get('seconds')}s "
                f"({swap_last.get('replicas_shifted')} replicas)"
            )
        elif phase == "failed":
            lines.append(
                f"!! swap to {swap_last.get('version_to')} FAILED "
                f"({swap_last.get('error')}) — old version kept serving"
            )
        elif phase == "rolled_back":
            lines.append(
                f"!! CANARY ROLLBACK: {swap_last.get('version_to')} "
                f"rejected (trigger {swap_last.get('trigger')}) in "
                f"{swap_last.get('seconds')}s — "
                f"{swap_last.get('version_from')} kept serving, "
                "registry untouched"
            )
    canary_last = digest["canary_last"]
    canary_eval = digest["canary_last_evaluate"]
    if canary_last and verdict is None:
        phase = canary_last.get("phase")
        if phase in ("start", "observing", "evaluate", "decision"):
            # the live canary banner: fraction + windows from the
            # newest evaluate tick, one status mark per detector
            ev = canary_eval or {}
            dets = ev.get("detectors") or {}
            marks = []
            for name in sorted(dets):
                d = dets[name] or {}
                if d.get("fired"):
                    marks.append(f"{name}:FIRED")
                elif d.get("breach"):
                    marks.append(f"{name}:breach")
                elif not d.get("eligible"):
                    marks.append(f"{name}:warming")
                else:
                    marks.append(f"{name}:ok")
            start = next(
                (
                    e for e in digest["canary_events"]
                    if e.get("phase") == "start"
                ),
                {},
            )
            lines.append(
                f">> CANARY {start.get('version_from')} -> "
                f"{start.get('version_to')}: observing | fraction "
                f"{start.get('fraction')} | replicas "
                f"{start.get('replicas_canary')} | eval "
                f"#{ev.get('evaluation', 0)} | served canary "
                f"{ev.get('canary_served', 0)} / incumbent "
                f"{ev.get('incumbent_served', 0)}"
            )
            if marks:
                lines.append("   detectors: " + "  ".join(marks))
        elif phase == "rollback":
            lines.append(
                f"!! CANARY ROLLBACK in progress: replica "
                f"{canary_last.get('replica')} restoring "
                f"{canary_last.get('version_restored')}"
            )
        elif phase == "promote":
            lines.append(
                f"canary: {canary_last.get('version_from')} -> "
                f"{canary_last.get('version_to')} PROMOTED in "
                f"{canary_last.get('seconds')}s "
                f"({canary_last.get('evaluations')} evaluations)"
            )
    if http_stats and verdict is None:
        s = http_stats[-1]
        age = time.time() - float(s.get("t", time.time()))
        state = s.get("state")
        mark = {"ready": "READY", "warming": "WARMING",
                "draining": "DRAINING"}.get(state, str(state))
        lines.append(
            f"state: {mark} | inflight {s.get('inflight')} | "
            f"queues/prio {s.get('queue_depth_by_priority')} | "
            f"done/prio {s.get('completed_by_priority')} | "
            f"shed/prio {s.get('shed_by_priority')} | {age:.0f}s ago"
        )
        tenants = s.get("tenants") or {}
        if tenants:
            lines.append(
                "tenants: "
                + "  ".join(
                    f"{t}: {c.get('admitted')} ok / "
                    f"{c.get('over_quota')} over-quota / "
                    f"{c.get('shed')} shed"
                    for t, c in sorted(tenants.items())
                )
            )
    if http_drain and verdict is None:
        lines.append(
            f"!! draining (signal {http_drain.get('signum')}) — "
            "accepted requests finishing, readyz is 503"
        )
    if stats and verdict is None:
        s = stats[-1]
        age = time.time() - float(s.get("t", time.time()))
        occ = float(s.get("occupancy") or 0.0)
        lines.append(
            f"live:  queue {s.get('queue_depth')} | occupancy "
            f"{occ:.0%} | rolling p99 {s.get('rolling_p99_ms')} ms | "
            f"shed {s.get('shed')} | {s.get('completed')} done | "
            f"{age:.0f}s ago"
        )
    rtrace = digest["rtrace_stats"]
    if rtrace and verdict is None:
        # the live waterfall: per-stage p99 over the rolling windows —
        # queue-bound vs device-bound, WHILE it happens
        stage_p99 = rtrace.get("stage_p99_ms") or {}
        parts = [
            f"{stage} {ms:.1f}"
            for stage, ms in stage_p99.items()
            if ms is not None
        ]
        share = rtrace.get("queue_share")
        lines.append(
            "trace: p99/stage ms  " + " > ".join(parts)
            + (
                f" | queue share {share:.0%}"
                if share is not None else ""
            )
        )
    cap_stats = digest["capacity_stats"]
    if cap_stats and verdict is None:
        # the live capacity gauges (obs/capacity.py heartbeat): demand
        # rate, in-flight, headroom estimate and the worst burn rate —
        # WHILE the run serves
        hr = cap_stats.get("headroom") or {}
        burns = [
            b
            for row in (cap_stats.get("detectors") or {}).values()
            for b in (row.get("burn_rate_fast"),
                      row.get("burn_rate_slow"))
            if b is not None
        ]
        lines.append(
            f"capacity: offered {cap_stats.get('offered_rps')} rps | "
            f"in-flight {cap_stats.get('in_flight')}"
            + (
                f" | headroom {hr.get('headroom_rps')} rps"
                if hr.get("headroom_rps") is not None else ""
            )
            + (f" | burn max {max(burns)}" if burns else "")
        )
        latched = sorted(
            name
            for name, row in (cap_stats.get("detectors") or {}).items()
            if row.get("latched")
        )
        if latched:
            lines.append(
                "!! SLO BUDGET BURNING: " + ", ".join(latched)
            )
    if verdict:
        shed_rate = float(verdict.get("shed_rate") or 0.0)
        lines.append(
            f"SLO:   p50 {verdict.get('p50_ms')} / p95 "
            f"{verdict.get('p95_ms')} / p99 {verdict.get('p99_ms')} ms | "
            f"{verdict.get('throughput_rps')} req/s | occupancy "
            f"{verdict.get('mean_batch_occupancy')} | shed "
            f"{shed_rate:.1%}"
            + (" | PREEMPTED, drained" if verdict.get("preempted") else "")
        )
        per_priority = verdict.get("per_priority") or {}
        for p in sorted(per_priority, key=int):
            v = per_priority[p]
            lines.append(
                f"  p{p}: p99 {v.get('p99_ms')} ms | "
                f"{v.get('completed')}/{v.get('submitted')} ok | "
                f"shed {v.get('shed')}"
            )
        fr = verdict.get("fairness_ratio")
        if fr is not None:
            lines.append(f"  fairness: max/min tenant service {fr}")
        replicas = verdict.get("replicas")
        if replicas:
            lines.append(
                f"  replicas: {replicas.get('n')} on "
                f"{replicas.get('version')} | "
                f"{replicas.get('restarts')} restart(s) | shares "
                + " ".join(
                    f"r{r.get('replica')}:{r.get('share'):.0%}"
                    for r in replicas.get("per_replica") or []
                )
            )
        scaling = verdict.get("scaling")
        if scaling:
            lines.append(
                "  scaling: "
                + " -> ".join(
                    f"{n}x {scaling['throughput_rps'].get(str(n))}rps"
                    for n in scaling.get("replicas") or []
                )
                + f" | efficiency {scaling.get('efficiency')}"
                + ("" if scaling.get("monotone") else " | NOT MONOTONE")
            )
        swap = verdict.get("swap")
        if swap:
            lines.append(
                f"  swap: {swap.get('version_from')} -> "
                f"{swap.get('version_to')} "
                + ("DONE" if swap.get("performed")
                   else f"{swap.get('state')}")
                + f" | shed {swap.get('shed')} | answered by "
                + "  ".join(
                    f"{v}: {n}"
                    for v, n in sorted(
                        (swap.get("answered_by") or {}).items()
                    )
                )
            )
        can = verdict.get("canary")
        if can:
            decision = can.get("decision")
            shadow = can.get("shadow") or {}
            lines.append(
                f"  canary: fraction {can.get('fraction')} | "
                + (
                    f"ROLLED BACK (trigger {can.get('trigger')})"
                    if decision == "rollback"
                    else f"promoted in {can.get('promote_s')}s"
                    if decision == "promote"
                    else str(decision)
                )
                + f" after {can.get('evaluations')} evaluation(s) | "
                f"shadow drift "
                f"{shadow.get('max_abs_drift')} over "
                f"{shadow.get('compared')} mirror(s)"
            )
            fired = [
                name
                for name, d in sorted(
                    (can.get("detectors") or {}).items()
                )
                if (d or {}).get("fired")
            ]
            if fired:
                lines.append(
                    "    fired detectors: " + ", ".join(fired)
                )
        fleet = verdict.get("fleet")
        if fleet:
            lines.append(
                f"  fleet: {fleet.get('n_hosts')} host(s) | "
                f"{fleet.get('completed_total')} completed | "
                f"{fleet.get('retries_total')} retries "
                f"(rate {fleet.get('retry_rate')}) | p99 spread "
                f"{fleet.get('host_p99_spread')} | dropped "
                f"{fleet.get('dropped')} | ledger "
                + (
                    "CONSISTENT"
                    if fleet.get("ledger_consistent")
                    else "TORN" if fleet.get("ledger_consistent") is False
                    else "unchecked"
                )
            )
            for label in sorted(fleet.get("hosts") or {}):
                h = (fleet.get("hosts") or {})[label]
                lines.append(
                    f"    {label} [{h.get('state')}]: "
                    f"{h.get('completed')} done / "
                    f"{h.get('proxied')} proxied | p99 "
                    f"{h.get('p99_ms')} ms | retried away "
                    f"{h.get('retried_away')}"
                )
        fa = verdict.get("fleet_attribution")
        if fa:
            # the final cross-host waterfall: router stages + network
            # + the stitched backend block, the retry-hop share and
            # the cross-hop reconciliation disposition
            stage_parts = [
                f"{stage} {b['p99_ms']:.1f}"
                for stage, b in (fa.get("stages") or {}).items()
                if b is not None and b.get("p99_ms") is not None
            ]
            share = fa.get("retry_hop_share")
            recon = fa.get("reconciliation") or {}
            lines.append(
                "  fleet trace: p99/stage ms  " + " > ".join(stage_parts)
                + (
                    f" | retry-hop share {share:.1%}"
                    if share is not None else ""
                )
                + (
                    f" | stage spread {fa.get('host_stage_spread_max')}"
                    if fa.get("host_stage_spread_max") is not None
                    else ""
                )
                + (
                    "" if recon.get("ok") in (True, None)
                    else " | CROSS-HOP RECONCILIATION BROKEN"
                )
            )
            bparts = [
                f"{stage} {b['p99_ms']:.1f}"
                for stage, b in (fa.get("backend_stages") or {}).items()
                if b is not None and b.get("p99_ms") is not None
            ]
            if bparts:
                lines.append(
                    "    backend p99/stage ms  " + " > ".join(bparts)
                )
            for p, wfs in sorted((fa.get("tail") or {}).items()):
                if not wfs:
                    continue
                wf = wfs[0]  # the slowest cross-host exemplar
                waterfall = " + ".join(
                    f"{stage} {ms:.1f}"
                    for stage, ms in (wf.get("stages") or {}).items()
                )
                lines.append(
                    f"    slowest p{p}: {wf.get('trace')} on "
                    f"{wf.get('host')} ({wf.get('attempts')} "
                    f"attempt(s)) {wf.get('total_ms')}ms = {waterfall}"
                    f" | slowest stage {wf.get('slowest_stage')}"
                )
        att = verdict.get("attribution")
        if att:
            # the final waterfall: where the p99 went, stage by stage,
            # plus the slowest request's full decomposition
            stage_parts = [
                f"{stage} {b['p99_ms']:.1f}"
                for stage, b in (att.get("stages") or {}).items()
                if b is not None and b.get("p99_ms") is not None
            ]
            share = att.get("queue_share")
            recon = att.get("reconciliation") or {}
            lines.append(
                "  trace: p99/stage ms  " + " > ".join(stage_parts)
                + (
                    f" | queue share {share:.0%}"
                    if share is not None else ""
                )
                + (
                    "" if recon.get("ok") in (True, None)
                    else " | RECONCILIATION BROKEN"
                )
            )
            for p, wfs in sorted((att.get("tail") or {}).items()):
                if not wfs:
                    continue
                wf = wfs[0]  # the slowest exemplar of this class
                waterfall = " + ".join(
                    f"{stage} {ms:.1f}"
                    for stage, ms in (wf.get("stages") or {}).items()
                )
                lines.append(
                    f"    slowest p{p}: #{wf.get('seq')} "
                    f"{wf.get('total_ms')}ms = {waterfall}"
                )
        cap = verdict.get("capacity")
        if cap:
            # the v8 capacity disposition: the three compare gates plus
            # the budget's burn episodes
            lines.append(
                f"  capacity: burn max {cap.get('burn_rate_max')} | "
                f"headroom {cap.get('headroom_rps')} rps | worst shed "
                f"ratio {cap.get('demand_shed_ratio_max')}"
            )
            budget = cap.get("slo_budget") or {}
            for ep in budget.get("episodes") or []:
                t_end = ep.get("t_end")
                lines.append(
                    f"    burn episode: {ep.get('detector')} peak "
                    f"{ep.get('peak_burn_rate')}"
                    + (
                        f" ({t_end - ep.get('t_start'):.1f}s)"
                        if t_end is not None else " (still open)"
                    )
                )
    return lines


def _perf_lines(events) -> List[str]:
    """The perf-observatory view: when a timeline carries ``perf``
    events (a ``perf`` run dir, obs/roofline.py) render the sweep
    header, one line per measured (impl, bucket) cell as it lands,
    and the roofline summary once the verdict event arrives."""
    perf = [e for e in events if e.get("kind") == "perf"]
    if not perf:
        return []
    lines: List[str] = []
    start = next((e for e in perf if e.get("phase") == "start"), None)
    verdict_ev = next(
        (e for e in reversed(perf) if e.get("phase") == "verdict"), None
    )
    if start:
        lines.append(
            f"perf: roofline sweep on {start.get('arch')} | buckets "
            f"{start.get('buckets')} x impls {start.get('impls')} | "
            f"{start.get('iters')} iters on {start.get('device_kind')}"
        )
    if verdict_ev is None:
        for e in perf:
            if e.get("phase") != "bucket":
                continue
            recon = e.get("reconciled")
            mark = (
                "reconciled" if recon
                else "RECONCILIATION BROKEN" if recon is False
                else "unreconciled"
            )
            lines.append(
                f"  {e.get('impl')} b{e.get('bucket')}: "
                f"{e.get('wall_ms')} ms/step (attributed "
                f"{e.get('attributed_ms')} ms, {mark})"
            )
        return lines
    v = verdict_ev.get("verdict") or {}
    s = v.get("summary") or {}
    lines.append(
        f"  VERDICT: best {s.get('step_ms_best')} ms/step @ b"
        f"{s.get('bucket')} | dense {s.get('step_ms_dense')} / packed "
        f"{s.get('step_ms_packed')} ms | roof efficiency "
        f"{s.get('efficiency_mean')} | attributed "
        f"{s.get('attributed_share')} | mfu {s.get('mfu_best')}"
    )
    for skip in v.get("skipped") or []:
        lines.append(
            f"  skipped {skip.get('impl')}: {skip.get('reason')}"
        )
    return lines


def _search_lines(events) -> List[str]:
    """The recipe-search view: when a timeline carries ``search``/
    ``trial`` events (a sweep dir of the recipe search) render the live
    trial states and the current best; at the verdict, the final
    leaderboard summary."""
    from bdbnn_tpu_torch.obs.events import search_digest

    digest = search_digest(events)
    start = digest["start"]
    if start is None and digest["verdict"] is None:
        return []
    lines: List[str] = []
    if start:
        lines.append(
            f"search: {start.get('trials_total')} trial(s) over "
            f"{len(start.get('families') or [])} famil"
            f"{'y' if len(start.get('families') or []) == 1 else 'ies'}"
            f" | {start.get('workers')} worker(s)"
            + (
                " | resumed sweep"
                if start.get("phase") == "resume"
                else ""
            )
        )
    verdict = digest["verdict"]
    if verdict is not None:
        winner = verdict.get("winner") or {}
        lines.append(
            f"  VERDICT: {verdict.get('completed')}/"
            f"{verdict.get('trials_total')} completed, "
            f"{verdict.get('failed')} failed | winner "
            f"{winner.get('trial')} ({winner.get('family')} @ lr "
            f"{winner.get('lr')}) best {winner.get('best_top1')}"
        )
        return lines
    # live: latest phase per trial + the running best
    for tid in sorted(digest["trial_latest"]):
        ev = digest["trial_latest"][tid]
        phase = ev.get("phase")
        mark = {
            "done": "done",
            "failed": "FAILED",
            "preempted": "preempted",
            "interrupted": "interrupted",
        }.get(phase, "running")
        extra = (
            f" best {ev.get('best_top1')}" if phase == "done" else ""
        )
        lines.append(
            f"  {tid}: {mark} ({ev.get('family')} @ lr "
            f"{ev.get('lr')}){extra}"
        )
    best = digest["best_done"]
    if best:
        lines.append(
            f"  best so far: {best.get('trial')} best_top1 "
            f"{best.get('best_top1')}"
        )
    if digest["preempted"]:
        lines.append(
            f"  !! sweep preempted (signal "
            f"{digest['preempted'].get('signum')}) — "
            f"{digest['preempted'].get('completed')} trial(s) done; "
            "resume with `search --resume`"
        )
    return lines


def render_status(
    events: List[Dict[str, Any]],
    manifest: Optional[Dict[str, Any]] = None,
) -> str:
    """The status block for one snapshot of a run's event timeline
    (``manifest`` adds the restart count when available)."""
    if not events:
        return "(no events yet)"
    start = next((e for e in events if e.get("kind") == "run_start"), None)
    intervals = [e for e in events if e.get("kind") == "train_interval"]
    evals = [e for e in events if e.get("kind") == "eval"]
    nonfinite = [e for e in events if e.get("kind") == "nonfinite"]
    end = next((e for e in events if e.get("kind") == "run_end"), None)
    memory = [e for e in events if e.get("kind") == "memory"]
    alerts = [e for e in events if e.get("kind") == "alert"]
    ckpts = [e for e in events if e.get("kind") == "checkpoint"]
    preempts = [e for e in events if e.get("kind") == "preempt"]
    restores = [e for e in events if e.get("kind") == "restore"]
    data_errors = [e for e in events if e.get("kind") == "data_error"]
    restarts = len((manifest or {}).get("restart_lineage") or [])

    lines = []
    lines += _search_lines(events)
    lines += _perf_lines(events)
    lines += _serve_lines(events)
    if start:
        lines.append(
            f"run: epochs {start.get('start_epoch', 0)}->"
            f"{start.get('epochs')} | {start.get('steps_per_epoch')} "
            f"steps/epoch | config {start.get('config_hash', '?')}"
            + (f" | restart #{restarts}" if restarts else "")
        )
    # elastic-resume lineage: a resharded restore is the one resume
    # variant worth calling out live (the run now executes on a
    # different topology than wrote its checkpoint)
    resharded = next(
        (r for r in reversed(restores) if r.get("resharded")), None
    )
    if resharded:
        tf = resharded.get("topology_from") or {}
        tt = resharded.get("topology_to") or {}
        lines.append(
            "elastic: resumed "
            f"{tf.get('processes')}p x {tf.get('devices')}d -> "
            f"{tt.get('processes')}p x {tt.get('devices')}d "
            "(checkpoint resharded onto this mesh)"
        )
    last = intervals[-1] if intervals else None
    if last:
        age = time.time() - float(last.get("t", time.time()))
        share = float(last.get("data_wait_share", 0.0) or 0.0)
        starved = " [INPUT-BOUND]" if share > INPUT_BOUND_SHARE else ""
        lines.append(
            f"train: epoch {last.get('epoch')} step {last.get('step')} | "
            f"loss {last.get('loss')} | top1 {last.get('top1')} | "
            f"{last.get('img_per_s')} img/s | data-wait "
            f"{share:.0%}{starved} | {age:.0f}s ago"
        )
    if evals:
        ev = evals[-1]
        best = max(evals, key=lambda e: float(e.get("acc1", 0.0) or 0.0))
        lines.append(
            f"eval:  epoch {ev.get('epoch')} acc1 {ev.get('acc1')} "
            f"(best {best.get('acc1')} @ epoch {best.get('epoch')})"
        )
    # flip-rate drift: mean over layers, first interval vs newest — the
    # live view of "are binarized weights settling or still churning?"
    flips_first = _mean(
        [v for v in (intervals[0].get("flip_rate") or {}).values()
         if v is not None]
    ) if intervals else None
    flips_last = _mean(
        [v for v in (last.get("flip_rate") or {}).values() if v is not None]
    ) if last else None
    if flips_first is not None and flips_last is not None:
        lines.append(
            f"flips: mean rate {flips_first:.2e} -> {flips_last:.2e}"
            + (" (settling)" if flips_last < flips_first else " (churning)")
        )
    if memory:
        peaks = [e.get("peak_bytes") for e in memory if e.get("peak_bytes")]
        if peaks:
            lines.append(f"hbm:   peak {max(peaks) / 2**30:.2f} GiB")
    # checkpoint freshness: the at-a-glance answer to "is this run
    # preemption-safe right now, and how much work would a kill cost?"
    if ckpts:
        c = ckpts[-1]
        if end is not None:
            age_txt = "final"
        else:
            age_txt = f"{time.time() - float(c.get('t', 0.0)):.0f}s ago"
        lines.append(
            f"ckpt:  last saved {age_txt} (reason {c.get('reason')}, "
            f"epoch {c.get('epoch')} step {c.get('step_in_epoch')}, "
            f"{len(ckpts)} total)"
        )
    elif start and end is None:
        lines.append("ckpt:  NONE yet — a preemption now loses everything")
    # live health: alert counts by detector + freshness of the newest
    # one, right next to the checkpoint-age readout it complements
    if alerts:
        by: Dict[str, int] = {}
        for a in alerts:
            det = str(a.get("detector", "?"))
            by[det] = by.get(det, 0) + 1
        last_alert = alerts[-1]
        if end is not None:
            age_txt = "final"
        else:
            age_txt = (
                f"{time.time() - float(last_alert.get('t', 0.0)):.0f}s ago"
            )
        lines.append(
            f"!! alerts: {len(alerts)} ("
            + ", ".join(f"{k} x{v}" for k, v in sorted(by.items()))
            + f") | last {age_txt} [{last_alert.get('severity')} "
            f"{last_alert.get('detector')}]"
        )
    if preempts:
        p = preempts[-1]
        lines.append(
            f"!! preempted (signal {p.get('signum')}"
            + (", coordinated pod-wide" if p.get("coordinated") else "")
            + f") at epoch {p.get('epoch')} step "
            f"{p.get('step_in_epoch')} — resume with --resume"
        )
    if data_errors:
        lines.append(f"!! corrupt samples substituted: {len(data_errors)}")
    if nonfinite:
        lines.append(f"!! non-finite incidents: {len(nonfinite)}")
    if end:
        lines.append(
            f"DONE: best acc1 {end.get('best_acc1')} @ epoch "
            f"{end.get('best_epoch')} in {end.get('wall_s')}s"
        )
    return "\n".join(lines)


def watch_run(
    run_dir: str,
    *,
    interval: float = 2.0,
    once: bool = False,
    out=print,
) -> int:
    """Tail ``run_dir/events.jsonl``; re-render on growth; return once
    ``run_end`` is seen (or immediately with ``once``)."""
    path = os.path.join(run_dir, EVENTS_NAME)
    last_size = -1
    while True:
        manifest = read_manifest(run_dir)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size != last_size:
            last_size = size
            events = read_events(run_dir)
            out(render_status(events, manifest))
            # a serve-bench run ends at its verdict, a search sweep at
            # its leaderboard verdict, a perf sweep at its roofline
            # verdict, a training run at run_end — any of them
            # terminates the tail
            if once or any(
                e.get("kind") == "run_end"
                or (e.get("kind") == "serve" and e.get("phase") == "verdict")
                or (
                    e.get("kind") == "search"
                    and e.get("phase") == "verdict"
                )
                or (
                    e.get("kind") == "perf"
                    and e.get("phase") == "verdict"
                )
                for e in events
            ):
                return 0
            out("---")
        elif once:
            out(render_status(read_events(run_dir), manifest))
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0

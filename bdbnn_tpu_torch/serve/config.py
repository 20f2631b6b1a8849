"""Typed configuration of the ``serve-bench``, ``serve-http``,
``serve-fleet`` and ``perf`` CLIs — the port's copies of
``ServeBenchConfig``, ``ServeHttpConfig``, ``ServeFleetConfig`` and
``PerfConfig`` in ``bdbnn_tpu/configs/config.py``: the reference's fields,
defaults and ``validate()``, plus ``device`` on the three that hold
engines (the card unless the caller asks for the CPU; there is no
fallback)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ServeBenchConfig:
    """Typed configuration of the ``serve-bench`` CLI (serve/loadgen.py).

    Mirrors RunConfig's resolve-once contract: everything the serving
    stack needs — engine buckets, batcher bounds, load model — is
    validated here before any backend or thread exists, so a bad knob
    fails at the command line, not mid-benchmark.
    """

    artifact: str  # export artifact dir (serve/export.py)
    log_path: str = "serve_log"  # run dirs (manifest + serve events) land here
    # load model: "open" = Poisson arrivals at `rate` req/s (offered
    # load independent of completions — the production shape, exercises
    # shedding); "closed" = `concurrency` workers, one request in
    # flight each (sustainable-throughput probe)
    mode: str = "open"
    rate: float = 100.0
    requests: int = 200
    concurrency: int = 4
    # engine batch-size buckets, each run once at startup (warmup); the
    # largest is also the micro-batcher's coalescing target
    buckets: Tuple[int, ...] = (1, 8, 32)
    # bounded request queue: beyond this, submits are shed (explicit
    # rejection), never queued without bound
    queue_depth: int = 128
    # coalescing deadline: a batch never waits past this from its first
    # request's enqueue
    max_delay_ms: float = 5.0
    seed: int = 0
    out: str = ""  # also write the SLO verdict JSON here
    events_max_mb: float = 256.0
    # replica pool (serve/pool.py): one warmed engine per CUDA card
    # behind the front batcher's async dispatch. More than one
    # value = a scaling sweep: the bench runs once per N and the
    # verdict gains the `scaling` block (throughput per N + the
    # efficiency-at-max ratio `compare` judges).
    replicas: Tuple[int, ...] = (1,)
    # fabric mode: replace each replica's engine with a fixed
    # pace_ms-per-batch sleep (nothing loads) — with fewer cards than
    # replicas, or on the CPU, compute-bound throughput cannot scale
    # with N regardless of the dispatcher; pacing measures what the
    # POOL adds. 0 = real engines.
    pace_ms: float = 0.0
    # per-replica bounded queue, in BATCHES (the front batcher already
    # bounds per-request queues; this bounds the dispatch fan-out)
    replica_queue_batches: int = 8
    # a replica busy on one batch longer than this is declared wedged:
    # unhealthy -> routed around -> queued work re-dispatched -> worker
    # restarted (serve/pool.py health monitor)
    wedge_timeout_s: float = 30.0
    # weight residency (nn/packed.py): "off" = dense reconstructed
    # weights on device (the classic path); "on" = binary convs stay
    # 1-bit resident and each forward unpacks transiently (K3);
    # "ab" = run the SAME load dense-then-packed and record the memory
    # squeeze + honest step-time delta in the verdict's `packed` block
    # (single-engine path only — a pooled A/B would conflate dispatch
    # effects with residency effects)
    packed_weights: str = "off"
    # how the packed forward runs: "unpack" (K3 decode -> K2 -> K1, the
    # default) or "popcount" (the XNOR-popcount conv, K4; f32 artifacts
    # only)
    packed_impl: str = "unpack"
    # request-path tracing (obs/rtrace.py): per-request lifecycle
    # spans (queue/coalesce/dispatch/compute) rolled into the v4
    # verdict's attribution block. sample_every picks which FULL
    # waterfalls are emitted as rtrace events (deterministic seeded
    # sampling; 1 = every request); the slowest rtrace_tail_k
    # requests per priority are kept regardless. rtrace=False turns
    # the recorder off entirely (attribution lands null).
    rtrace: bool = True
    rtrace_sample_every: int = 16
    rtrace_tail_k: int = 5
    # torch device of the engines: None = the CUDA card (raises without
    # one); "cpu" runs the kernels' plain versions
    device: Optional[str] = None

    def validate(self) -> "ServeBenchConfig":
        if not self.artifact:
            raise ValueError("serve-bench needs an export artifact dir")
        if self.mode not in ("open", "closed"):
            raise ValueError(f"unknown load mode {self.mode!r} (open|closed)")
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(
                f"--buckets must be positive ints, got {self.buckets!r}"
            )
        if self.queue_depth <= 0:
            raise ValueError("--queue-depth must be >= 1 (the bound IS the "
                             "shedding point)")
        if self.requests <= 0 or self.concurrency <= 0:
            raise ValueError("--requests and --concurrency must be positive")
        if self.mode == "open" and self.rate <= 0:
            raise ValueError("open-loop mode needs --rate > 0 (req/s)")
        if self.max_delay_ms < 0:
            raise ValueError("--max-delay-ms must be >= 0")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0")
        if not self.replicas or any(int(n) <= 0 for n in self.replicas):
            raise ValueError(
                f"--replicas must be positive ints, got {self.replicas!r}"
            )
        if self.pace_ms < 0:
            raise ValueError("--pace-ms must be >= 0 (0 = real engines)")
        if self.replica_queue_batches <= 0:
            raise ValueError("--replica-queue-batches must be >= 1")
        if self.wedge_timeout_s <= 0:
            raise ValueError("--wedge-timeout-s must be > 0")
        if self.packed_weights not in ("off", "on", "ab"):
            raise ValueError(
                f"--packed-weights must be off|on|ab, got "
                f"{self.packed_weights!r}"
            )
        if self.packed_impl not in ("unpack", "popcount"):
            raise ValueError(
                f"--packed-impl must be unpack|popcount, got "
                f"{self.packed_impl!r}"
            )
        if self.packed_weights == "ab" and (
            tuple(self.replicas) != (1,) or self.pace_ms > 0
        ):
            raise ValueError(
                "--packed-weights ab runs the single-engine path twice "
                "(dense then packed); it cannot combine with --replicas "
                "> 1 or --pace-ms — a pooled/paced A/B would conflate "
                "dispatch effects with residency effects"
            )
        if self.rtrace_sample_every < 1:
            raise ValueError(
                "--rtrace-sample-every must be >= 1 (1 = every "
                "request; use --no-rtrace to disable tracing)"
            )
        if self.rtrace_tail_k < 0:
            raise ValueError("--rtrace-tail-k must be >= 0")
        return self


@dataclasses.dataclass(frozen=True)
class ServeHttpConfig:
    """Typed configuration of the ``serve-http`` CLI (serve/http.py).

    Same resolve-once contract as ServeBenchConfig: every knob of the
    network front end — bind address, priority classes, per-class
    queue bound, tenant quotas, and (in bench mode) the traffic
    scenario — is validated before any socket or device exists.

    The rollout knobs (``swap_to``, ``swap_at``, ``canary_fraction``,
    ``canary_replicas``, ``shadow_every``, ``canary_thresholds``) keep
    the reference's names, defaults and range checks, with one
    departure: a swap under load (``--swap-at``) runs on one replica,
    since one card holds one replica; the batches assembled while it
    shifts are shed, and the verdict's ``swap`` block counts them. A
    canary still needs two replicas.
    """

    artifact: str  # export artifact dir (serve/export.py)
    log_path: str = "serve_http_log"
    host: str = "127.0.0.1"
    port: int = 0  # 0 = kernel-assigned ephemeral port
    # priority classes (0 = most important). Each class gets its OWN
    # bounded queue of queue_depth slots; the batcher dequeues strict-
    # priority (serve/batching.py)
    priorities: int = 3
    buckets: Tuple[int, ...] = (1, 8, 32)
    queue_depth: int = 64  # per priority class
    max_delay_ms: float = 5.0
    # admission control (serve/admission.py): token-bucket quota every
    # tenant gets unless overridden — "RATE[:BURST]" in requests/s
    default_quota: str = "100:200"
    tenant_quotas: Tuple[str, ...] = ()  # "TENANT=RATE[:BURST]" each
    # bench mode: "" = serve until SIGTERM; otherwise one of the
    # loadgen scenarios (poisson | diurnal | flash_crowd | heavy_tail |
    # slow_client) driven over real sockets against this server
    scenario: str = ""
    rate: float = 100.0  # scenario base arrival rate, req/s
    requests: int = 200
    concurrency: int = 16  # client connections (socket loadgen)
    # scenario shape knobs (see loadgen.build_schedule)
    flash_factor: float = 8.0
    diurnal_amp: float = 0.8
    heavy_sigma: float = 1.5
    slow_fraction: float = 0.2
    slow_chunks: int = 4
    slow_gap_ms: float = 20.0
    # request mix: weight per priority class / per tenant; empty = the
    # loadgen defaults (thin priority-0, uniform tenants)
    priority_weights: Tuple[float, ...] = ()
    tenants: Tuple[str, ...] = ("tenant-a", "tenant-b")
    tenant_weights: Tuple[float, ...] = ()
    # SLO judged at verdict time: priority-0 p99 target in ms (0 = off)
    slo_p99_ms: float = 0.0
    # shed-fraction SLO objective for the capacity plane's burn-rate
    # detectors (obs/capacity.py): budgeted shed fraction per priority
    # class (0 = off). Also arms the latency burn-rate detectors when
    # --slo-p99-ms is set.
    slo_shed_rate: float = 0.0
    seed: int = 0
    out: str = ""  # also write the SLO verdict JSON here
    stats_interval_s: float = 1.0  # cadence of live `http` stats events
    max_body_mb: float = 16.0
    events_max_mb: float = 256.0
    # replica pool (serve/pool.py): N data-parallel engine replicas,
    # one per mesh device, behind the front batcher. 1 = the classic
    # single-engine path (a pool is still built when swap flags or a
    # registry ask for one).
    replicas: int = 1
    # artifact registry root (serve/registry.py): enables
    # POST /admin/swap {"version": N} and --swap-to vN resolution with
    # digest verification. Empty = swap targets are artifact dirs.
    registry: str = ""
    # swap orchestration: the version (vNNNN / integer, with
    # --registry) or artifact dir to hot-swap to. With --scenario,
    # --swap-at FRAC fires the swap after that fraction of the
    # schedule has been offered — the swap-under-load bench; without a
    # scenario the swap can be driven externally via POST /admin/swap.
    swap_to: str = ""
    swap_at: float = 0.0
    # canary stage (serve/canary.py): > 0 turns every triggered
    # rollout (--swap-at scheduled or POST /admin/swap) into a canary
    # rollout — this traffic fraction routes (deterministic seeded
    # assignment) to vN+1 on `canary_replicas` replicas while the
    # CanaryMonitor compares live per-priority p99 / shed / fairness /
    # queue-share / logit-drift windows against the incumbent's and
    # auto-promotes or auto-rolls-back. 0 = the classic unconditional
    # blue/green shift.
    canary_fraction: float = 0.0
    canary_replicas: int = 1
    # shadow mirroring: every Nth incumbent-assigned batch is ALSO
    # executed on the canary and the logits diffed off the hot path —
    # exact, because packed inference is deterministic. 0 = off.
    shadow_every: int = 8
    # "NAME=VALUE" overrides of serve/canary.py CanaryConfig fields
    # (thresholds + observation-loop knobs), validated at config time
    canary_thresholds: Tuple[str, ...] = ()
    replica_queue_batches: int = 8
    wedge_timeout_s: float = 30.0
    # weight residency (nn/packed.py): keep binary convs 1-bit in
    # device memory; the jitted forward unpacks transiently per step.
    # Logits are bitwise-equal to the dense path — the squeeze is what
    # makes --resident-models > 1 affordable.
    packed_weights: bool = False
    packed_impl: str = "unpack"  # unpack | popcount
    # multi-model residency (serve/pool.py ResidentModelCache): each
    # replica keeps up to N models resident (LRU) and requests route
    # by the x-model header to co-resident versions WITHOUT a reload
    # in the request path. Model keys are registry versions (vNNNN) —
    # needs --registry. 1 = single-model serving (x-model rejected).
    resident_models: int = 1
    # scenario request mix over co-resident models: registry versions
    # drawn per request (x-model header); empty = every request hits
    # the default model
    models: Tuple[str, ...] = ()
    model_weights: Tuple[float, ...] = ()
    # request-path tracing (obs/rtrace.py): socket-to-socket lifecycle
    # spans (read/admit/queue/coalesce/dispatch/compute/respond) in
    # the v4 verdict's attribution block, live stage histograms on
    # /statsz and the rtrace event heartbeat `watch` renders. Same
    # knob semantics as ServeBenchConfig.
    rtrace: bool = True
    rtrace_sample_every: int = 16
    rtrace_tail_k: int = 5
    # fleet identity (serve/fleet.py): a stable host id this server
    # advertises on /healthz//statsz and stamps into its 200 responses
    # (``served_by``), so a fronting router's per-host ledger can be
    # cross-checked against the host's own claim. "" = single-host
    # serving, responses unchanged.
    server_id: str = ""
    # torch device of the engines: None = the CUDA card (raises without
    # one); "cpu" runs the kernels' plain versions
    device: Optional[str] = None

    @property
    def pooled(self) -> bool:
        """True when the serving path runs through a ReplicaPool: more
        than one replica, a registry to swap from, a swap target, or
        multi-model residency (the per-replica model cache lives in
        the pool's runner factory)."""
        return bool(
            self.replicas > 1 or self.registry or self.swap_to
            or self.resident_models > 1
        )

    def validate(self) -> "ServeHttpConfig":
        from bdbnn_tpu_torch.serve.loadgen import SCENARIOS

        if not self.artifact:
            raise ValueError("serve-http needs an export artifact dir")
        if self.priorities < 1:
            raise ValueError("--priorities must be >= 1")
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(
                f"--buckets must be positive ints, got {self.buckets!r}"
            )
        if self.queue_depth <= 0:
            raise ValueError(
                "--queue-depth must be >= 1 (the per-class bound IS the "
                "shedding point)"
            )
        if self.max_delay_ms < 0:
            raise ValueError("--max-delay-ms must be >= 0")
        if self.scenario and self.scenario not in SCENARIOS:
            raise ValueError(
                f"unknown --scenario {self.scenario!r} "
                f"(want one of {SCENARIOS}, or omit to serve until "
                "SIGTERM)"
            )
        if self.scenario:
            if self.requests <= 0 or self.rate <= 0:
                raise ValueError(
                    "--scenario needs --requests > 0 and --rate > 0"
                )
            if self.concurrency <= 0:
                raise ValueError("--concurrency must be >= 1")
        if self.priority_weights and (
            len(self.priority_weights) != self.priorities
            or any(w < 0 for w in self.priority_weights)
            or sum(self.priority_weights) <= 0
        ):
            raise ValueError(
                "--priority-weights needs one nonnegative weight per "
                f"priority class ({self.priorities}), summing > 0"
            )
        if not self.tenants:
            raise ValueError("need at least one tenant name")
        if self.tenant_weights and (
            len(self.tenant_weights) != len(self.tenants)
            or any(w < 0 for w in self.tenant_weights)
            or sum(self.tenant_weights) <= 0
        ):
            raise ValueError(
                "--tenant-weights needs one nonnegative weight per "
                f"tenant ({len(self.tenants)}), summing > 0"
            )
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError("--slow-fraction must be in [0, 1]")
        if self.slo_p99_ms < 0:
            raise ValueError("--slo-p99-ms must be >= 0 (0 disables)")
        if not 0.0 <= self.slo_shed_rate <= 1.0:
            raise ValueError(
                "--slo-shed-rate must be in [0, 1] (0 disables)"
            )
        if self.stats_interval_s <= 0:
            raise ValueError("--stats-interval-s must be > 0")
        if self.max_body_mb <= 0:
            raise ValueError("--max-body-mb must be > 0")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0")
        # quota specs fail here, not at the first request
        from bdbnn_tpu_torch.serve.admission import (
            parse_quota,
            parse_tenant_quotas,
        )

        rate, burst = parse_quota(self.default_quota)
        if rate < 0 or burst <= 0:
            raise ValueError(
                f"--default-quota needs RATE >= 0 and BURST > 0, got "
                f"{self.default_quota!r}"
            )
        for tenant, (t_rate, t_burst) in parse_tenant_quotas(
            self.tenant_quotas
        ).items():
            if t_rate < 0 or t_burst <= 0:
                raise ValueError(
                    f"--tenant-quota {tenant}: needs RATE >= 0 and "
                    f"BURST > 0, got {t_rate}:{t_burst}"
                )
        if self.replicas < 1:
            raise ValueError("--replicas must be >= 1")
        if not 0.0 <= self.swap_at < 1.0:
            raise ValueError(
                "--swap-at is a fraction of the scenario's offered "
                f"requests in [0, 1), got {self.swap_at!r}"
            )
        if self.swap_at > 0 and not self.swap_to:
            raise ValueError("--swap-at needs --swap-to (what to swap to)")
        if self.swap_at > 0 and not self.scenario:
            raise ValueError(
                "--swap-at schedules a swap against a --scenario's "
                "offered load; without one, drive POST /admin/swap "
                "instead"
            )
        if self.scenario and self.swap_to and self.swap_at <= 0:
            raise ValueError(
                "--swap-to under a --scenario needs --swap-at FRAC "
                "(when to fire it): a bench that silently never fires "
                "the requested swap would exit 0 and read as a met "
                "rollout contract"
            )
        if not 0.0 <= self.canary_fraction < 1.0:
            raise ValueError(
                "--canary-fraction is the traffic fraction routed to "
                f"the canary, in [0, 1), got {self.canary_fraction!r}"
            )
        if self.canary_fraction > 0:
            if self.replicas < 2:
                raise ValueError(
                    "--canary-fraction needs --replicas >= 2: the "
                    "canary subset serves vN+1 while at least one "
                    "incumbent replica keeps serving vN — with one "
                    "replica there is no incumbent cohort to compare "
                    "against (or to roll back to under load)"
                )
            if not 1 <= self.canary_replicas <= self.replicas - 1:
                raise ValueError(
                    f"--canary-replicas must be in [1, replicas-1] = "
                    f"[1, {self.replicas - 1}], got "
                    f"{self.canary_replicas!r}: the canary subset must "
                    "leave at least one incumbent replica serving vN"
                )
        if self.shadow_every < 0:
            raise ValueError(
                "--shadow-every must be >= 0 (0 disables the "
                "logit-drift probe)"
            )
        if self.canary_thresholds:
            # unknown detector-threshold names fail at config time, not
            # mid-rollout (the --health-threshold precedent)
            from bdbnn_tpu_torch.serve.canary import CanaryConfig, apply_canary_overrides

            apply_canary_overrides(CanaryConfig(), self.canary_thresholds)
        if self.replica_queue_batches <= 0:
            raise ValueError("--replica-queue-batches must be >= 1")
        if self.wedge_timeout_s <= 0:
            raise ValueError("--wedge-timeout-s must be > 0")
        if self.packed_impl not in ("unpack", "popcount"):
            raise ValueError(
                f"--packed-impl must be unpack|popcount, got "
                f"{self.packed_impl!r}"
            )
        if self.resident_models < 1:
            raise ValueError("--resident-models must be >= 1")
        if self.resident_models > 1 and not self.registry:
            raise ValueError(
                "--resident-models > 1 needs --registry: co-resident "
                "models are routed by x-model naming digest-verified "
                "registry versions, never arbitrary paths a client "
                "could choose"
            )
        if self.models:
            if not self.scenario:
                raise ValueError(
                    "--models draws x-model per scheduled request; it "
                    "needs a --scenario (in serve mode clients set "
                    "x-model themselves)"
                )
            if self.resident_models < 2:
                raise ValueError(
                    "--models needs --resident-models >= 2: a model "
                    "mix over a single-model cache would thrash "
                    "reloads on every batch"
                )
            # the steady-state cache-resident set is the DISTINCT
            # non-default mix entries PLUS the default engine's own
            # slot (it warms eagerly under the cache's default key); a
            # mix that cannot co-reside evicts/rebuilds an engine
            # (seconds of AOT compile) on every batch group — the same
            # thrash the check above rejects, one notch up
            from bdbnn_tpu_torch.serve.registry import looks_like_version
            from bdbnn_tpu_torch.serve.registry import parse_version as _pv

            bad = [m for m in self.models if not looks_like_version(m)]
            if bad:
                raise ValueError(
                    f"--models entries must be registry versions "
                    f"(vNNNN or an integer), got {bad!r} — the mix is "
                    "routed by x-model through digest-verified "
                    "registry versions, never paths (and a non-version "
                    "entry would otherwise crash the warm loop after "
                    "the server has already bound)"
                )
            cached = {_pv(m) for m in self.models}
            if looks_like_version(self.artifact):
                cached.discard(_pv(self.artifact))
            if len(cached) + 1 > self.resident_models:
                raise ValueError(
                    f"--models draws {len(cached)} distinct "
                    "non-default versions, which plus the default "
                    f"engine's slot exceeds --resident-models "
                    f"{self.resident_models}: the overflow would "
                    "evict and rebuild an engine (seconds of AOT "
                    "compile) in the request path on every batch — "
                    "raise --resident-models or trim the mix"
                )
        if self.model_weights and (
            len(self.model_weights) != len(self.models)
            or any(w < 0 for w in self.model_weights)
            or sum(self.model_weights) <= 0
        ):
            raise ValueError(
                "--model-weights needs one nonnegative weight per "
                f"model ({len(self.models)}), summing > 0"
            )
        if self.rtrace_sample_every < 1:
            raise ValueError(
                "--rtrace-sample-every must be >= 1 (1 = every "
                "request; use --no-rtrace to disable tracing)"
            )
        if self.rtrace_tail_k < 0:
            raise ValueError("--rtrace-tail-k must be >= 0")
        return self


@dataclasses.dataclass(frozen=True)
class ServeFleetConfig:
    """Typed configuration of the ``serve-fleet`` CLI (serve/fleet.py).

    Same resolve-once contract as the other serving configs: every
    knob of the cross-host router — the backend host set, health-probe
    state machine, retry/backoff budget, fleet swap targets and (in
    bench mode) the traffic scenario — is validated before any socket
    exists. The router holds no engine and so has no ``device``: each
    host's own ``serve-http`` picks its card.
    """

    hosts: Tuple[str, ...]  # backend serve-http hosts, "HOST:PORT" each
    # export artifact dir: scenario mode reads image_size/num_classes
    # from its artifact.json (stdlib JSON read — no weights, no JAX) to
    # shape request bodies. "" = serve mode only.
    artifact: str = ""
    log_path: str = "serve_fleet_log"
    host: str = "127.0.0.1"  # router bind address
    port: int = 0  # 0 = kernel-assigned ephemeral port
    priorities: int = 3  # x-priority classes the ledger buckets by
    # health-probe state machine (obs/health.py DetectorState): probe
    # every interval; the first `health_warmup` probes are never
    # judged, a connect/timeout breach must persist `health_debounce`
    # consecutive probes before the host is declared dead, and a dead
    # host re-arms on the first successful probe (hysteresis).
    probe_interval_s: float = 0.25
    probe_timeout_s: float = 1.0
    health_warmup: int = 0
    health_debounce: int = 2
    # proxy retry budget: an accepted request is tried on up to
    # `max_attempts` DISTINCT hosts on connect/timeout/reset failures
    # (a backend 4xx/5xx RESPONSE is relayed, never retried), with
    # exponential backoff base*2^attempt capped at `backoff_cap_ms`
    # between attempts and a per-attempt proxy timeout.
    max_attempts: int = 3
    backoff_base_ms: float = 25.0
    backoff_cap_ms: float = 250.0
    proxy_timeout_s: float = 60.0
    # how long router startup may wait for at least one backend host
    # to probe ready before the run aborts
    ready_timeout_s: float = 60.0
    # bench mode: "" = route until SIGTERM; otherwise one of the
    # loadgen scenarios driven over real sockets against the ROUTER
    scenario: str = ""
    rate: float = 100.0
    requests: int = 200
    concurrency: int = 16
    flash_factor: float = 8.0
    diurnal_amp: float = 0.8
    heavy_sigma: float = 1.5
    slow_fraction: float = 0.2
    slow_chunks: int = 4
    slow_gap_ms: float = 20.0
    priority_weights: Tuple[float, ...] = ()
    tenants: Tuple[str, ...] = ("tenant-a", "tenant-b")
    tenant_weights: Tuple[float, ...] = ()
    slo_p99_ms: float = 0.0
    # budgeted shed fraction for the backends' capacity planes — the
    # router records it in its manifest; each HOST's own
    # --slo-shed-rate arms the detectors the router's scrape merges
    slo_shed_rate: float = 0.0
    seed: int = 0
    out: str = ""
    stats_interval_s: float = 1.0
    events_max_mb: float = 256.0
    # cross-host tracing (obs/rtrace.py FleetTracer): the router mints
    # a trace id per proxied request, stamps its own stages
    # (probe_wait/pick/connect/retry_hop/network), propagates the
    # context via x-rtrace and stitches the backend's x-rtrace-stages
    # reply into the v7 fleet_attribution block. Same sampling knob
    # semantics as serve-http's rtrace.
    rtrace: bool = True
    rtrace_sample_every: int = 16
    rtrace_tail_k: int = 5
    # fleet metrics plane: the stats pump scrapes every host's
    # /statsz rtrace block with its OWN bounded timeout (a wedged
    # host costs one timeout per pump period, never a stall) and
    # `scrape_stale_after` consecutive failures mark that host's
    # merged window stale.
    scrape_timeout_s: float = 0.5
    scrape_stale_after: int = 3
    # fleet blue/green: the PRIMARY registry rollouts pull from, the
    # per-host registry roots replicated into (one per host, in host
    # order; hosts sharing a filesystem may share one root), and the
    # scheduled swap trigger (--swap-at fraction of the scenario).
    registry: str = ""
    host_registries: Tuple[str, ...] = ()
    swap_to: str = ""
    swap_at: float = 0.0
    # how long the host-by-host shift may wait on any ONE host's swap
    # state machine before declaring the fleet rollout failed
    swap_host_timeout_s: float = 120.0

    def validate(self) -> "ServeFleetConfig":
        from bdbnn_tpu_torch.serve.loadgen import SCENARIOS

        if not self.hosts:
            raise ValueError(
                "serve-fleet needs at least one backend host "
                "(--hosts HOST:PORT ...)"
            )
        for spec in self.hosts:
            host, sep, port = str(spec).rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    f"bad --hosts entry {spec!r} (want HOST:PORT)"
                )
        if len(set(self.hosts)) != len(self.hosts):
            raise ValueError(f"duplicate --hosts entries: {self.hosts!r}")
        if self.priorities < 1:
            raise ValueError("--priorities must be >= 1")
        if self.probe_interval_s <= 0 or self.probe_timeout_s <= 0:
            raise ValueError(
                "--probe-interval-s and --probe-timeout-s must be > 0"
            )
        if self.health_warmup < 0 or self.health_debounce < 1:
            raise ValueError(
                "--health-warmup must be >= 0 and --health-debounce "
                ">= 1"
            )
        if self.max_attempts < 1:
            raise ValueError("--max-attempts must be >= 1")
        if self.backoff_base_ms < 0 or self.backoff_cap_ms < 0:
            raise ValueError(
                "--backoff-base-ms and --backoff-cap-ms must be >= 0"
            )
        if self.proxy_timeout_s <= 0 or self.ready_timeout_s <= 0:
            raise ValueError(
                "--proxy-timeout-s and --ready-timeout-s must be > 0"
            )
        if self.scenario and self.scenario not in SCENARIOS:
            raise ValueError(
                f"unknown --scenario {self.scenario!r} "
                f"(want one of {SCENARIOS}, or omit to route until "
                "SIGTERM)"
            )
        if self.scenario:
            if not self.artifact:
                raise ValueError(
                    "--scenario needs ARTIFACT (the export artifact "
                    "dir whose artifact.json shapes request bodies)"
                )
            if self.requests <= 0 or self.rate <= 0:
                raise ValueError(
                    "--scenario needs --requests > 0 and --rate > 0"
                )
            if self.concurrency <= 0:
                raise ValueError("--concurrency must be >= 1")
        if self.priority_weights and (
            len(self.priority_weights) != self.priorities
            or any(w < 0 for w in self.priority_weights)
            or sum(self.priority_weights) <= 0
        ):
            raise ValueError(
                "--priority-weights needs one nonnegative weight per "
                f"priority class ({self.priorities}), summing > 0"
            )
        if not self.tenants:
            raise ValueError("need at least one tenant name")
        if self.tenant_weights and (
            len(self.tenant_weights) != len(self.tenants)
            or any(w < 0 for w in self.tenant_weights)
            or sum(self.tenant_weights) <= 0
        ):
            raise ValueError(
                "--tenant-weights needs one nonnegative weight per "
                f"tenant ({len(self.tenants)}), summing > 0"
            )
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError("--slow-fraction must be in [0, 1]")
        if self.slo_p99_ms < 0:
            raise ValueError("--slo-p99-ms must be >= 0 (0 disables)")
        if not 0.0 <= self.slo_shed_rate <= 1.0:
            raise ValueError(
                "--slo-shed-rate must be in [0, 1] (0 disables)"
            )
        if self.stats_interval_s <= 0:
            raise ValueError("--stats-interval-s must be > 0")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0")
        if self.rtrace_sample_every < 1:
            raise ValueError(
                "--rtrace-sample-every must be >= 1 (1 = every "
                "request; use --no-rtrace to disable tracing)"
            )
        if self.rtrace_tail_k < 0:
            raise ValueError("--rtrace-tail-k must be >= 0")
        if self.scrape_timeout_s <= 0:
            raise ValueError("--scrape-timeout-s must be > 0")
        if self.scrape_stale_after < 1:
            raise ValueError("--scrape-stale-after must be >= 1")
        if not 0.0 <= self.swap_at < 1.0:
            raise ValueError(
                "--swap-at is a fraction of the scenario's offered "
                f"requests in [0, 1), got {self.swap_at!r}"
            )
        if self.swap_at > 0 and not self.swap_to:
            raise ValueError("--swap-at needs --swap-to (what to swap to)")
        if self.swap_at > 0 and not self.scenario:
            raise ValueError(
                "--swap-at schedules a swap against a --scenario's "
                "offered load; without one, drive POST /fleet/swap "
                "instead"
            )
        if self.swap_to and not self.registry:
            from bdbnn_tpu_torch.serve.registry import looks_like_version

            if looks_like_version(self.swap_to):
                raise ValueError(
                    "--swap-to by version needs --registry (the "
                    "primary registry the fleet pulls from)"
                )
        if self.host_registries and len(self.host_registries) != len(
            self.hosts
        ):
            raise ValueError(
                "--host-registries needs one registry root per host "
                f"({len(self.hosts)}), got {len(self.host_registries)}"
            )
        if self.swap_host_timeout_s <= 0:
            raise ValueError("--swap-host-timeout-s must be > 0")
        return self


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """Typed configuration of the ``perf`` CLI (obs/roofline.py): the
    sweep's knobs validated before any engine exists, so a bad impl name
    fails at the command line, not after the first engine warmed."""

    artifact: str  # export artifact dir (serve/export.py)
    log_path: str = "perf_log"  # run dirs + PERF_LEDGER.jsonl land here
    # engine batch-size buckets to sweep; each gets its own static
    # cost-model table (batch changes intensity) and, per impl, its own
    # traced timing window
    buckets: Tuple[int, ...] = (1, 8, 32)
    # packed_impl variants to measure: "dense" (sign·alpha weights
    # resident, K2 → K1), "unpack" (1-bit resident, K3 → K2 → K1),
    # "popcount" (1-bit resident, K3 → K2 → K4). popcount on a bf16
    # artifact is recorded as skipped, never an error
    impls: Tuple[str, ...] = ("dense", "unpack", "popcount")
    # measured forwards per (impl, bucket) profiler window (one extra
    # unmeasured forward runs outside the window)
    iters: int = 20
    # ceilings override: path to a JSON file — either one row
    # {"peak_flops": ..., "hbm_gbs": ...} used directly, or a
    # {device_kind: row} table merged over the built-in one
    ceilings: str = ""
    # static cost model only: no engines, no kernels, no traces
    static_only: bool = False
    # reconciliation tolerance: |trace device-op total - wall| / wall
    # above this marks the bucket's reconciliation not-ok
    tol_reconcile: float = 0.5
    out: str = ""  # also write the perf verdict JSON here
    events_max_mb: float = 256.0
    # torch device of the engines: None = the CUDA card (raises without
    # one); "cpu" runs the plain versions
    device: Optional[str] = None

    def validate(self) -> "PerfConfig":
        if not self.artifact:
            raise ValueError("perf needs an export artifact dir")
        if not self.buckets or any(int(b) <= 0 for b in self.buckets):
            raise ValueError(f"--buckets must be positive ints, got {self.buckets!r}")
        known = ("dense", "unpack", "popcount")
        if not self.impls or any(i not in known for i in self.impls):
            raise ValueError(f"--impls must be a subset of {known}, got {self.impls!r}")
        if len(set(self.impls)) != len(self.impls):
            raise ValueError(f"duplicate impls: {self.impls!r}")
        if self.iters < 1:
            raise ValueError("--iters must be >= 1")
        if self.tol_reconcile <= 0:
            raise ValueError("--tol-reconcile must be > 0")
        if self.events_max_mb < 0:
            raise ValueError("--events-max-mb must be >= 0")
        return self


__all__ = ["PerfConfig", "ServeBenchConfig", "ServeFleetConfig", "ServeHttpConfig"]

"""Typed configuration of the ``serve-bench`` CLI — the port's copy of
``ServeBenchConfig`` in ``bdbnn_tpu/configs/config.py``: the reference's
fields, defaults and ``validate()``, plus ``device`` (the card unless
the caller asks for the CPU; there is no fallback)."""

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




__all__ = ["ServeBenchConfig"]

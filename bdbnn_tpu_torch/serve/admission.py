"""Per-tenant admission control: token-bucket quotas + shed taxonomy —
the port's copy of ``bdbnn_tpu/serve/admission.py`` (stdlib only).

The micro-batcher's queue bound protects the SERVER (bounded memory,
explicit shedding under aggregate overload) but says nothing about
WHO gets the capacity: one tenant replaying a firehose starves every
other tenant long before the aggregate bound trips. This module adds
the per-tenant layer the HTTP front end (serve/http.py) consults
BEFORE a request may touch the batcher:

- :class:`TokenBucket` — the classic rate limiter: ``burst`` tokens of
  headroom refilled at ``rate`` tokens/second; one token per admitted
  request. The clock is injectable so tests are deterministic.
- :class:`AdmissionController` — one bucket per tenant (created
  lazily from the default quota; explicit per-tenant overrides), a
  latched drain flag, and per-tenant accounting. ``admit(tenant)``
  returns one of three decisions the front end maps onto distinct
  status codes:

  ============  ======  ====================================================
  decision      HTTP    meaning
  ============  ======  ====================================================
  ``admit``     —       hand the request to the batcher
  ``over_quota``  429   THIS tenant exhausted its own budget (retry later;
                        other tenants are unaffected)
  ``draining``  503     the SERVER is going away (SIGTERM latched) —
                        retry against another replica
  ============  ======  ====================================================

  Queue-full sheds from the batcher are a third, distinct cause the
  front end also maps to 503 (server overload, not tenant fault) and
  records here per tenant via :meth:`record_shed` — so the SLO
  verdict can show exactly which tenants lost what to which cause.

Stdlib-only, no locks beyond one mutex: decisions are a dict lookup +
float math, cheap enough for the request path.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

ADMIT = "admit"
OVER_QUOTA = "over_quota"
DRAINING = "draining"

DEFAULT_TENANT = "anon"


class TokenBucket:
    """``burst`` tokens of headroom, refilled at ``rate``/s, one token
    per :meth:`try_take`. ``rate=0`` means a fixed budget of ``burst``
    requests and no refill (useful in tests and hard caps)."""

    def __init__(
        self,
        rate: float,
        burst: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate < 0 or burst <= 0:
            raise ValueError(
                f"need rate >= 0 and burst > 0, got rate={rate} burst={burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._t_last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        now = self._clock()
        self.tokens = min(
            self.burst, self.tokens + (now - self._t_last) * self.rate
        )
        self._t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def headroom(self) -> float:
        """Current fill fraction (0..1) WITHOUT taking a token: the
        refresh math of :meth:`try_take` applied read-only, so the
        capacity plane (obs/capacity.py) can sample quota headroom
        between requests without charging anyone."""
        now = self._clock()
        return (
            min(self.burst, self.tokens + (now - self._t_last) * self.rate)
            / self.burst
        )


def parse_quota(spec: str) -> Tuple[float, float]:
    """``"RATE"`` or ``"RATE:BURST"`` -> (rate, burst); burst defaults
    to max(rate, 1) so a bare rate behaves like a 1-second window."""
    rate_s, _, burst_s = str(spec).partition(":")
    rate = float(rate_s)
    burst = float(burst_s) if burst_s else max(rate, 1.0)
    return rate, burst


def parse_tenant_quotas(
    specs: Iterable[str],
) -> Dict[str, Tuple[float, float]]:
    """Repeatable CLI form ``TENANT=RATE[:BURST]`` -> {tenant: (rate,
    burst)}; malformed specs fail at config time, not mid-request."""
    out: Dict[str, Tuple[float, float]] = {}
    for spec in specs:
        tenant, sep, quota = str(spec).partition("=")
        if not sep or not tenant:
            raise ValueError(
                f"tenant quota must be TENANT=RATE[:BURST], got {spec!r}"
            )
        out[tenant] = parse_quota(quota)
    return out


class AdmissionController:
    """Per-tenant token buckets behind one latched drain flag.

    ``quotas`` maps tenant -> (rate, burst) overrides; unknown tenants
    lazily get a bucket at the default quota (every tenant is limited,
    not just the named ones). ``clock`` is injected into every bucket,
    so a test can step time deterministically.
    """

    def __init__(
        self,
        *,
        default_rate: float = 100.0,
        default_burst: float = 100.0,
        quotas: Optional[Dict[str, Tuple[float, float]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.default_rate = float(default_rate)
        self.default_burst = float(default_burst)
        self._quotas = dict(quotas or {})
        for tenant, (rate, burst) in self._quotas.items():
            if rate < 0 or burst <= 0:
                raise ValueError(
                    f"tenant {tenant!r}: need rate >= 0 and burst > 0, "
                    f"got {rate}:{burst}"
                )
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}  # guarded-by: _lock
        self._draining = threading.Event()
        self._lock = threading.Lock()
        # per-tenant accounting: every decision and every downstream
        # disposition the front end reports back lands here, so the
        # verdict's per-tenant table comes from ONE place
        self._counts: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock

    def _tenant_counts(self, tenant: str) -> Dict[str, int]:  # requires-lock: _lock
        return self._counts.setdefault(
            tenant,
            {"admitted": 0, "over_quota": 0, "shed": 0, "completed": 0,
             "failed": 0, "rejected": 0},
        )

    def quota_for(self, tenant: str) -> Tuple[float, float]:
        return self._quotas.get(
            tenant, (self.default_rate, self.default_burst)
        )

    # -- request path --------------------------------------------------

    def admit(self, tenant: str, trace=None) -> str:
        """One decision per request: ``draining`` | ``over_quota`` |
        ``admit`` (in that precedence — a draining server must not
        charge tenants tokens for requests it will not serve).
        ``trace`` (optional, obs/rtrace.py) gets its ``admit`` span
        stamped here — the quota decision's cost belongs to the layer
        that owns it (the owning-site rule of every span)."""
        with self._lock:
            if self._draining.is_set():
                decision = DRAINING
            else:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    rate, burst = self.quota_for(tenant)
                    bucket = TokenBucket(rate, burst, clock=self._clock)
                    self._buckets[tenant] = bucket
                counts = self._tenant_counts(tenant)
                if not bucket.try_take():
                    counts["over_quota"] += 1
                    decision = OVER_QUOTA
                else:
                    counts["admitted"] += 1
                    decision = ADMIT
        if trace is not None:
            trace.stamp("admit")
        return decision

    def record_shed(self, tenant: str) -> None:
        """An ADMITTED request the batcher then shed (queue full or a
        racing drain) — server overload charged to the server, but
        visible per tenant."""
        with self._lock:
            self._tenant_counts(tenant)["shed"] += 1

    def record_completed(self, tenant: str) -> None:
        with self._lock:
            self._tenant_counts(tenant)["completed"] += 1

    def record_failed(self, tenant: str) -> None:
        """Accepted but the engine errored — NOT shedding (an operator
        must never read a broken artifact as overload)."""
        with self._lock:
            self._tenant_counts(tenant)["failed"] += 1

    def record_rejected(self, tenant: str) -> None:
        """Admitted but the BODY was malformed (400) — the tenant's
        own bad request, distinct from shedding and from engine
        failure in the ledger."""
        with self._lock:
            self._tenant_counts(tenant)["rejected"] += 1

    def token_headroom(self) -> Optional[float]:
        """Mean quota-headroom fraction across the tenants seen so far
        (1.0 = every bucket full, 0.0 = every tenant exhausted) — the
        admission gauge the capacity plane's UtilizationWindows
        samples. None before any tenant has been admitted: no buckets
        is "nothing to measure", not "full headroom"."""
        with self._lock:
            fracs = [b.headroom() for b in self._buckets.values()]
        if not fracs:
            return None
        return round(sum(fracs) / len(fracs), 4)

    # -- lifecycle / reporting -----------------------------------------

    def drain(self) -> None:
        """Latch: every subsequent admit() returns ``draining``."""
        self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_tenant = {}
            for tenant in sorted(self._counts):
                c = dict(self._counts[tenant])
                seen = (
                    c["admitted"] + c["over_quota"]
                )
                c["shed_rate"] = round(
                    (c["over_quota"] + c["shed"]) / seen, 6
                ) if seen else 0.0
                rate, burst = self.quota_for(tenant)
                c["quota_rate"] = rate
                c["quota_burst"] = burst
                per_tenant[tenant] = c
            return {
                "draining": self._draining.is_set(),
                "default_rate": self.default_rate,
                "default_burst": self.default_burst,
                "tenants": per_tenant,
            }


__all__ = [
    "ADMIT",
    "DEFAULT_TENANT",
    "DRAINING",
    "OVER_QUOTA",
    "AdmissionController",
    "TokenBucket",
    "parse_quota",
    "parse_tenant_quotas",
]

"""The capacity plane, admission control and the detector discipline on
the port (``bdbnn_tpu_torch/obs/capacity.py``, ``obs/health.py``,
``serve/admission.py``) against the JAX package, on the CPU.

- Exact parity (``==``): ``DetectorState`` transitions; a scripted
  sequence of ``TokenBucket`` and ``AdmissionController`` calls on an
  injected clock; ``parse_quota``/``parse_tenant_quotas`` and their
  refusals; ``saturation_headroom`` and ``_burn``; ``DemandLedger``,
  ``UtilizationWindows``, ``SLOBudget`` and ``CapacityPlane`` —
  ``live_block`` and ``verdict_block`` after every tick — fed the same
  scripted dispositions on an injected clock, for several seeds.
- Mirrors of the reference's capacity tests (``tests/test_capacity.py``)
  on the port: the ledger identity under concurrent feeders, the
  detectors' warmup/debounce/hysteresis, ``peek`` never ticking them,
  and the live ``/statsz`` capacity block over real sockets.
- The fleet router's merge, ``FleetCapacityWindows``, fed the same scraped
  blocks and failures as the reference's: the snapshot after every step
  equal, staleness and the merge over fresh hosts only included.
"""

import json
import random
import threading
import time

import pytest

from bdbnn_tpu.obs import capacity as jcap
from bdbnn_tpu.obs import health as jhealth
from bdbnn_tpu.serve import admission as jadm
from bdbnn_tpu_torch.obs import capacity as tcap
from bdbnn_tpu_torch.obs import health as thealth
from bdbnn_tpu_torch.serve import admission as tadm

from test_torch_http import _predict, _request, port_frontend  # noqa: F401  (fixture)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# exact parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,debounce", [(0, 1), (2, 2), (3, 1), (1, 4)])
def test_detector_state_transitions_equal_the_reference(warmup, debounce):
    rng = random.Random(warmup * 10 + debounce)
    script = [(rng.random() < 0.6, rng.random() < 0.3) for _ in range(200)]

    def run(cls):
        d = cls(warmup, debounce)
        out = []
        for breach, recovered in script:
            out.append((d.update(breach, recovered), d.seen, d.streak, d.latched, d.fired))
        return out

    got = run(thealth.DetectorState)
    assert got == run(jhealth.DetectorState)
    assert any(f for f, *_ in got)


def _admission_script(mod, seed):
    clk = FakeClock()
    rng = random.Random(seed)
    bucket = mod.TokenBucket(2.0, 3.0, clock=clk)
    ctl = mod.AdmissionController(default_rate=5.0, default_burst=2.0,
                                  quotas={"small": (0.0, 3.0), "big": (50.0, 10.0)}, clock=clk)
    out = []
    for i in range(300):
        op = rng.random()
        tenant = rng.choice(["small", "big", "anon", "other"])
        if op < 0.55:
            out.append(("admit", ctl.admit(tenant)))
        elif op < 0.65:
            ctl.record_completed(tenant)
        elif op < 0.7:
            ctl.record_shed(tenant)
        elif op < 0.73:
            ctl.record_failed(tenant)
        elif op < 0.76:
            ctl.record_rejected(tenant)
        elif op < 0.9:
            out.append(("take", bucket.try_take(), round(bucket.headroom(), 12)))
        else:
            clk.tick(rng.choice([0.01, 0.1, 0.5, 2.0]))
        if i == 250:
            ctl.drain()
        if i % 25 == 0:
            out.append(("stats", ctl.stats(), ctl.token_headroom(), ctl.quota_for(tenant)))
    out.append(("final", ctl.stats(), ctl.draining))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_admission_script_equals_the_reference(seed):
    got = _admission_script(tadm, seed)
    assert got == _admission_script(jadm, seed)
    decisions = {d for kind, d, *_ in got if kind == "admit"}
    assert decisions == {tadm.ADMIT, tadm.OVER_QUOTA, tadm.DRAINING}


@pytest.mark.parametrize("spec", ["100", "100:200", "0.5:3", "7:0", " 3 : 4 "])
def test_parse_quota_equals_the_reference(spec):
    assert tadm.parse_quota(spec) == jadm.parse_quota(spec)


@pytest.mark.parametrize("bad", ["", "x", "1:y", "a=b=c"])
def test_quota_refusals_equal_the_reference(bad):
    for fn in ("parse_quota", "parse_tenant_quotas"):
        arg = bad if fn == "parse_quota" else (bad,)
        with pytest.raises(ValueError) as want:
            getattr(jadm, fn)(arg)
        with pytest.raises(ValueError) as got:
            getattr(tadm, fn)(arg)
        assert str(got.value) == str(want.value)
    specs = ("t=10:5", "u=3", "v=0.5:1")
    assert tadm.parse_tenant_quotas(specs) == jadm.parse_tenant_quotas(specs)


def test_headroom_and_burn_equal_the_reference():
    cases = [dict(offered_rps=o, completed_rps=c, busy_fraction=b, slope_rps_per_s=s)
             for o in (None, 0.0, 100.0, 500.0) for c in (None, 0.0, 50.0, 200.0)
             for b in (None, 0.001, 0.5, 1.0) for s in (None, -3.0, 10.0)]
    for kw in cases:
        assert tcap.saturation_headroom(**kw) == jcap.saturation_headroom(**kw)
    for bad, total, frac in [(0, 0, 0.01), (0, 100, 0.01), (1, 100, 0.01), (5, 100, 0.01),
                             (1, 100, 0.0), (0, 100, 0.0), (100, 100, 1e-9), (3, 7, 0.25)]:
        assert tcap._burn(bad, total, frac) == jcap._burn(bad, total, frac)


def _plane_script(mod, seed, slo_p99_ms, slo_shed_rate):
    """Scripted dispositions on an injected clock through a CapacityPlane;
    every tick's evaluate, live_block and verdict_block."""
    clk = FakeClock()
    rng = random.Random(seed)
    plane = mod.CapacityPlane(slo_p99_ms=slo_p99_ms, slo_shed_rate=slo_shed_rate, priorities=3,
                              window_s=4.0, fast_window_s=1.0, slow_window_s=3.0,
                              util_window=8, clock=clk)
    plane.utilization.set_residency({"resident_bytes": 1234, "models": 1})
    out = []
    for tick in range(30):
        storm = 10 <= tick < 18
        for _ in range(rng.randint(5, 40)):
            model = rng.choice(["default", "v0002"])
            tenant = rng.choice(["calm", "greedy"])
            p = rng.choice([0, 1, 2, 2])
            plane.ledger.offered(model, tenant, p)
            r = rng.random()
            if r < (0.5 if storm and p > 0 else 0.05):
                plane.ledger.shed(model, tenant, p)
                plane.budget.feed(p, shed=True)
            elif r < 0.6 and tenant == "greedy":
                plane.ledger.rejected(model, tenant, p)
            elif r < 0.97:
                plane.ledger.admitted(model, tenant, p)
                if r < 0.95:
                    plane.ledger.completed(model, tenant, p)
                    lat = rng.choice([5.0, 20.0, 80.0]) * (8.0 if storm and p == 1 else 1.0)
                    plane.budget.feed(p, latency_ms=lat)
                else:
                    plane.ledger.failed(model, tenant, p)
            # else: still mid-decision (the identity delta shows it)
        plane.sample(busy_fraction=rng.choice([None, 0.2, 0.9, 1.0]),
                     occupancy=rng.random(), queue_share=rng.choice([None, float("nan"), 0.3]),
                     admission_headroom=rng.random())
        out.append(("evaluate", plane.evaluate()))
        out.append(("live", plane.live_block()))
        out.append(("slope", plane.ledger.offered_slope_rps_per_s()))
        clk.tick(rng.choice([0.25, 0.5, 1.0]))
    out.append(("verdict", plane.verdict_block()))
    return out


@pytest.mark.parametrize("seed,p99,shed", [(0, 100.0, 0.05), (1, 0.0, 0.1), (2, 50.0, 0.0),
                                           (3, 0.0, 0.0)])
def test_capacity_plane_equals_the_reference(monkeypatch, seed, p99, shed):
    # the episode ledger stamps wall-clock time: frozen for both runs
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    got = _plane_script(tcap, seed, p99, shed)
    assert got == _plane_script(jcap, seed, p99, shed)
    json.dumps(got[-1][1], allow_nan=False)
    if p99 and shed:
        assert got[-1][1]["slo_budget"]["episodes"], "the storm fired no detector"


def test_budget_and_ledger_equal_the_reference_alone(monkeypatch):
    """SLOBudget and DemandLedger built on their own (not through a
    plane), with their validation refusals."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    for mod in (tcap, jcap):
        with pytest.raises(ValueError, match="fast_window_s"):
            mod.SLOBudget(fast_window_s=5.0, slow_window_s=2.0)
        with pytest.raises(ValueError, match="window_s"):
            mod.DemandLedger(window_s=0.0)
        with pytest.raises(ValueError, match="unknown"):
            mod.UtilizationWindows().sample(cpu_temperature=1.0)

    def run(mod):
        clk = FakeClock()
        b = mod.SLOBudget(slo_p99_ms=100.0, slo_shed_rate=0.1, priorities=2,
                          fast_window_s=2.0, slow_window_s=6.0, clock=clk)
        led = mod.DemandLedger(window_s=10.0, clock=clk)
        out = [b.objectives()]
        for i in range(12):
            b.feed(i % 2, shed=i > 4)
            b.feed(0, latency_ms=150.0 if i > 6 else 10.0)
            led.offered("m", "t", i % 2)
            led.admitted("m", "t", i % 2)
            out += [b.peek(), b.evaluate(), b.snapshot(), led.snapshot(),
                    mod.demand_key("m", "t", i % 2)]
            clk.tick(0.5)
        return out

    assert run(tcap) == run(jcap)


# ---------------------------------------------------------------------------
# mirrors of tests/test_capacity.py on the port
# ---------------------------------------------------------------------------


def test_ledger_identity_holds_under_concurrent_feeders():
    ledger = tcap.DemandLedger(window_s=60.0)
    keys = [("m0", "bulk", 2), ("m0", "premium", 0), ("m1", "bulk", 1)]

    def feeder(i):
        model, tenant, p = keys[i % len(keys)]
        for j in range(200):
            ledger.offered(model, tenant, p)
            if j % 3 == 0:
                ledger.shed(model, tenant, p)
            elif j % 3 == 1:
                ledger.rejected(model, tenant, p)
            else:
                ledger.admitted(model, tenant, p)
                ledger.completed(model, tenant, p)

    threads = [threading.Thread(target=feeder, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = ledger.snapshot()
    assert snap["identity_ok"] is True and snap["in_flight_decisions"] == 0
    assert sum(row["offered"] for row in snap["keys"].values()) == 1200
    for row in snap["keys"].values():
        assert row["offered"] == row["admitted"] + row["rejected"] + row["shed"]


def test_warmup_debounce_and_peek_discipline():
    clk = FakeClock()
    budget = tcap.SLOBudget(slo_p99_ms=100.0, slo_shed_rate=0.1, priorities=3,
                            fast_window_s=2.0, slow_window_s=6.0, warmup=2, debounce=2, clock=clk)
    for _ in range(10):
        budget.feed(2, shed=True)
    for _ in range(20):
        row = budget.peek()["p2:shed"]
        assert row["breach"] is True and row["latched"] is False
    fire_ticks = []
    for i in range(1, 8):
        budget.feed(2, shed=True)
        if budget.evaluate()["fired"]:
            fire_ticks.append(i)
        clk.tick(0.5)
    assert fire_ticks == [4]


def test_statsz_capacity_block_and_measured_rate(port_frontend):  # noqa: F811
    plane = tcap.CapacityPlane(slo_p99_ms=1000.0, slo_shed_rate=0.05, priorities=3)
    fe = port_frontend(capacity=plane)
    for _ in range(5):
        assert _predict(fe, priority=2, tenant="bulk")[0] == 200
        time.sleep(0.02)
    status, _, stats = _request(fe, "GET", "/statsz")
    assert status == 200
    cap = stats["capacity"]
    row = cap["demand"]["keys"][tcap.demand_key("default", "bulk", 2)]
    assert row["offered"] == 5 and row["completed"] == 5 and row["identity_delta"] == 0
    assert set(cap["slo_budget"]["detectors"]) == {
        f"p{p}:{o}" for p in range(3) for o in ("latency", "shed")}
    assert not any(r["latched"] for r in cap["slo_budget"]["detectors"].values())
    assert 0.5 < fe.accounting()["measured_rate_rps"] < 2000.0


def test_rejects_and_sheds_land_in_ledger(port_frontend):  # noqa: F811
    fe = port_frontend(quotas={"greedy": (0.000001, 1.0)})
    assert fe.accounting()["measured_rate_rps"] is None
    assert _predict(fe, priority=1, tenant="greedy")[0] == 200
    assert _predict(fe, priority=1, tenant="greedy")[0] == 429
    row = fe.capacity.ledger.snapshot()["keys"][tcap.demand_key("default", "greedy", 1)]
    assert row["offered"] == 2 and row["rejected"] == 1 and row["admitted"] == 1
    assert row["identity_delta"] == 0


def _fleet_capacity_script(mod, seed):
    """``mod.FleetCapacityWindows`` fed a seeded sequence of scraped
    capacity blocks (with and without burn detectors, non-finite burns,
    missing sub-blocks), payloads with no block and failures for three
    hosts; the snapshot after every step."""
    rng = random.Random(seed)
    win = mod.FleetCapacityWindows(stale_after=2)
    snaps = []
    for i in range(40):
        host = f"h{rng.randrange(3)}"
        r = rng.random()
        if r < 0.25:
            win.record_failure(host)
        elif r < 0.35:
            win.record(host, None)
        else:
            block = {"demand": {"offered_rps": round(rng.uniform(0, 200), 3),
                                "demand_shed_ratio_max": rng.choice([None, rng.random()])},
                     "headroom": {"headroom_rps": round(rng.uniform(-50, 150), 3),
                                  "capacity_rps_est": rng.choice([None, 210.5])}}
            if rng.random() < 0.6:
                block["slo_budget"] = {"detectors": {
                    "p0:latency": {"burn_rate_fast": rng.choice([0.5, float("inf"), 3.0]),
                                   "burn_rate_slow": rng.uniform(0, 2)},
                    "p2:shed": {"burn_rate_fast": None, "burn_rate_slow": rng.uniform(0, 4)}}}
            win.record(host, block)
        snaps.append(win.snapshot())
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_capacity_windows_equal_the_reference(seed):
    port = _fleet_capacity_script(tcap, seed)
    assert port == _fleet_capacity_script(jcap, seed)
    assert any(s["hosts_stale"] for s in port) and any(s["hosts_fresh"] >= 2 for s in port)
    assert any(s["merged"]["offered_rps"] is not None for s in port)
    json.dumps(port[-1], allow_nan=False)


def test_fleet_capacity_refusal_equals_the_reference():
    msgs = []
    for mod in (tcap, jcap):
        with pytest.raises(ValueError) as e:
            mod.FleetCapacityWindows(stale_after=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

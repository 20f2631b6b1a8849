"""The port's rollouts against the JAX package's, on the CPU.

- ``CanaryConfig``'s fields and defaults and ``apply_canary_overrides``'
  results and errors are the reference's; ``assign_canary`` is bitwise
  the reference's over a grid of seeds, sequence numbers and fractions.
- Fed the same windows (the scenarios of the reference's
  ``tests/test_canary.py`` monitor tier), both ``CanaryMonitor`` s reach
  equal verdicts, emit equal ``canary`` events and report equal blocks.
- The stub-pool tier of the reference (``TestPoolCanaryStub``) on the
  port's ``ReplicaPool`` over an explicit device list and stub runners:
  promote with cohort routing and a full shift, logit drift rolling back
  and restoring vN (with the reference's ``shadow`` events), an
  inconclusive timeout, a drain mid-canary, the incumbent guard, a failed
  standby, the admin route.
- The degradation hook (``TestDegradationHook``): disabled is the plain
  runner, latency and errors show through a real pool, a logit
  perturbation is exact and per payload on the tiny artifact's engine,
  and no injection is bitwise the engine.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from bdbnn_tpu.serve import canary as jcanary
from bdbnn_tpu.serve import pool as jpool
from bdbnn_tpu_torch.obs.rtrace import pop_future_answered_by
from bdbnn_tpu_torch.serve import canary as tcanary
from bdbnn_tpu_torch.serve.canary import (
    CANARY,
    INCONCLUSIVE,
    INCUMBENT,
    PROMOTE,
    ROLLBACK,
    CanaryMonitor,
)
from bdbnn_tpu_torch.serve.pool import (
    SWAP_DONE,
    SWAP_FAILED,
    SWAP_ROLLED_BACK,
    PoolAdmin,
    ReplicaPool,
    make_engine_runner_factory,
)

from test_torch_serve import port_artifact  # noqa: F401  (fixture)


def _outcome(fn, *a, **kw):
    try:
        return "ok", fn(*a, **kw)
    except Exception as e:
        return type(e).__name__, str(e)


def test_canary_config_fields_and_defaults_are_the_references():
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tcanary.CanaryConfig)]
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jcanary.CanaryConfig)]
    assert tf == jf
    for name in ("CANARY", "INCUMBENT", "OBSERVE", "PROMOTE", "ROLLBACK", "INCONCLUSIVE"):
        assert getattr(tcanary, name) == getattr(jcanary, name)


@pytest.mark.parametrize("specs", [
    (), ("p99_ratio=3.5", "min_samples=7", "debounce=1"), ("nope=1",), ("p99_ratio=abc",),
    ("p99_ratio",), ("min_samples=2.5",), ("logit_drift_abs=1e-6", "max_wait_s=3"),
])
def test_apply_canary_overrides_results_and_errors_are_the_references(specs):
    got = _outcome(tcanary.apply_canary_overrides, tcanary.CanaryConfig(), specs)
    want = _outcome(jcanary.apply_canary_overrides, jcanary.CanaryConfig(), specs)
    if want[0] == "ok":
        assert got[0] == "ok" and dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    else:
        assert got == want


@pytest.mark.parametrize("fraction", [0.0, 1e-6, 0.05, 0.3, 0.5, 0.999999])
def test_assign_canary_is_bitwise_the_references(fraction):
    for seed in (0, 1, 7, 11, 2**31 - 1, 2**63 + 5):
        got = [tcanary.assign_canary(seed, i, fraction) for i in range(1500)]
        assert got == [jcanary.assign_canary(seed, i, fraction) for i in range(1500)]


# ---------------------------------------------------------------------------
# monitor tier: the reference's scenarios, run on both monitors


def _cfg(mod, **kw):
    base = dict(eval_interval_s=0.01, healthy_evals=2, max_wait_s=5.0, min_samples=5,
                debounce=2, p99_ratio=2.0, p99_floor_ms=5.0)
    base.update(kw)
    return mod.CanaryConfig(**base)


def _feed(mon, cohort, priority, lats):
    version = "v0002" if cohort == CANARY else "v0001"
    for lat in lats:
        mon.record_served(priority, lat, version)


def _scenario(mod, name):
    """One monitor-tier scenario on ``mod``'s CanaryMonitor: each evaluate's
    (decision, trigger, detector rows), the canary events, and the final
    report (its wall-clock fields dropped) and live view."""
    events = []
    mon = mod.CanaryMonitor(_cfg(mod, **({"fairness_ratio_max": 3.0}
                                         if name == "fairness" else {})),
                            priorities=2, on_event=lambda kind, **f: events.append((kind, f)))
    mon.arm(version_from="v0001", version_to="v0002", fraction=0.3, replicas=[1])
    results, counters, n_eval = [], None, 2
    if name == "p99_regression":
        _feed(mon, INCUMBENT, 0, [10.0] * 20)
        _feed(mon, CANARY, 0, [100.0] * 20)
    elif name == "sub_ms_floor":
        _feed(mon, INCUMBENT, 0, [0.1] * 10)
        _feed(mon, CANARY, 0, [0.5] * 10)
        n_eval = 4
    elif name == "healthy_promote":
        _feed(mon, INCUMBENT, 0, [10.0] * 10)
        _feed(mon, CANARY, 0, [11.0] * 10)
        n_eval = 3
    elif name == "min_samples":
        _feed(mon, INCUMBENT, 0, [10.0] * 10)
        _feed(mon, CANARY, 0, [11.0] * 3)
        n_eval = 5
    elif name == "logit_drift":
        mon.record_drift(0.0)
        results.append(mon.evaluate())
        mon.record_drift(1e-6)
        n_eval = 1
    elif name == "incomparable_drift":
        mon.record_drift(None)
        n_eval = 1
    elif name == "unabsorbed":
        counters = {CANARY: {"assigned_batches": 20, "sheds": 6, "fallbacks": 8,
                             "failed_requests": 0},
                    INCUMBENT: {"assigned_batches": 50, "failed_requests": 0}}
    elif name == "error_rate":
        _feed(mon, INCUMBENT, 0, [10.0] * 50)
        _feed(mon, CANARY, 0, [10.0] * 8)
        counters = {CANARY: {"assigned_batches": 2, "failed_requests": 4},
                    INCUMBENT: {"assigned_batches": 50, "failed_requests": 0}}
    elif name == "fairness":
        _feed(mon, INCUMBENT, 0, [10.0] * 10)
        _feed(mon, CANARY, 0, [19.0] * 10)
        _feed(mon, INCUMBENT, 1, [10.0] * 10)
        _feed(mon, CANARY, 1, [5.0] * 10)
    elif name == "queue_share":
        for _ in range(10):
            mon.record_batch("v0001", 5.0, 95.0)
            mon.record_batch("v0002", 50.0, 50.0)
    elif name == "ineligible":
        _feed(mon, CANARY, 0, [10.0] * 2)
        n_eval = 1
    elif name == "conclude_inconclusive":
        n_eval = 0
    elif name == "conclude_with_evidence":
        _feed(mon, INCUMBENT, 0, [10.0] * 10)
        _feed(mon, CANARY, 0, [11.0] * 10)
        n_eval = 1
    elif name == "raw_breach_reset":
        _feed(mon, INCUMBENT, 0, [10.0] * 10)
        _feed(mon, CANARY, 0, [11.0] * 10)
        results.append(mon.evaluate())
        _feed(mon, CANARY, 0, [500.0] * 10)
        results.append(mon.evaluate())
        _feed(mon, CANARY, 0, [11.0] * 512)
    elif name == "served_labels":
        mon.record_served(0, 10.0, "v0001")
        mon.record_served(0, 10.0, "v0002")
        mon.record_served(0, 10.0, None)
        n_eval = 1
    results += [mon.evaluate(counters) for _ in range(n_eval)]
    if name.startswith("conclude"):
        results.append(mon.conclude("timeout"))
    live = mon.live()
    report = mon.report({"mirrored": 3, "skipped": 1, "failed": 0})
    report.pop("observe_s")
    mon.disarm()
    return {"results": results, "events": events, "report": report, "live": live,
            "served": dict(mon.served), "after_disarm": mon.live()}


SCENARIOS = {
    "p99_regression": (ROLLBACK, "p99_p0"), "sub_ms_floor": (PROMOTE, None),
    "healthy_promote": (PROMOTE, None), "min_samples": ("observe", None),
    "logit_drift": (ROLLBACK, "logit_drift"), "incomparable_drift": ("observe", None),
    "unabsorbed": (ROLLBACK, "unabsorbed"), "error_rate": (ROLLBACK, "error_rate"),
    "fairness": (ROLLBACK, "fairness"), "queue_share": (ROLLBACK, "queue_share"),
    "ineligible": ("observe", None), "conclude_inconclusive": (ROLLBACK, INCONCLUSIVE),
    "conclude_with_evidence": (PROMOTE, None), "raw_breach_reset": (PROMOTE, None),
    "served_labels": ("observe", None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_reaches_the_references_verdicts_and_events(name):
    got, want = _scenario(tcanary, name), _scenario(jcanary, name)
    assert got == want
    last = got["results"][-1]
    assert (last["decision"], last["trigger"]) == SCENARIOS[name]
    assert got["after_disarm"] is None
    assert [k for k, _ in got["events"]] == ["canary"] * len(got["events"])


# ---------------------------------------------------------------------------
# stub-pool tier


def _num_factory(calls=None, eps_by_ref=None):
    """Stub runner factory over numeric payloads: rows float32([p]) + eps(ref)."""

    def factory(ref, device):
        if calls is not None:
            calls.append((str(ref), str(device)))
        eps = float((eps_by_ref or {}).get(ref, 0.0))

        def runner(payloads):
            return [np.asarray([float(p)], np.float32) + eps for p in payloads]

        return runner

    return factory


def _drive(pool, stop, answered, period=0.002):
    i = 0
    while not stop.is_set():
        try:
            fut = pool.submit([float(i)])

            def _done(f, i=i):
                if not f.cancelled() and f.exception() is None:
                    answered.append((i, pop_future_answered_by(f)))

            fut.add_done_callback(_done)
        except Exception:
            pass
        i += 1
        time.sleep(period)


def _mcfg(**kw):
    return _cfg(tcanary, **kw)


class TestPoolCanaryStub:
    def test_promote_routes_cohorts_and_completes_full_shift(self):
        events, calls, answered = [], [], []
        pool = ReplicaPool(_num_factory(calls), ["d0", "d1", "d2"], artifact_ref="art1",
                           version="v0001", on_event=lambda kind, **f: events.append((kind, f)))
        mon = CanaryMonitor(_mcfg(min_samples=5, healthy_evals=2, eval_interval_s=0.02),
                            priorities=1, on_event=lambda kind, **f: events.append((kind, f)))
        stop, feeder_stop = threading.Event(), threading.Event()
        t = threading.Thread(target=_drive, args=(pool, stop, answered), daemon=True)
        t.start()

        def feeder():
            seen = 0
            while not feeder_stop.is_set():
                while seen < len(answered):
                    mon.record_served(0, 1.0, answered[seen][1])
                    seen += 1
                time.sleep(0.01)

        ft = threading.Thread(target=feeder, daemon=True)
        ft.start()
        try:
            status = pool.canary_swap("art2", "v0002", mon, fraction=0.5, canary_replicas=1,
                                      shadow_every=4, seed=7)
        finally:
            feeder_stop.set()
            ft.join(2)
            stop.set()
            t.join(2)
        assert status["state"] == SWAP_DONE
        can = status["canary"]
        assert can["decision"] == PROMOTE and can["rollbacks"] == 0 and can["promote_s"] > 0
        assert {v for _, v in answered if v is not None} == {"v0001", "v0002"}
        assert pool.version == "v0002"
        stats = pool.stats()
        assert all(r["version"] == "v0002" and not r["canary"] for r in stats["replicas"])
        # shadow duplicates count in no serving ledger
        assert sum(stats["completed_by_version"].values()) == len(answered)
        assert can["shadow"]["compared"] > 0 and can["shadow"]["max_abs_drift"] == 0.0
        phases = [f.get("phase") for k, f in events if k == "canary"]
        for expected in ("start", "observing", "evaluate", "promote"):
            assert expected in phases, phases
        assert pool.drain(10)

    def test_logit_drift_detected_rolls_back_and_restores_vn(self):
        """The same rollback on both packages' pools: equal outcomes, and
        ``shadow`` / ``swap`` / ``canary`` events with the reference's
        fields."""
        out = {}
        for mod, pool_mod in ((tcanary, None), (jcanary, jpool)):
            events, calls, answered = [], [], []
            cls = ReplicaPool if pool_mod is None else pool_mod.ReplicaPool
            pool = cls(_num_factory(calls, eps_by_ref={"art2": 0.25}), ["d0", "d1"],
                       artifact_ref="art1", version="v0001",
                       on_event=lambda kind, **f: events.append((kind, f)))
            mon = mod.CanaryMonitor(_cfg(mod, min_samples=5, healthy_evals=50,
                                         eval_interval_s=0.02), priorities=1)
            stop = threading.Event()
            t = threading.Thread(target=_drive, args=(pool, stop, answered), daemon=True)
            t.start()
            try:
                status = pool.canary_swap("art2", "v0002", mon, fraction=0.3, canary_replicas=1,
                                          shadow_every=1, seed=3)
            finally:
                stop.set()
                t.join(2)
            assert pool.version == "v0001"
            assert all(r["version"] == "v0001" and not r["canary"]
                       for r in pool.stats()["replicas"])
            assert ("art1", "d1") in calls[2:]  # the rollback rebuild
            assert pool.submit([5.0]).result(5)[0][0] == pytest.approx(5.0)
            assert pool.drain(10)
            out[mod] = (status, events)
        (status, events), (jstatus, jevents) = out[tcanary], out[jcanary]
        assert status["state"] == jstatus["state"] == SWAP_ROLLED_BACK
        can = status["canary"]
        assert (can["decision"], can["trigger"], can["rollbacks"], can["promote_s"]) == \
            (ROLLBACK, "logit_drift", 1, None)
        assert set(can) == set(jstatus["canary"])
        assert can["shadow"]["max_abs_drift"] == pytest.approx(0.25, abs=1e-6)

        def fields(evs):
            out = {}
            for kind, f in evs:
                out.setdefault((kind, f.get("phase")), set()).update(f)
            return out

        got, want = fields(events), fields(jevents)
        assert set(got) == set(want)
        assert got == want
        assert ("shadow", "mirror") in got and ("swap", "rolled_back") in got
        drifts = [f["drift"] for k, f in events if k == "shadow"]
        assert drifts and all(d == pytest.approx(0.25, abs=1e-6) for d in drifts)

    def test_inconclusive_timeout_rolls_back(self):
        pool = ReplicaPool(_num_factory(), ["d0", "d1"], artifact_ref="art1", version="v0001")
        mon = CanaryMonitor(_mcfg(max_wait_s=0.3, eval_interval_s=0.05), priorities=1)
        status = pool.canary_swap("art2", "v0002", mon, fraction=0.5, canary_replicas=1)
        assert status["state"] == SWAP_ROLLED_BACK
        assert status["canary"]["trigger"] == INCONCLUSIVE
        assert pool.version == "v0001"
        assert pool.drain(10)

    def test_drain_mid_canary_aborts_honestly(self):
        pool = ReplicaPool(_num_factory(), ["d0", "d1"], artifact_ref="art1", version="v0001")
        mon = CanaryMonitor(_mcfg(max_wait_s=30.0, eval_interval_s=0.05), priorities=1)
        out = {}
        t = threading.Thread(target=lambda: out.update(status=pool.canary_swap(
            "art2", "v0002", mon, fraction=0.5, canary_replicas=1)), daemon=True)
        t.start()
        time.sleep(0.3)
        assert pool.drain(10)
        t.join(5)
        assert out["status"]["state"] == SWAP_FAILED
        assert "drained mid-canary" in out["status"]["error"]

    def test_canary_needs_an_incumbent_replica(self):
        pool = ReplicaPool(_num_factory(), ["d0", "d1"], artifact_ref="art1", version="v0001")
        with pytest.raises(ValueError, match="incumbent replica"):
            pool.canary_swap("art2", "v0002", CanaryMonitor(_mcfg(), priorities=1),
                             fraction=0.5, canary_replicas=2)
        assert pool.drain(10)

    def test_failed_canary_standby_keeps_vn_serving(self):
        def factory(ref, device):
            if ref == "bad":
                raise RuntimeError("corrupt artifact")
            return _num_factory()(ref, device)

        pool = ReplicaPool(factory, ["d0", "d1"], artifact_ref="art1", version="v0001")
        with pytest.raises(RuntimeError, match="corrupt artifact"):
            pool.canary_swap("bad", "v0002", CanaryMonitor(_mcfg(), priorities=1),
                             fraction=0.5, canary_replicas=1)
        assert pool.swap_status()["state"] == SWAP_FAILED
        assert pool.version == "v0001"
        assert pool.submit([1.0]).result(5)[0][0] == pytest.approx(1.0)
        assert pool.drain(10)

    def test_admin_routes_rollout_through_canary(self, tmp_path):
        art = tmp_path / "art_dir"
        art.mkdir()
        pool = ReplicaPool(_num_factory(eps_by_ref={str(art): 0.5}), ["d0", "d1"],
                           artifact_ref="art1", version="v0001")
        mon = CanaryMonitor(_mcfg(min_samples=3, healthy_evals=50, eval_interval_s=0.02),
                            priorities=1)
        admin = PoolAdmin(pool, canary={"monitor": mon, "fraction": 0.4, "replicas": 1,
                                        "shadow_every": 1, "seed": 1})
        assert admin.start_swap({"artifact": str(art)})[0] == 202
        stop, answered = threading.Event(), []
        t = threading.Thread(target=_drive, args=(pool, stop, answered), daemon=True)
        t.start()
        try:
            assert admin.wait(20)
        finally:
            stop.set()
            t.join(2)
        report = admin.swap_report()
        assert report["performed"] is False and report["state"] == SWAP_ROLLED_BACK
        assert admin.canary_report()["trigger"] == "logit_drift"
        assert pool.version == "v0001"
        assert pool.drain(10)

    def test_one_replica_swap_answers_everything_with_one_version_each(self):
        """A blue/green swap on one replica (one card): the standby is
        warmed first, every submitted batch is answered by exactly one
        version or shed explicitly while the replica shifts."""
        pool = ReplicaPool(_num_factory(eps_by_ref={"art2": 1.0}), ["d0"], artifact_ref="art1",
                           version="v0001")
        admin = PoolAdmin(pool, shed_counter=lambda: pool.stats()["shed_requests"])
        stop, answered = threading.Event(), []
        t = threading.Thread(target=_drive, args=(pool, stop, answered), daemon=True)
        t.start()
        try:
            time.sleep(0.05)
            assert admin.start_swap({"artifact": "art2"})[0] == 404  # not a dir
            pool.swap("art2", "v0002")
            time.sleep(0.05)
        finally:
            stop.set()
            t.join(2)
        assert pool.swap_status()["state"] == SWAP_DONE and pool.version == "v0002"
        stats = pool.stats()
        assert {v for _, v in answered} == {"v0001", "v0002"}
        assert sum(stats["completed_by_version"].values()) == len(answered)
        assert pool.submit([3.0]).result(5)[0][0] == pytest.approx(4.0)
        assert pool.drain(10)


# ---------------------------------------------------------------------------
# degradation hook


class TestDegradationHook:
    def test_disabled_hook_is_zero_cost_plain_runner(self):
        assert not hasattr(make_engine_runner_factory((4,), pace_ms=1.0)("art", "d0"),
                           "degraded")
        f2 = make_engine_runner_factory((4,), pace_ms=1.0,
                                        degrade={"artifact": "other", "latency_ms": 100})
        assert not hasattr(f2("art", "d0"), "degraded")
        f3 = make_engine_runner_factory((4,), pace_ms=1.0, degrade={"latency_ms": 0})
        assert not hasattr(f3("art", "d0"), "degraded")

    def test_latency_injection_observable_through_a_real_pool(self):
        factory = make_engine_runner_factory((4,), pace_ms=1.0,
                                             degrade={"artifact": "art", "latency_ms": 80})
        pool = ReplicaPool(factory, ["paced:0"], artifact_ref="art", version="v0001")
        t0 = time.monotonic()
        pool.submit([1.0]).result(10)
        assert time.monotonic() - t0 >= 0.08
        assert pool.drain(10)

    def test_error_injection_ledgers_as_failed(self):
        factory = make_engine_runner_factory((4,), pace_ms=1.0,
                                             degrade={"artifact": "art", "error_rate": 1.0})
        pool = ReplicaPool(factory, ["paced:0"], artifact_ref="art", version="v0001")
        with pytest.raises(RuntimeError, match="injected engine"):
            pool.submit([1.0, 2.0]).result(10)
        assert pool.stats()["failed_by_version"] == {"v0001": 2}
        assert pool.drain(10)

    def test_logit_perturbation_exact_and_per_payload(self, port_artifact):  # noqa: F811
        import torch

        rng = np.random.default_rng(0)
        imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32) for _ in range(3)]
        imgs[1][0, 0, 0] = 99.0  # the marked payload
        cpu = torch.device("cpu")
        plain = make_engine_runner_factory((4,))(port_artifact, cpu)
        degraded = make_engine_runner_factory((4,), degrade={
            "artifact": port_artifact, "logit_eps": 0.25,
            "match": lambda p: float(np.asarray(p)[0, 0, 0]) > 50.0})(port_artifact, cpu)
        assert degraded.degraded is True
        a, b = np.asarray(plain(imgs)), np.stack(degraded(imgs))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[2], b[2])
        assert np.array_equal(a[1] + np.float32(0.25), b[1])

    def test_no_injection_pin_bitwise_logits(self, port_artifact):  # noqa: F811
        import torch

        from bdbnn_tpu_torch.serve.engine import InferenceEngine

        rng = np.random.default_rng(1)
        imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32) for _ in range(2)]
        factory = make_engine_runner_factory((4,))
        runner = factory(port_artifact, torch.device("cpu"))
        engine = InferenceEngine(port_artifact, buckets=(4,), device="cpu")
        assert np.array_equal(np.asarray(runner(list(imgs))), engine.predict_logits(np.stack(imgs)))
        # the factory counts its engine's forwards: the warmup's and this one
        assert factory.forwards() == engine.forwards

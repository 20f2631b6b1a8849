"""The port's request tracer (``bdbnn_tpu_torch/obs/rtrace.py``) against
the JAX package's (``bdbnn_tpu/obs/rtrace.py``), and its behaviour over
the port's micro-batcher and replica pool.

- Exact parity: the sampling hash and trace ids, and the waterfalls,
  ``stats()`` and ``attribution()`` of both tracers fed the same
  scripted requests on one scripted clock, compared with ``==``.
- Mirrors of the reference's trace-arithmetic, sampling/tail and
  empty-stage tests (``tests/test_rtrace.py``), on the port.
- The reconciliation identity (stage sum == end-to-end latency) over the
  port's batcher on the sync runner path and the pool's async path.
- The fleet half, exact parity on one scripted clock: ``FleetTracer``'s
  stitching (stitched, unstitched and mismatched stage headers, retry
  hops, aborts, several hosts), its waterfalls, ``stats()`` and
  ``attribution()``; ``HostStatsWindows`` fed the same scrapes and
  failures, its snapshot after every step (staleness included).
"""

import json
import time

import pytest

from bdbnn_tpu.obs import rtrace as jrtrace
from bdbnn_tpu_torch.obs import rtrace as trtrace
from bdbnn_tpu_torch.obs.rtrace import (
    RECON_TOL_PCT,
    STAGES,
    RequestTracer,
    pop_future_timing,
    set_future_timing,
)
from bdbnn_tpu_torch.serve.batching import MicroBatcher
from bdbnn_tpu_torch.serve.loadgen import LoadGenerator, slo_verdict


def _finish_exact(tracer, priority, stages_ms):
    """One synthetic request whose end-to-end total equals its stage sum
    (the cursor pinned to t0 + sum)."""
    tr = tracer.begin(priority)
    for stage, ms in stages_ms.items():
        tr.add(stage, ms)
    tr._last = tr.t0 + sum(stages_ms.values()) / 1000.0
    tracer.finish(tr)
    return tr


class _Clock:
    """A scripted ``time.perf_counter``: each read advances 0.5 ms plus
    the next scripted extra."""

    def __init__(self, extras):
        self.t = 100.0
        self.extras = list(extras)

    def __call__(self):
        self.t += 0.0005 + (self.extras.pop(0) if self.extras else 0.0)
        return self.t


def _scripted_run(mod, monkeypatch):
    """The same 23 requests through ``mod.RequestTracer`` on a scripted
    clock: stamped queue/coalesce stages, added dispatch/compute splits,
    two priorities, one abort; returns every report the tracer gives."""
    monkeypatch.setattr(time, "perf_counter", _Clock([0.001 * (i % 7) for i in range(400)]))
    sampled = []
    tracer = mod.RequestTracer(seed=11, sample_every=3, tail_k=4, window=16,
                               on_sample=sampled.append)
    waterfalls = []
    for i in range(23):
        tr = tracer.begin(i % 2, "tenant-a" if i % 3 else None)
        tr.stamp("queue")
        tr.stamp("coalesce")
        if i % 4:
            tr.add("dispatch", 0.25 * i)
            tr.add("compute", 3.0 + 0.5 * (i % 5))
            tr.sync()
        else:
            tr.stamp("compute")
        if i == 13:
            tracer.abort(tr)
            continue
        tracer.finish(tr)
        waterfalls.append(tr.waterfall())
    att = tracer.attribution(device={"time_step_ms": 1.5, "calls": 3})
    return {"waterfalls": waterfalls, "sampled": sampled, "stats": tracer.stats(),
            "attribution": att}


class TestParityWithReference:
    def test_sampling_hash_and_trace_ids(self):
        for seed in (0, 7, 2**40 + 3):
            assert [trtrace._splitmix64(seed ^ i) for i in range(300)] == [
                jrtrace._splitmix64(seed ^ i) for i in range(300)
            ]
            assert [trtrace.mint_trace_id(seed, i) for i in range(50)] == [
                jrtrace.mint_trace_id(seed, i) for i in range(50)
            ]
            t = trtrace.RequestTracer(seed=seed, sample_every=5)
            j = jrtrace.RequestTracer(seed=seed, sample_every=5)
            assert [t._keep(i) for i in range(300)] == [j._keep(i) for i in range(300)]
        assert trtrace.STAGES == jrtrace.STAGES
        assert (trtrace.RECON_TOL_PCT, trtrace.RECON_FLOOR_MS) == (
            jrtrace.RECON_TOL_PCT, jrtrace.RECON_FLOOR_MS
        )

    def test_waterfalls_stats_attribution_equal_on_scripted_stamps(self, monkeypatch):
        port = _scripted_run(trtrace, monkeypatch)
        ref = _scripted_run(jrtrace, monkeypatch)
        assert port == ref
        # the script exercises both priorities, the abort and the tail
        att = port["attribution"]
        assert att["requests"] == 22 and att["aborted"] == 1
        assert set(att["tail"]) == {"0", "1"} and len(att["tail"]["0"]) == 4
        assert att["stages"]["dispatch"] is not None and port["sampled"]
        json.dumps(att, allow_nan=False)

    def test_empty_tracer_reports_equal(self):
        t, j = trtrace.RequestTracer(seed=3), jrtrace.RequestTracer(seed=3)
        assert t.stats() == j.stats()
        assert t.attribution() == j.attribution()


class TestTraceArithmetic:
    def test_stamp_charges_gap_and_advances(self):
        tr = RequestTracer(seed=0).begin(1, "tenant-x")
        time.sleep(0.005)
        tr.stamp("read")
        assert tr.stages["read"] >= 4.0
        t_after_read = tr._last
        tr.stamp("admit")
        assert tr.stages["admit"] < tr.stages["read"]
        assert tr._last >= t_after_read

    def test_add_does_not_advance_cursor(self):
        tr = RequestTracer(seed=0).begin(0)
        cursor = tr._last
        tr.add("dispatch", 3.5)
        tr.add("compute", 7.25)
        assert tr._last == cursor
        assert tr.stages == {"dispatch": 3.5, "compute": 7.25}
        tr.sync()
        assert tr._last > cursor

    def test_waterfall_shape_and_stage_order(self):
        tr = RequestTracer(seed=0).begin(2, "t")
        tr.stamp("read")
        tr.add("compute", 1.0)
        wf = tr.waterfall()
        assert wf["priority"] == 2 and wf["tenant"] == "t"
        assert list(wf["stages"]) == [s for s in STAGES if s in wf["stages"]] == ["read", "compute"]

    def test_begin_seq_is_unique_and_monotone(self):
        tracer = RequestTracer(seed=0)
        assert [tracer.begin(0).seq for _ in range(10)] == list(range(10))


class TestSamplingAndTail:
    def test_sampling_is_deterministic_per_seed(self):
        kept = lambda seed: [RequestTracer(seed=seed, sample_every=4)._keep(i) for i in range(200)]
        assert kept(7) == kept(7)
        assert kept(7) != kept(8)
        assert 20 <= sum(kept(7)) <= 80

    def test_sample_every_one_keeps_everything(self):
        hits = []
        tracer = RequestTracer(seed=0, sample_every=1, on_sample=hits.append)
        for _ in range(5):
            _finish_exact(tracer, 0, {"queue": 1.0, "compute": 2.0})
        assert len(hits) == 5 and tracer.sampled == 5

    def test_tail_keeps_slowest_k_regardless_of_sampling(self):
        tracer = RequestTracer(seed=0, sample_every=10**6, tail_k=3)
        for t in (5.0, 50.0, 1.0, 30.0, 2.0, 40.0, 3.0):
            _finish_exact(tracer, 0, {"compute": t})
        att = tracer.attribution()
        assert [wf["total_ms"] for wf in att["tail"]["0"]] == [50.0, 40.0, 30.0]
        assert att["sampled"] == 0

    def test_aborted_requests_stay_out_of_histograms(self):
        tracer = RequestTracer(seed=0)
        tr = tracer.begin(0)
        tr.stamp("read")
        tracer.abort(tr)
        assert tracer.aborted == 1 and tracer.finished == 0
        assert tracer.attribution()["stages"]["read"] is None


class TestEmptyStageNull:
    def test_empty_stage_window_lands_null_never_typeerror(self):
        tracer = RequestTracer(seed=0)
        att = tracer.attribution()
        assert all(att["stages"][s] is None for s in STAGES)
        assert att["reconciliation"]["ok"] is None and att["queue_share"] is None
        json.dumps(att, allow_nan=False)
        _finish_exact(tracer, 0, {"queue": 1.0, "compute": 2.0})
        att = tracer.attribution()
        assert att["stages"]["dispatch"] is None
        assert att["stages"]["queue"]["p99_ms"] == 1.0
        v = slo_verdict(
            {"submitted": 1, "completed": 1, "shed": 0, "wall_s": 1.0, "latencies_ms": [3.0]},
            {}, mode="open", rate=1.0, seed=0, attribution=att,
        )
        parsed = json.loads(json.dumps(v, allow_nan=False),
                            parse_constant=lambda s: pytest.fail(f"bare {s}"))
        assert parsed["attribution"]["stages"]["dispatch"] is None

    def test_stats_snapshot_is_strict_json_safe(self):
        s = RequestTracer(seed=0).stats()
        assert s["queue_share"] is None
        json.dumps(s, allow_nan=False)


class TestReconciliation:
    def test_sync_runner_path(self):
        tracer = RequestTracer(seed=0, sample_every=1, tail_k=5)

        def runner(batch):
            time.sleep(0.02)
            return list(batch)

        b = MicroBatcher(runner, max_batch=8, max_queue=64, max_delay_ms=2.0)
        gen = LoadGenerator(tracer.bind(b.submit), lambda i: i, mode="open", requests=40,
                            rate=400.0, seed=0)
        raw = gen.run()
        assert b.drain(timeout=30.0)
        assert raw["completed"] == 40
        att = tracer.attribution()
        recon = att["reconciliation"]
        assert recon["requests"] == 40 and recon["ok"] is True, recon
        for stage in ("queue", "coalesce", "compute"):
            assert att["stages"][stage] is not None
        assert att["stages"]["dispatch"] is None  # no pool, no hop
        for wf in att["tail"]["0"]:
            assert sum(wf["stages"].values()) == pytest.approx(
                wf["total_ms"], rel=RECON_TOL_PCT / 100.0, abs=0.5)

    def test_pool_async_path_splits_dispatch_and_compute(self):
        from bdbnn_tpu_torch.serve.pool import ReplicaPool

        tracer = RequestTracer(seed=0, sample_every=1, tail_k=5)

        def factory(ref, dev):
            def r(payloads):
                time.sleep(0.01)
                return list(payloads)

            return r

        pool = ReplicaPool(factory, ["d0", "d1"], max_queue_batches=4)
        b = MicroBatcher(pool.submit, max_batch=4, max_queue=64, max_delay_ms=1.0,
                         max_pending_batches=4)
        gen = LoadGenerator(tracer.bind(b.submit), lambda i: i, mode="open", requests=40,
                            rate=600.0, seed=1)
        raw = gen.run()
        assert b.drain(timeout=30.0) and pool.drain(timeout=30.0)
        assert raw["completed"] == 40
        att = tracer.attribution()
        assert att["stages"]["dispatch"] is not None and att["stages"]["compute"] is not None
        assert att["reconciliation"]["ok"] is True, att["reconciliation"]

    def test_future_timing_handoff_is_consumed_once(self):
        from concurrent.futures import Future

        fut = Future()
        set_future_timing(fut, 1.5, 2.5)
        assert pop_future_timing(fut) == (1.5, 2.5)
        assert pop_future_timing(fut) is None


# ---------------------------------------------------------------------------
# the fleet half: FleetTracer and HostStatsWindows
# ---------------------------------------------------------------------------


def _fleet_script(mod, monkeypatch):
    """The same 31 proxied requests through ``mod.FleetTracer`` on a
    scripted clock: router stamps, a measured connect, 0-2 retry hops,
    the backend's stage header stitched (matching id), missing, garbled
    or naming another trace, three hosts, two priorities, two aborts;
    returns every report the tracer gives."""
    monkeypatch.setattr(time, "perf_counter", _Clock([0.0007 * (i % 5) for i in range(900)]))
    sampled = []
    tracer = mod.FleetTracer(seed=5, sample_every=4, tail_k=3, window=8,
                             on_sample=sampled.append)
    waterfalls = []
    for i in range(31):
        tr = tracer.begin(i % 2, "tenant-b" if i % 3 else None)
        tr.stamp("probe_wait")
        tr.stamp("pick")
        for _ in range(i % 3 if i % 5 == 0 else 0):
            tr.stamp("retry_hop")
            tr.stamp("pick")
        if i in (9, 22):
            tracer.abort(tr)
            continue
        tr.add("connect", 0.05 * (i % 4))
        tr.attempts = 1 + (i % 3 if i % 5 == 0 else 0)
        stages = {"read": 0.2, "admit": 0.01 * i, "queue": 1.5 + (i % 6), "compute": 4.0}
        header = mod.encode_stage_header(tr.trace_id, sum(stages.values()) + 0.3, stages)
        if i % 7 == 3:
            header = None
        elif i % 11 == 4:
            header = "v=1;garbled"
        elif i % 13 == 6:
            header = mod.encode_stage_header(mod.mint_trace_id(99, i), 9.0, stages)
        exchange = 12.0 + (i % 9)
        tracer.stitch(tr, exchange, header, f"h{i % 3}")
        tr.sync()
        tracer.finish(tr)
        waterfalls.append(tr.waterfall())
    return {"waterfalls": waterfalls, "sampled": sampled, "stats": tracer.stats(),
            "attribution": tracer.attribution(device={"busy": 0.1})}


def _windows_script(mod, monkeypatch):
    """``mod.HostStatsWindows`` fed the same scrapes (finite, non-finite
    and non-numeric p99s, a non-dict block) and failures for three hosts
    on a scripted clock; the snapshot after every step."""
    clock = _Clock([0.01 * (i % 3) for i in range(400)])
    monkeypatch.setattr(time, "perf_counter", clock)
    win = mod.HostStatsWindows(window=4, stale_after=2)
    snaps = []
    for i in range(18):
        host = f"h{i % 3}"
        if i % 5 == 4 or (host == "h2" and i > 9):
            win.record_failure(host)
        elif i == 7:
            win.record(host, "not a block")
        else:
            win.record(host, {
                "stage_p99_ms": {"queue": 1.0 + i, "compute": 4.0 + 0.5 * (i % 4),
                                 "read": float("nan") if i == 3 else 0.5, "admit": "x"},
                "e2e_p99_ms_by_priority": {"0": 6.0 + i, "2": 9.0, "1": None},
                "queue_share": 0.1 * (i % 4),
            })
        snaps.append(win.snapshot())
    return snaps


class TestFleetParity:
    def test_fleet_tracer_equals_the_reference(self, monkeypatch):
        assert trtrace.FLEET_STAGES == jrtrace.FLEET_STAGES
        port = _fleet_script(trtrace, monkeypatch)
        ref = _fleet_script(jrtrace, monkeypatch)
        assert port == ref
        att = port["attribution"]
        assert att["requests"] == 29 and att["aborted"] == 2
        assert 0 < att["stitched"] < att["requests"] and att["unstitched"] > 0
        assert att["retry_hop_share"] > 0 and set(att["per_host"]) == {"h0", "h1", "h2"}
        assert att["reconciliation"]["requests"] == 29 and port["sampled"]
        assert any(w["backend"] is None for w in port["waterfalls"])
        json.dumps(att, allow_nan=False)

    def test_empty_fleet_tracer_reports_equal(self):
        t, j = trtrace.FleetTracer(seed=2), jrtrace.FleetTracer(seed=2)
        assert t.stats() == j.stats()
        assert t.attribution() == j.attribution()
        assert t.stats()["retry_hop_share"] is None

    def test_host_stats_windows_equal_the_reference(self, monkeypatch):
        port = _windows_script(trtrace, monkeypatch)
        ref = _windows_script(jrtrace, monkeypatch)
        assert port == ref
        last = port[-1]
        assert last["hosts"]["h2"]["stale"] is True and last["hosts_stale"] >= 1
        assert last["merged"]["stage_p99_ms"]["queue"] is not None
        json.dumps(last, allow_nan=False)

    @pytest.mark.parametrize("kw", [dict(window=0), dict(stale_after=0)])
    def test_host_stats_windows_refusals_equal_the_reference(self, kw):
        msgs = []
        for mod in (trtrace, jrtrace):
            with pytest.raises(ValueError) as e:
                mod.HostStatsWindows(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

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

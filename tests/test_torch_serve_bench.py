"""``serve-bench`` on the port (``bdbnn_tpu_torch/serve/``) against the
JAX package, on the CPU (the kernels' plain versions).

- Exact parity (``==``): ``slo_verdict`` on one raw dict and batcher
  stats with each optional block set and null, ``percentile``, the
  open loop's scheduled arrivals for a seed, ``ServeBenchConfig``'s
  refusals, and the engine's ``residency()`` (dense and packed, the
  activation working sets included).
- Mirrors of the reference's ``TestMicroBatcher`` and ``TestLoadGen``
  (``tests/test_serve.py``) on the port.
- The two thread faults a serving pool exposes, repaired: engines of
  the two packed impls on two threads at once each reach only their own
  plain path and answer bitwise what they answer alone; the kernels'
  launch counters add exactly under threads.
- End to end: ``run_serve_bench(device="cpu")`` keeps the reference's
  invariants and its verdict has the reference's keys and schema; every
  answer through the batcher and the load generator is the engine's own
  bitwise and within 2e-5 of the largest |logit| of the JAX engine's;
  SIGTERM drains; the CLI exits 0 with ``--device cpu`` and raises
  without it; the reference's ``summarize``, ``watch`` and ``compare``
  read the port's run dir and verdicts.
"""

import json
import os
import signal
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from bdbnn_tpu.configs.config import ServeBenchConfig as JConfig
from bdbnn_tpu.serve import engine as jengine
from bdbnn_tpu.serve import loadgen as jloadgen
from bdbnn_tpu_torch.serve import engine as tengine
from bdbnn_tpu_torch.serve import loadgen as tloadgen
from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher
from bdbnn_tpu_torch.serve.config import ServeBenchConfig as TConfig
from bdbnn_tpu_torch.serve.loadgen import LoadGenerator, percentile, slo_verdict

from test_torch_serve import _images, port_artifact  # noqa: F401  (fixture)

# ---------------------------------------------------------------------------
# exact parity with the JAX package
# ---------------------------------------------------------------------------

_RAW = {"submitted": 10, "completed": 7, "shed": 2, "failed": 1, "wall_s": 0.5,
        "latencies_ms": [1.0, 2.5, 3.0, 4.0, 5.25, 6.0, 7.0]}
_STATS = {"mean_occupancy": 0.5, "batches": 4, "max_queue_depth_seen": 3, "max_queue": 8}
_BLOCKS = {
    "scenario": "poisson",
    "per_priority": {"0": {"submitted": 5, "p99_ms": 4.0}},
    "per_tenant": {"a": {"submitted": 5, "completed": 5, "shed_rate": 0.0}},
    "fairness": 1.25,
    "client": {"dropped": 0},
    "slo": {"p99_ms": 10.0, "met": True},
    "replicas": {"n": 2, "per_replica": []},
    "scaling": {"replicas": [1, 2], "efficiency": 0.97, "monotone": True},
    "swap": {"performed": False},
    "resident": {"bytes_per_model_max": 3544},
    "packed": {"resident_ratio": 6.106, "step_ms_delta_pct": float("nan")},
    "attribution": {"requests": 7, "stages": {"queue": None}},
    "canary": {"decision": "promote"},
    "fleet": {"dropped": 0},
    "fleet_attribution": {"stitched": 7},
    "capacity": {"headroom_rps": 12.0},
}


@pytest.mark.parametrize("blocks", ["null", "set"])
def test_slo_verdict_equals_the_reference(blocks):
    kw = dict(mode="open", rate=100.0, seed=7, provenance={"arch": "resnet8_tiny"},
              warmup_s={1: 0.25, 4: 0.5}, preempted=True, drained_clean=False)
    if blocks == "set":
        kw.update(_BLOCKS)
    got = slo_verdict(dict(_RAW), dict(_STATS), **kw)
    assert got == jloadgen.slo_verdict(dict(_RAW), dict(_STATS), **kw)
    assert got["serve_verdict"] == tloadgen.VERDICT_SCHEMA_VERSION == jloadgen.VERDICT_SCHEMA_VERSION
    json.dumps(got, allow_nan=False)
    if blocks == "null":
        assert all(got[k] is None for k in ("scaling", "packed", "attribution", "fleet", "capacity"))


def test_percentile_equals_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        vals = sorted(rng.normal(size=n).tolist())
        for q in (0.0, 1.0, 50.0, 95.0, 99.0, 99.9, 100.0):
            assert percentile(vals, q) == jloadgen.percentile(vals, q)
            assert tloadgen._pct(vals, q) == jloadgen._pct(vals, q)
    with pytest.raises(ValueError, match="percentile q"):
        percentile([1.0], 101.0)


def _scheduled_arrivals(mod, monkeypatch, seed, rate, n):
    """The open loop's scheduled arrival times (the latency clock's
    start) on a frozen clock with no sleeping."""
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.0)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    seen = []

    class Recording(mod.LoadGenerator):
        def _one(self, i, wait, t0=None):
            seen.append((i, t0))

    Recording(lambda p: None, lambda i: i, mode="open", requests=n, rate=rate, seed=seed).run()
    return seen


@pytest.mark.parametrize("seed,rate", [(0, 100.0), (3, 1234.5)])
def test_open_loop_arrivals_equal_the_reference(monkeypatch, seed, rate):
    got = _scheduled_arrivals(tloadgen, monkeypatch, seed, rate, 64)
    assert got == _scheduled_arrivals(jloadgen, monkeypatch, seed, rate, 64)
    assert [i for i, _ in got] == list(range(64))


_BAD = [
    dict(mode="swarm"), dict(buckets=(0,)), dict(buckets=()), dict(queue_depth=0),
    dict(rate=0.0), dict(artifact=""), dict(requests=0), dict(concurrency=0),
    dict(max_delay_ms=-1.0), dict(events_max_mb=-1.0), dict(replicas=(0,)), dict(replicas=()),
    dict(pace_ms=-1.0), dict(replica_queue_batches=0), dict(wedge_timeout_s=0),
    dict(packed_weights="maybe"), dict(packed_impl="int8"),
    dict(packed_weights="ab", replicas=(1, 2)), dict(packed_weights="ab", pace_ms=5.0),
    dict(rtrace_sample_every=0), dict(rtrace_tail_k=-1),
]


def test_config_defaults_and_refusals_equal_the_reference():
    import dataclasses

    t, j = TConfig(artifact="a").validate(), JConfig(artifact="a").validate()
    tf = dataclasses.asdict(t)
    assert tf.pop("device") is None
    assert tf == dataclasses.asdict(j)
    for bad in _BAD:
        kw = {"artifact": "a", **bad}
        with pytest.raises(ValueError) as te:
            TConfig(**kw).validate()
        with pytest.raises(ValueError) as je:
            JConfig(**kw).validate()
        assert str(te.value) == str(je.value), bad


@pytest.mark.parametrize("packed", [False, True])
def test_residency_equals_the_reference_engine(port_artifact, packed):  # noqa: F811
    """Every byte the port's model keeps (parameters and buffers) is
    counted, and the integers are the reference's: the port keeps no
    byte beyond the reference's variables."""
    port = tengine.InferenceEngine(port_artifact, buckets=(1, 4), device="cpu", packed=packed)
    ref = jengine.InferenceEngine(port_artifact, buckets=(1, 4), packed=packed)
    got, want = port.residency(), ref.residency()
    assert got == want
    assert got["packed"] is packed and got["ratio"] > 5.0
    assert set(got["activations"]) == {"1", "4"}
    assert got["activations"]["4"]["bytes_in"] == 4 * got["activations"]["1"]["bytes_in"]


def test_residency_of_a_cold_engine_warms_it(port_artifact):  # noqa: F811
    e = tengine.InferenceEngine(port_artifact, buckets=(2,), device="cpu", warm=False)
    assert not e.warmed and e.forwards == 0
    r = e.residency()
    assert e.warmed and e.forwards == 1
    assert r["activations"]["2"]["per_conv"]["fc"] == {"in": 2 * 16 * 4, "out": 2 * 10 * 4}


# ---------------------------------------------------------------------------
# the thread faults a serving pool exposes
# ---------------------------------------------------------------------------


def test_two_packed_impls_on_two_threads_keep_their_own_paths(port_artifact, monkeypatch):  # noqa: F811
    """An unpack engine and a popcount engine, 50 forwards each, on two
    threads at once with a short switch interval: each thread reaches
    only its own plain path (the plain functions wrapped to count by
    thread), and its logits are bitwise what it computes alone. The
    impl is bound to each engine's convs at build; a process-wide
    switch entered per forward would let one thread's forward run some
    layers on the other's path."""
    from bdbnn_tpu_torch.nn import packed as tpacked
    from bdbnn_tpu_torch.nn.kernels import binary_conv as tconv

    engines = {impl: tengine.InferenceEngine(port_artifact, buckets=(2,), device="cpu",
                                             packed=True, packed_impl=impl)
               for impl in ("unpack", "popcount")}
    x = _images(2, 9)
    alone = {impl: e.predict_logits(x) for impl, e in engines.items()}
    calls = {}
    lock = threading.Lock()

    def counted(name, fn):
        def wrapper(*a, **k):
            with lock:
                key = (threading.current_thread().name, name)
                calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)

        return wrapper

    monkeypatch.setattr(tconv, "binary_conv2d_plain",
                        counted("binary_conv2d", tconv.binary_conv2d_plain))
    monkeypatch.setattr(tpacked, "popcount_binary_conv_plain",
                        counted("popcount", tpacked.popcount_binary_conv_plain))
    results = {impl: [] for impl in engines}
    start = threading.Barrier(2)

    def serve(impl):
        start.wait(timeout=30)
        for _ in range(50):
            results[impl].append(engines[impl].predict_logits(x))

    threads = [threading.Thread(target=serve, args=(impl,), name=impl) for impl in engines]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    convs = 5  # resnet8_tiny's binary convs
    assert calls == {("unpack", "binary_conv2d"): 50 * convs, ("popcount", "popcount"): 50 * convs}
    for impl, outs in results.items():
        assert len(outs) == 50
        for out in outs:
            np.testing.assert_array_equal(out.view(np.uint32), alone[impl].view(np.uint32))


def test_launch_counts_add_exactly_under_threads():
    from bdbnn_tpu_torch.nn.kernels import _build

    def fn():
        pass

    fn.launches = 0
    fn.launches_bf16 = 0

    def bump():
        for i in range(2000):
            _build.count_launch(fn, bf16=bool(i % 2))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert (fn.launches, fn.launches_bf16) == (16000, 8000)


# ---------------------------------------------------------------------------
# micro-batcher and load generator (mirrors of the reference's tests)
# ---------------------------------------------------------------------------


class TestMicroBatcher:
    def test_coalesces_under_deadline(self):
        seen = []

        def runner(batch):
            seen.append(len(batch))
            return batch

        b = MicroBatcher(runner, max_batch=8, max_queue=32, max_delay_ms=50)
        futs = [b.submit(i) for i in range(8)]
        assert [f.result(timeout=5) for f in futs] == list(range(8))
        assert b.drain(timeout=5)
        assert sum(seen) == 8 and len(seen) <= 3
        assert b.stats()["completed"] == 8

    def test_bounded_queue_sheds_never_grows(self):
        release = threading.Event()

        def runner(batch):
            release.wait(10)
            return batch

        b = MicroBatcher(runner, max_batch=2, max_queue=4, max_delay_ms=0.0)
        futs, shed = [], 0
        for i in range(20):
            try:
                futs.append(b.submit(i))
            except LoadShedError:
                shed += 1
        assert shed > 0 and b.stats()["max_queue_depth_seen"] <= 4
        release.set()
        assert b.drain(timeout=5)
        assert all(f.done() and f.exception() is None for f in futs)
        s = b.stats()
        assert s["completed"] == len(futs) and s["shed"] == shed
        assert s["completed"] + s["shed"] == 20

    def test_drain_answers_all_inflight(self):
        def runner(batch):
            time.sleep(0.01)
            return batch

        b = MicroBatcher(runner, max_batch=4, max_queue=64, max_delay_ms=1)
        futs = [b.submit(i) for i in range(32)]
        assert b.drain(timeout=10)
        assert [f.result() for f in futs] == list(range(32))
        with pytest.raises(LoadShedError, match="draining"):
            b.submit(99)

    def test_cancelled_future_does_not_kill_worker(self):
        release = threading.Event()

        def runner(batch):
            release.wait(5)
            return batch

        b = MicroBatcher(runner, max_batch=2, max_queue=8, max_delay_ms=0.0)
        f1 = b.submit(1)
        time.sleep(0.05)
        f2 = b.submit(2)
        assert f2.cancel()
        release.set()
        assert f1.result(timeout=5) == 1
        assert b.submit(3).result(timeout=5) == 3
        assert b.drain(timeout=5)

    def test_runner_exception_fails_futures_not_worker(self):
        calls = []

        def runner(batch):
            calls.append(len(batch))
            if len(calls) == 1:
                raise RuntimeError("boom")
            return batch

        b = MicroBatcher(runner, max_batch=4, max_queue=8, max_delay_ms=1)
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(1).result(timeout=5)
        assert b.submit(2).result(timeout=5) == 2
        assert b.drain(timeout=5)

    def test_strict_priority_dequeue_and_per_class_bounds(self):
        release = threading.Event()
        executed = []

        def runner(batch):
            release.wait(10)
            executed.extend(batch)
            return batch

        b = MicroBatcher(runner, max_batch=1, max_queue=2, max_delay_ms=0.0, priorities=2)
        futs = [b.submit("wedge", priority=1)]
        time.sleep(0.05)
        futs += [b.submit(f"low{i}", priority=1) for i in range(2)]
        with pytest.raises(LoadShedError, match="queue full"):
            b.submit("low-overflow", priority=1)
        futs.append(b.submit("hi", priority=0))
        with pytest.raises(ValueError, match="priority"):
            b.submit("bad", priority=2)
        release.set()
        for f in futs:
            f.result(timeout=5)
        assert b.drain(timeout=5)
        assert executed[:2] == ["wedge", "hi"]
        s = b.stats()
        assert [p["shed"] for p in s["per_priority"]] == [0, 1]
        assert [p["completed"] for p in s["per_priority"]] == [1, 3]
        assert s["shed"] == 1 and s["completed"] == 4
        assert s["per_priority"][1]["max_queue_depth_seen"] == 2

    def test_single_priority_stats_backwards_compatible(self):
        b = MicroBatcher(lambda batch: batch, max_batch=4, max_queue=8)
        for f in [b.submit(i) for i in range(6)]:
            f.result(timeout=5)
        assert b.drain(timeout=5)
        s = b.stats()
        assert s["priorities"] == 1 and len(s["per_priority"]) == 1
        assert s["per_priority"][0]["completed"] == s["completed"] == 6


def _instant_submit(payload):
    f = Future()
    f.set_result(payload)
    return f


class TestLoadGen:
    def test_closed_loop_accounting(self):
        raw = LoadGenerator(_instant_submit, lambda i: i, mode="closed", requests=23,
                            concurrency=4, seed=0).run()
        assert raw["submitted"] == raw["completed"] == 23 and raw["shed"] == 0

    def test_closed_loop_ids_cover_range_without_overlap(self):
        seen, lock = [], threading.Lock()

        def sample(i):
            with lock:
                seen.append(i)
            return i

        raw = LoadGenerator(_instant_submit, sample, mode="closed", requests=10,
                            concurrency=4, seed=0).run()
        assert raw["submitted"] == 10 and sorted(seen) == list(range(10))

    def test_open_loop_sheds_are_counted(self):
        def always_shed(payload):
            raise LoadShedError("queue full")

        raw = LoadGenerator(always_shed, lambda i: i, mode="open", requests=20,
                            rate=10000.0, seed=0).run()
        assert raw["submitted"] == raw["shed"] == 20 and raw["completed"] == 0

    def test_verdict_is_strict_json_and_deterministic_schema(self):
        raw = {"submitted": 10, "completed": 8, "shed": 2, "wall_s": 0.5,
               "latencies_ms": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, float("nan")]}
        v = slo_verdict(raw, dict(_STATS), mode="open", rate=100.0, seed=7,
                        provenance={"arch": "resnet8_tiny"})
        parsed = json.loads(json.dumps(v, allow_nan=False, sort_keys=True),
                            parse_constant=lambda s: pytest.fail(f"bare {s}"))
        assert parsed["shed_rate"] == 0.2 and parsed["requests_completed"] == 8
        assert parsed["serve_verdict"] == 8
        assert parsed["per_priority"] is None and parsed["fairness_ratio"] is None

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError, match="open|closed"):
            LoadGenerator(_instant_submit, lambda i: i, mode="swarm")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _cfg(art, log_path, **kw):
    base = dict(artifact=art, log_path=str(log_path), mode="closed", requests=24, concurrency=4,
                buckets=(1, 4), queue_depth=16, max_delay_ms=2.0, seed=0)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def bench_run(port_artifact, tmp_path_factory):  # noqa: F811
    """One port serve-bench run (ab: dense then packed) and the
    reference's run on the same config."""
    d = tmp_path_factory.mktemp("bench")
    port = tloadgen.run_serve_bench(
        TConfig(**_cfg(port_artifact, d / "port", packed_weights="ab", device="cpu")))
    ref = jloadgen.run_serve_bench(JConfig(**_cfg(port_artifact, d / "ref", packed_weights="ab")))
    return port, ref


def test_verdict_invariants_and_the_reference_schema(bench_run):
    from bdbnn_tpu_torch.obs.events import read_events

    (port, ref), v = bench_run, bench_run[0]["verdict"]
    assert v["requests_completed"] + v["requests_shed"] == v["requests_submitted"] == 24
    assert v["requests_failed"] == 0
    assert v["max_queue_depth_seen"] <= v["max_queue"] == 16
    assert v["drained_clean"] and not v["preempted"]
    assert v["p99_ms"] is not None and v["p99_ms"] > 0
    assert set(v["warmup_compile_s"]) == {"1", "4"}
    assert set(v) == set(ref["verdict"]) and v["serve_verdict"] == ref["verdict"]["serve_verdict"]
    for block in ("packed", "resident", "attribution"):
        assert set(v[block]) == set(ref["verdict"][block]), block
    # the packed A/B's bytes are the reference's on the same artifact
    assert v["packed"]["resident_ratio"] == ref["verdict"]["packed"]["resident_ratio"]
    assert v["resident"] == {**ref["verdict"]["resident"]}
    assert v["attribution"]["reconciliation"]["requests"] == 24
    with open(os.path.join(port["run_dir"], "verdict.json")) as f:
        assert json.load(f) == v
    serves = read_events(port["run_dir"], "serve")
    phases = [e["phase"] for e in serves]
    assert phases[0] == "start" and phases[-1] == "verdict"
    passes = {e["weights_mode"]: e["forwards"] for e in serves if e["phase"] == "pass"}
    # each pass: two warmup buckets, the six time_step forwards, a batch each
    assert passes["packed"] == 2 + 6 + v["batches"]
    assert {e["phase"] for e in read_events(port["run_dir"], "memory")} == {"serve_resident"}


def test_the_reference_tools_read_the_port_run(bench_run, tmp_path):
    from bdbnn_tpu.obs.compare import compare_runs
    from bdbnn_tpu.obs.events import read_events
    from bdbnn_tpu.obs.summarize import summarize_run
    from bdbnn_tpu.obs.watch import render_status

    port, v = bench_run[0], bench_run[0]["verdict"]
    status = render_status(read_events(port["run_dir"]), None)
    assert "SLO:" in status and "serve:" in status
    report, summary = summarize_run(port["run_dir"])
    assert summary["serving"]["verdict"]["p99_ms"] == v["p99_ms"]
    assert "SLO: p50" in report
    base = os.path.join(port["run_dir"], "verdict.json")
    worse = str(tmp_path / "worse.json")
    with open(worse, "w") as f:
        json.dump({**v, "p99_ms": 3 * v["p99_ms"] + 1.0}, f)
    assert compare_runs([base, base], tol_rel=0.10)["verdict"] == "pass"
    r = compare_runs([base, worse], tol_rel=0.10)
    assert r["verdict"] == "regression"
    bad = [m["metric"] for c in r["comparisons"] for m in c["metrics"]
           if m["verdict"] == "regression"]
    assert "serve_p99_ms" in bad


def test_every_answer_is_the_engines_own(port_artifact):  # noqa: F811
    """Answers that came back through the batcher and the load
    generator: bitwise the engine's logits of the batch each request
    rode in, and within 2e-5 of the largest |logit| of the JAX engine's
    answer for the image alone."""
    engine = tengine.InferenceEngine(port_artifact, buckets=(1, 4), device="cpu")
    x = _images(24, 11)
    batches = []

    def runner(ids):
        out = engine.predict_logits(x[ids])
        batches.append((list(ids), out))
        return out

    b = MicroBatcher(runner, max_batch=4, max_queue=64, max_delay_ms=2.0)
    futs = {}

    def submit(i):
        futs[i] = b.submit(i)
        return futs[i]

    raw = LoadGenerator(submit, lambda i: i, mode="closed", requests=24, concurrency=6).run()
    assert b.drain(timeout=30) and raw["completed"] == 24
    got = np.stack([futs[i].result() for i in range(24)])
    for ids, out in batches:
        np.testing.assert_array_equal(got[ids].view(np.uint32),
                                      engine.predict_logits(x[ids]).view(np.uint32))
        np.testing.assert_array_equal(got[ids], out)
    ref = jengine.InferenceEngine(port_artifact, buckets=(1,)).predict_logits(x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * float(np.max(np.abs(ref))))
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_sigterm_drains_with_every_accepted_request_answered(port_artifact, tmp_path):  # noqa: F811
    cfg = TConfig(**_cfg(port_artifact, tmp_path, mode="open", rate=50.0, requests=10_000,
                         seed=1, buckets=(4,), device="cpu"))
    pid = os.getpid()
    killer = threading.Timer(1.5, lambda: os.kill(pid, signal.SIGTERM))
    killer.start()
    try:
        res = tloadgen.run_serve_bench(cfg)
    finally:
        killer.cancel()
    v = res["verdict"]
    assert v["preempted"] is True and v["drained_clean"] is True
    assert v["requests_completed"] + v["requests_shed"] == v["requests_submitted"] < 10_000
    assert v["requests_failed"] == 0


def test_cli_runs_on_the_cpu_only_when_asked(port_artifact, tmp_path, capsys):  # noqa: F811
    """The CLI with ``--device cpu`` exits 0 and prints the verdict;
    without it there is no card here, and it raises before writing a run
    dir (the module run as ``python -m`` is in ``tests/test_torch_pool.py``,
    the paced sweep)."""
    from bdbnn_tpu_torch import cli

    args = ["serve-bench", port_artifact, "--mode", "closed", "--requests", "16",
            "--concurrency", "4", "--buckets", "1", "4", "--packed-weights", "on",
            "--packed-impl", "popcount", "--log-path", str(tmp_path / "log")]
    assert cli.main([*args, "--device", "cpu"]) == 0
    v = json.loads(capsys.readouterr().out)
    assert v["requests_completed"] == 16 and v["packed"]["impl"] == "popcount"
    if not torch.cuda.is_available():
        args[-1] = str(tmp_path / "not-written")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
        assert not os.path.exists(args[-1])  # refused before any run dir


def test_engine_failures_exit_1(port_artifact, tmp_path, monkeypatch, capsys):  # noqa: F811
    """A request that fails with an engine error is not shed: the
    verdict counts it failed and the CLI exits 1."""
    from bdbnn_tpu_torch import cli

    def broken(self, images):
        raise RuntimeError("engine broke")

    monkeypatch.setattr(tengine.InferenceEngine, "predict_logits", broken)
    rc = cli.main(["serve-bench", port_artifact, "--mode", "closed", "--requests", "8",
                   "--buckets", "2", "--log-path", str(tmp_path), "--device", "cpu"])
    v = json.loads(capsys.readouterr().out)
    assert rc == 1 and v["requests_failed"] == 8 and v["requests_shed"] == 0

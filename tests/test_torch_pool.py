"""The port's replica pool (``bdbnn_tpu_torch/serve/pool.py``) and
``replica_devices``, against the JAX package's and on their own.

- Exact parity with the JAX package (``==``): the verdict's
  ``replicas`` block (``_pool_replicas_block``), the ``replica`` stats
  event fields, ``resident_block`` over the resident-model caches and
  ``single_engine_resident_block``, each package's function over its own
  pool or caches driven the same way.
- Mirrors of the reference's ``TestDispatch``, ``TestReplicaHealth`` and
  ``TestShedUnits`` (``tests/test_pool.py``) on the port, and the
  in-process form of ``TestFutureDeliveredShedReason``: a shed inside
  the batcher's worker reaches the request future with its real reason
  and the load generator counts it as shed, never as failed.
- The real runner factory on the CPU: engines per device, the paced
  fabric mode, the multi-model ``(key, image)`` payloads.
- ``replica_devices``: the CPU device alone, ``n`` beyond the devices
  raises with the reference's message.
- ``python -m bdbnn_tpu_torch.cli serve-bench --replicas 1 2 --pace-ms 5
  --device cpu``: the paced sweep's ``scaling`` and ``replicas`` blocks.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bdbnn_tpu.serve import loadgen as jloadgen
from bdbnn_tpu.serve import pool as jpool
from bdbnn_tpu_torch.serve import loadgen as tloadgen
from bdbnn_tpu_torch.serve import pool as tpool
from bdbnn_tpu_torch.serve.batching import LoadShedError, MicroBatcher
from bdbnn_tpu_torch.serve.loadgen import LoadGenerator
from bdbnn_tpu_torch.serve.pool import READY, UNHEALTHY, ReplicaPool

from test_torch_serve import REPO, _images, port_artifact  # noqa: F401  (fixture)


def tag_factory(pace_s=0.0, record=None):
    """A stub runner factory: results are (ref, device, payload) triples,
    optionally paced, optionally recording execution order."""

    def factory(ref, device):
        def runner(payloads):
            if pace_s:
                time.sleep(pace_s)
            if record is not None:
                record.append((device, list(payloads)))
            return [(ref, device, p) for p in payloads]

        return runner

    return factory


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _drive_one_replica(mod):
    """A one-replica pool of ``mod`` serving five batches in turn, then a
    shed: a deterministic ledger."""
    gate = threading.Event()

    def factory(ref, device):
        def runner(payloads):
            gate.wait(timeout=10)
            return list(payloads)

        return runner

    pool = mod.ReplicaPool(factory, ["d0"], version="v0007", max_queue_batches=1,
                           wedge_timeout_s=60)
    gate.set()
    for i in range(5):
        pool.submit([i] * (i + 1)).result(timeout=10)
    gate.clear()
    held = [pool.submit([9])]
    _wait(lambda: pool.replicas[0].busy_since is not None)
    held.append(pool.submit([10]))
    with pytest.raises(Exception, match="queue full"):
        pool.submit([11, 12])
    gate.set()
    for f in held:
        f.result(timeout=10)
    assert pool.drain(10)
    return pool.stats()


def test_replicas_block_and_stats_fields_equal_the_reference():
    tstats, jstats = _drive_one_replica(tpool), _drive_one_replica(jpool)
    assert tloadgen._pool_replicas_block(tstats) == jloadgen._pool_replicas_block(jstats)
    assert tpool.replica_stats_fields(tstats) == jpool.replica_stats_fields(jstats)
    # each package's function reads the other's snapshot the same way
    assert tloadgen._pool_replicas_block(jstats) == jloadgen._pool_replicas_block(tstats)
    assert tpool.replica_stats_fields(jstats) == jpool.replica_stats_fields(tstats)
    block = tloadgen._pool_replicas_block(tstats)
    assert block["n"] == 1 and block["pool_shed_batches"] == 1
    assert block["completed_by_version"] == {"v0007": 17}
    assert tloadgen._pool_replicas_block(None) is jloadgen._pool_replicas_block(None) is None


class _FakeEngine:
    def __init__(self, key):
        self.key = key

    def residency(self):
        n = 1000 + 10 * len(self.key)
        return {"resident_bytes": n, "dense_equiv_bytes": 7 * n}


def _caches(mod):
    events = []
    caches = []
    for dev in ("d0", "d1"):
        c = mod.ResidentModelCache(_FakeEngine, capacity=2, device=dev,
                                   on_event=lambda kind, **f: events.append((kind, f.get("phase"))))
        for key in ("default", "m1", "default", "model-22", "m1", "default"):
            assert c.get(key).key == key
        caches.append(c)
    return caches, events


def test_resident_blocks_equal_the_reference():
    tc, tev = _caches(tpool)
    jc, jev = _caches(jpool)
    assert [c.stats() for c in tc] == [c.stats() for c in jc]
    assert tev == jev and ("replica", "model_evict") in tev
    by_model = {"default": 30, "m1": 12}
    assert tpool.resident_block(tc, completed_by_model=by_model) == jpool.resident_block(
        jc, completed_by_model=by_model)
    assert tpool.resident_block(tc) == jpool.resident_block(jc)
    assert tpool.resident_block([]) is jpool.resident_block([]) is None
    residency = {"resident_bytes": 3544, "dense_equiv_bytes": 21640}
    for completed in (None, 48):
        assert tpool.single_engine_resident_block(residency, completed=completed) == (
            jpool.single_engine_resident_block(residency, completed=completed))


# ---------------------------------------------------------------------------
# dispatch (mirrors the reference's TestDispatch)
# ---------------------------------------------------------------------------


class TestDispatch:
    def test_least_loaded_spreads_batches_across_replicas(self):
        record = []
        pool = ReplicaPool(tag_factory(pace_s=0.005, record=record), ["d0", "d1", "d2", "d3"],
                           artifact_ref="v1", version="v0001")
        futs = [pool.submit([i]) for i in range(32)]
        for f in futs:
            f.result(timeout=10)
        assert pool.drain(10)
        assert {dev for dev, _ in record} == {"d0", "d1", "d2", "d3"}
        stats = pool.stats()
        assert stats["completed"] == 32
        assert stats["completed_by_version"] == {"v0001": 32}
        assert min(r["batches"] for r in stats["replicas"]) >= 1

    def test_replica_queue_bound_sheds_explicitly(self):
        release = threading.Event()

        def factory(ref, device):
            def runner(payloads):
                release.wait(timeout=10)
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0"], max_queue_batches=2, wedge_timeout_s=60)
        held = [pool.submit([0])]
        _wait(lambda: pool.replicas[0].queue_depth() == 0)
        held += [pool.submit([i]) for i in (1, 2)]  # 1 running + 2 queued
        with pytest.raises(LoadShedError, match="queue full"):
            pool.submit([99])
        assert pool.stats()["shed"] == 1
        release.set()
        for f in held:
            assert f.result(timeout=10)
        assert pool.drain(10)

    def test_no_healthy_replica_sheds_with_reason(self):
        pool = ReplicaPool(tag_factory(), ["d0"], wedge_timeout_s=60)
        pool.replicas[0].state = UNHEALTHY
        with pytest.raises(LoadShedError, match="no healthy replica"):
            pool.submit([1])
        pool.replicas[0].state = READY
        assert pool.drain(10)
        with pytest.raises(LoadShedError, match="draining"):
            pool.submit([2])

    def test_strict_priority_preserved_through_async_dispatch(self):
        release = threading.Event()
        record = []

        def factory(ref, device):
            def runner(payloads):
                release.wait(timeout=10)
                record.append(list(payloads))
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0"], wedge_timeout_s=60)
        batcher = MicroBatcher(pool.submit, max_batch=2, max_queue=16, max_delay_ms=1.0,
                               priorities=2, max_pending_batches=2)
        first = batcher.submit("warm", priority=1)
        time.sleep(0.1)
        lows = [batcher.submit(f"low{i}", priority=1) for i in range(4)]
        time.sleep(0.05)
        high = batcher.submit("HIGH", priority=0)
        time.sleep(0.05)
        release.set()
        assert high.result(timeout=10) == "HIGH"
        for f in [first, *lows]:
            f.result(timeout=10)
        assert batcher.drain(10) and pool.drain(10)
        order = [p for b in record for p in b]
        assert order.index("HIGH") < order.index("low2")
        assert order.index("HIGH") < order.index("low3")

    def test_batcher_async_accounting_and_drain(self):
        pool = ReplicaPool(tag_factory(pace_s=0.002), ["d0", "d1"], version="vX")
        batcher = MicroBatcher(pool.submit, max_batch=4, max_queue=64, max_delay_ms=1.0)
        futs = [batcher.submit(i) for i in range(20)]
        for f in futs:
            f.result(timeout=10)
        assert batcher.drain(10)
        stats = batcher.stats()
        assert stats["completed"] == 20 and stats["shed"] == 0
        assert pool.drain(10)
        assert pool.stats()["completed"] == 20


# ---------------------------------------------------------------------------
# health (mirrors the reference's TestReplicaHealth)
# ---------------------------------------------------------------------------


class TestReplicaHealth:
    def test_wedged_replica_detected_routed_around_restarted(self):
        wedge = threading.Event()
        wedged_once = threading.Event()
        events = []

        def factory(ref, device):
            def runner(payloads):
                if device == "d0" and not wedged_once.is_set():
                    wedged_once.set()
                    wedge.wait(timeout=30)
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0", "d1"], wedge_timeout_s=0.3, health_interval_s=0.05,
                           on_event=lambda kind, **f: events.append((kind, f)))
        futs = [pool.submit([i]) for i in range(4)]
        _wait(lambda: any(f.get("phase") == "restart" for k, f in list(events) if k == "replica"))
        assert pool.stats()["restarts"] >= 1
        unhealthy = next(f for k, f in events if k == "replica" and f.get("phase") == "unhealthy")
        assert unhealthy["reason"] == "wedged"
        assert pool.submit([100]).result(timeout=5) == [100]
        wedge.set()
        for f in futs:
            assert f.result(timeout=10) is not None
        assert pool.drain(10)
        assert pool.stats()["restarts"] == 1

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_dead_worker_detected_and_restarted(self):
        class Boom(BaseException):
            """Escapes the runner's Exception guard: kills the worker."""

        first = threading.Event()

        def factory(ref, device):
            def runner(payloads):
                if not first.is_set():
                    first.set()
                    raise Boom("worker dies")
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0"], wedge_timeout_s=5.0, health_interval_s=0.05)
        doomed = pool.submit([1])
        _wait(lambda: pool.stats()["restarts"] > 0 and pool.replicas[0].state == READY)
        assert pool.submit([2]).result(timeout=5) == [2]
        with pytest.raises(BaseException):
            doomed.result(timeout=1)
        assert pool.drain(10)

    def test_drain_not_clean_while_a_retired_worker_holds_a_batch(self):
        wedge = threading.Event()
        wedged_once = threading.Event()

        def factory(ref, device):
            def runner(payloads):
                if not wedged_once.is_set():
                    wedged_once.set()
                    wedge.wait(timeout=30)
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0"], wedge_timeout_s=0.2, health_interval_s=0.05)
        stuck = pool.submit([1])
        _wait(lambda: pool.stats()["restarts"] > 0)
        assert pool.drain(0.5) is False
        assert not stuck.done()
        wedge.set()
        assert stuck.result(timeout=10) == [1]
        assert pool.drain(10) is True


# ---------------------------------------------------------------------------
# shed units and shed reasons
# ---------------------------------------------------------------------------


class TestShedUnits:
    def test_shed_counts_batches_and_requests(self):
        gate = threading.Event()

        def factory(ref, device):
            def runner(payloads):
                gate.wait(timeout=10)
                return list(payloads)

            return runner

        pool = ReplicaPool(factory, ["d0"], max_queue_batches=1)
        try:
            pool.submit([1])
            _wait(lambda: pool.replicas[0].busy_since is not None)
            pool.submit([2])
            with pytest.raises(LoadShedError, match="queue full"):
                pool.submit([3, 4, 5, 6, 7])
            s = pool.stats()
            assert s["shed"] == 1 and s["shed_requests"] == 5
        finally:
            gate.set()
            assert pool.drain(10)


class TestFutureDeliveredShedReason:
    @pytest.mark.parametrize("reason", ["queue full", "no healthy replica"])
    def test_a_shed_inside_the_worker_reaches_the_future_and_counts_as_shed(self, reason):
        """The pooled runner sheds INSIDE the batcher's worker (every
        replica queue full, or none healthy): the LoadShedError arrives
        on the request future after submit succeeded, with its reason,
        and the load generator's ledger counts it as shed."""

        def runner(batch):
            raise LoadShedError(reason)

        b = MicroBatcher(runner, max_batch=4, max_queue=16, max_delay_ms=1.0)
        f = b.submit(1)
        with pytest.raises(LoadShedError) as e:
            f.result(timeout=5)
        assert e.value.reason == reason
        raw = LoadGenerator(b.submit, lambda i: i, mode="closed", requests=6, concurrency=2).run()
        assert b.drain(timeout=5)
        assert raw["shed"] == 6 and raw["failed"] == 0 and raw["completed"] == 0


# ---------------------------------------------------------------------------
# the real runner factory and replica_devices, on the CPU
# ---------------------------------------------------------------------------


def test_engine_factory_serves_the_single_engine_answer(port_artifact):  # noqa: F811
    from bdbnn_tpu_torch.parallel.mesh import replica_devices
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    warm, on_engine = tpool.first_warm_capture()
    engines = []
    factory = tpool.make_engine_runner_factory(
        (1, 4), on_engine=lambda e, d: (engines.append(e), on_engine(e, d)))
    pool = ReplicaPool(factory, replica_devices(1, "cpu"), artifact_ref=port_artifact)
    batcher = MicroBatcher(pool.submit, max_batch=4, max_queue=64, max_delay_ms=2.0,
                           max_pending_batches=2)
    x = _images(6, 3)
    futs = [batcher.submit(x[i]) for i in range(6)]
    got = np.stack([f.result(timeout=30) for f in futs])
    assert batcher.drain(30) and pool.drain(30)
    single = InferenceEngine(port_artifact, buckets=(1, 4), device="cpu")
    ref = np.concatenate([single.predict_logits(x[i:i + 4]) for i in range(0, 6, 4)])
    # rows of one padded bucket-4 batch; a row alone may round differently
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * float(np.max(np.abs(ref))))
    assert set(warm) == {1, 4} and len(factory.caches) == 1
    assert pool.stats()["replicas"][0]["device"] == "cpu"
    assert engines[0].forwards >= 2 + 2  # two warmup buckets + the served batches
    res = tpool.resident_block(factory.caches)
    assert res["bytes_per_model_max"] == single.residency()["resident_bytes"]


def test_multi_model_payloads_and_paced_factory(port_artifact, tmp_path):  # noqa: F811
    import shutil

    other = str(tmp_path / "other")
    shutil.copytree(port_artifact, other)
    factory = tpool.make_engine_runner_factory((2,), resident_models=2,
                                               model_dirs={"b": other})
    runner = factory(port_artifact, "cpu")
    x = _images(3, 5)
    out = runner([("b", x[0]), (None, x[1]), ("b", x[2])])
    assert len(out) == 3 and all(o.shape == (10,) for o in out)
    assert set(factory.caches[0].resident_keys()) == {"default", "b"}
    with pytest.raises(KeyError, match="unknown model"):
        runner([("nope", x[0])])
    paced = tpool.make_engine_runner_factory((4,), pace_ms=1.0)("unused", "paced:0")
    t0 = time.perf_counter()
    assert len(paced([1, 2, 3])) == 3 and time.perf_counter() - t0 >= 0.001
    assert paced.__name__ == "paced"


def test_replica_devices_on_the_cpu():
    import torch

    from bdbnn_tpu_torch.parallel.mesh import replica_devices

    assert replica_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="one engine per device is the contract"):
        replica_devices(2, "cpu")
    with pytest.raises(ValueError, match="n >= 1"):
        replica_devices(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replica_devices(1)


def test_cli_paced_sweep_on_the_cpu(port_artifact, tmp_path):  # noqa: F811
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "serve-bench", port_artifact,
           "--mode", "closed", "--requests", "128", "--concurrency", "16", "--buckets", "4",
           "--replicas", "1", "2", "--pace-ms", "5", "--device", "cpu",
           "--log-path", str(tmp_path)]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    v = json.loads(r.stdout)
    assert v["scaling"]["replicas"] == [1, 2] and v["scaling"]["paced_ms"] == 5.0
    assert v["scaling"]["monotone"] is True
    assert v["replicas"]["n"] == 2 and v["requests_completed"] == 128
    assert v["drained_clean"] and v["attribution"]["stages"]["dispatch"] is not None

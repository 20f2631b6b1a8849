"""``serve-http`` on the port (``bdbnn_tpu_torch/serve/http.py`` and the
HTTP half of ``serve/loadgen.py``) against the JAX package, on the CPU.

- Exact parity (``==``): ``build_schedule`` for each of the five
  scenarios with a model mix over several seeds, ``fairness_ratio``,
  ``http_slo_verdict`` on one ledger with each optional block set and
  null, the ``x-rtrace`` context and stage-header codecs on the
  reference's hardening cases and a seeded fuzz of headers, and
  ``ServeHttpConfig.validate``'s refusals, the rollout options' included
  (one departure: a swap under load on one replica validates).
- Mirrors of the reference's socket tests (``tests/test_http.py``) on
  the port with a stub runner over real sockets on port 0: health and
  readiness, quotas, strict priority under a full queue, the drain
  contract, the scenarios' shapes, the verdict, the flash crowd and the
  trace-context hardening; the admin routes answer the replica table and
  the swap status, and ``POST /admin/swap`` starts a swap that completes.
- End to end on the tiny artifact with ``device="cpu"``: a bench run's
  verdict has the reference's keys and schema on the same config, and
  the reference's ``summarize``, ``watch`` and ``compare`` read the run
  dir; answers over the wire in serve mode equal the port engine's
  logits rounded to 4 places, and lie within 5e-5 + 2e-5·max|logit| of
  the JAX engine's; SIGTERM mid flash crowd drops nothing; the CLI runs
  only with ``--device cpu``; a ``--swap-to/--swap-at`` bench run swaps
  and its verdict's ``swap`` block has the reference's keys; the
  ``degrade`` hook slows the swapped-to version alone. The reference's two
  soaks (flash crowd against the priority-0 SLO, slow clients) are
  mirrored and marked slow, as there.
"""

import glob
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bdbnn_tpu.configs.config import ServeHttpConfig as JConfig
from bdbnn_tpu.obs import rtrace as jrtrace
from bdbnn_tpu.serve import loadgen as jloadgen
from bdbnn_tpu_torch.obs import rtrace as trtrace
from bdbnn_tpu_torch.serve import loadgen as tloadgen
from bdbnn_tpu_torch.serve.config import ServeHttpConfig as TConfig
from bdbnn_tpu_torch.serve.loadgen import (
    Arrival,
    HttpLoadGenerator,
    build_schedule,
    fairness_ratio,
    http_slo_verdict,
    percentile,
)

from test_torch_serve import _images, port_artifact  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# a minimal raw-socket client and a stub-runner front end on port 0
# ---------------------------------------------------------------------------


def _request(fe, method, path, *, headers=None, body=b"", timeout=10.0):
    with socket.create_connection((fe.host, fe.port), timeout=timeout) as s:
        head = f"{method} {path} HTTP/1.1\r\nhost: t\r\n"
        for k, v in (headers or {}).items():
            head += f"{k}: {v}\r\n"
        head += f"content-length: {len(body)}\r\nconnection: close\r\n\r\n"
        s.sendall(head.encode("latin-1") + body)
        status, resp_headers, raw = tloadgen.recv_response(s.makefile("rb"))
        return status, resp_headers, json.loads(raw) if raw else None


def _predict(fe, *, priority=None, tenant=None, body=b"[1]", model=None, **kw):
    headers = {"content-type": "application/json"}
    if priority is not None:
        headers["x-priority"] = str(priority)
    if tenant is not None:
        headers["x-tenant"] = tenant
    if model is not None:
        headers["x-model"] = model
    return _request(fe, "POST", "/v1/predict", headers=headers, body=body, **kw)


@pytest.fixture
def port_frontend():
    """``make(runner=..., **kw) -> HttpFrontEnd`` of the port, started on
    127.0.0.1 port 0 over a stub runner; every server is drained at
    teardown."""
    from bdbnn_tpu_torch.serve.admission import AdmissionController
    from bdbnn_tpu_torch.serve.batching import MicroBatcher
    from bdbnn_tpu_torch.serve.http import HttpFrontEnd

    started = []

    def make(runner=None, *, priorities=3, max_batch=8, max_queue=16, max_delay_ms=2.0,
             default_rate=1e9, default_burst=1e9, quotas=None, clock=None, ready_fn=None,
             **front_kw):
        batcher = MicroBatcher(runner or (lambda batch: list(batch)), max_batch=max_batch,
                               max_queue=max_queue, max_delay_ms=max_delay_ms,
                               priorities=priorities)
        kw = dict(default_rate=default_rate, default_burst=default_burst, quotas=quotas or {})
        if clock is not None:
            kw["clock"] = clock
        fe = HttpFrontEnd(batcher, AdmissionController(**kw),
                          ready_fn=ready_fn or (lambda: True), port=0, **front_kw)
        host, port = fe.start()
        assert host == "127.0.0.1" and port > 0
        started.append(fe)
        return fe

    yield make
    for fe in started:
        fe.drain(timeout=10.0)


# ---------------------------------------------------------------------------
# exact parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", tloadgen.SCENARIOS)
def test_schedules_equal_the_reference(scenario):
    assert tloadgen.SCENARIOS == jloadgen.SCENARIOS
    for seed in (0, 3, 11):
        kw = dict(requests=300, rate=250.0 + 50 * seed, seed=seed, priorities=3,
                  tenants=("a", "b", "c"), tenant_weights=(0.5, 0.3, 0.2),
                  flash_factor=6.0, diurnal_amp=0.7, heavy_sigma=1.2, slow_fraction=0.3,
                  models=("v0001", "v0002"), model_weights=(0.25, 0.75))
        got = build_schedule(scenario, **kw)
        want = jloadgen.build_schedule(scenario, **kw)
        assert [tuple(a) for a in got] == [tuple(a) for a in want]
        assert {a.model for a in got} == {"v0001", "v0002"}
        plain = dict(requests=50, rate=100.0, seed=seed, priorities=4)
        assert [tuple(a) for a in build_schedule(scenario, **plain)] == [
            tuple(a) for a in jloadgen.build_schedule(scenario, **plain)]


def test_schedule_refusals_equal_the_reference():
    for kw in (dict(scenario="tsunami"), dict(scenario="poisson", rate=0.0),
               dict(scenario="poisson", priorities=2, priority_weights=(1.0,)),
               dict(scenario="poisson", tenant_weights=(1.0,)),
               dict(scenario="poisson", models=("v1",), model_weights=(1.0, 2.0))):
        full = {"requests": 10, "rate": 10.0, "seed": 0, **kw}
        with pytest.raises(ValueError) as want:
            jloadgen.build_schedule(full.pop("scenario"), **full)
        full = {"requests": 10, "rate": 10.0, "seed": 0, **kw}
        with pytest.raises(ValueError) as got:
            build_schedule(full.pop("scenario"), **full)
        assert str(got.value) == str(want.value)


def test_fairness_ratio_equals_the_reference():
    rng = random.Random(5)
    cases = [{}, {"a": {"submitted": 5, "completed": 5}},
             {"a": {"submitted": 5, "completed": 5}, "b": {"submitted": 5, "completed": 0}},
             {"a": {"submitted": 0, "completed": 0}, "b": {"submitted": 3}}]
    for _ in range(50):
        cases.append({f"t{i}": {"submitted": rng.randint(0, 20), "completed": rng.randint(0, 20)}
                      for i in range(rng.randint(1, 4))})
    for c in cases:
        assert fairness_ratio(c) == jloadgen.fairness_ratio(c)


def _accounting():
    return {
        "wall_s": 2.0,
        "latencies_ms_by_priority": [[1.0, 2.0, 3.0], [5.0, 6.0], []],
        "counts_by_priority": [
            {"submitted": 3, "completed": 3, "failed": 0, "shed_draining": 0,
             "shed_over_quota": 0, "shed_queue_full": 0},
            {"submitted": 4, "completed": 2, "failed": 0, "rejected": 1, "shed_draining": 0,
             "shed_over_quota": 1, "shed_queue_full": 0, "shed_unavailable": 0},
            {"submitted": 5, "completed": 0, "failed": 1, "shed_draining": 1,
             "shed_over_quota": 0, "shed_queue_full": 2, "shed_unavailable": 1},
        ],
        "requests_seen": 12,
    }


def _admission():
    return {"draining": True, "default_rate": 100.0, "default_burst": 100.0, "tenants": {
        "a": {"admitted": 5, "over_quota": 0, "shed": 2, "completed": 3, "failed": 0,
              "shed_rate": 0.4, "quota_rate": 100.0, "quota_burst": 100.0},
        "b": {"admitted": 4, "over_quota": 1, "shed": 1, "completed": 2, "failed": 1,
              "rejected": 1, "shed_rate": 0.4, "quota_rate": 10.0, "quota_burst": 10.0}}}


_HTTP_BLOCKS = {
    "client": {"submitted": 12, "responses": 12, "dropped": 0},
    "replicas": {"n": 1, "per_replica": []},
    "swap": {"performed": False},
    "resident": {"bytes_per_model_max": 3544},
    "packed": {"resident_ratio": 6.106, "step_ms_delta_pct": None},
    "attribution": {"requests": 5, "stages": {"queue": None}},
    "canary": {"decision": "promote"},
    "capacity": {"headroom_rps": float("inf"), "burn_rate_max": 2.0},
}


@pytest.mark.parametrize("blocks", ["null", "set"])
@pytest.mark.parametrize("slo_p99_ms", [0.0, 2.5, 10.0])
def test_http_slo_verdict_equals_the_reference(blocks, slo_p99_ms):
    kw = dict(scenario="flash_crowd", rate=100.0, seed=3, provenance={"arch": "resnet8_tiny"},
              warmup_s={1: 0.5, 4: 0.25}, preempted=True, drained_clean=False,
              slo_p99_ms=slo_p99_ms)
    if blocks == "set":
        kw.update(_HTTP_BLOCKS)
    stats = {"mean_occupancy": 0.5, "batches": 4, "max_queue_depth_seen": 3, "max_queue": 8}
    got = http_slo_verdict(_accounting(), dict(stats), _admission(), **kw)
    assert got == jloadgen.http_slo_verdict(_accounting(), dict(stats), _admission(), **kw)
    assert got["serve_verdict"] == 8 and got["mode"] == "http"
    json.dumps(got, allow_nan=False)


_BAD_CTX = [
    "garbage", "v=1;id=not-hex;seq=0;p=0", "v=9;id=0123456789abcdef;seq=0;p=0",
    "v=1;id=0123456789abcdef;seq=-3;p=0", "v=1;id=0123456789abcdef;seq=0;p=0;tn=sp ace",
    "v=1;id=0123456789abcdef;seq=0;p=0;" + "x" * 400, "\x00\x01\x02binary", "", None, 7,
    "v=1;id=0123456789abcdef;seq=0;p=64", "v=1;id=0123456789abcdef;id=0123456789abcdef;seq=0;p=0",
]


def _fuzz_headers(seed, n=400):
    rng = random.Random(seed)
    alphabet = "v=1;id0123456789abcdefseqptn.-_ xX\x00é"
    keys = ["v", "id", "seq", "p", "tn", "total", "read", "queue", "compute", "bogus", ""]
    out = []
    for _ in range(n):
        if rng.random() < 0.5:
            out.append("".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60))))
        else:
            parts = []
            for _ in range(rng.randint(1, 7)):
                k = rng.choice(keys)
                v = rng.choice(["1", "0123456789abcdef", str(rng.randint(-5, 80)),
                                f"{rng.uniform(-2, 50):.3f}", "nan", "inf", "tenant-a", "x y"])
                parts.append(f"{k}={v}" if rng.random() < 0.9 else k)
            out.append(";".join(parts))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_wire_formats_equal_the_reference(seed):
    for name in ("TRACE_HEADER", "STAGE_HEADER", "TRACE_CTX_MAX_LEN", "STAGE_HEADER_MAX_LEN"):
        assert getattr(trtrace, name) == getattr(jrtrace, name)
    for v in _BAD_CTX + _fuzz_headers(seed):
        assert trtrace.parse_trace_context(v) == jrtrace.parse_trace_context(v)
        assert trtrace.parse_stage_header(v) == jrtrace.parse_stage_header(v)
    rng = random.Random(seed)
    for i in range(200):
        tid = trtrace.mint_trace_id(seed, i)
        tenant = rng.choice([None, "tenant-a", "sp ace", "x" * 70, "ok.1_2-3"])
        ctx = trtrace.encode_trace_context(tid, i, i % 5, tenant)
        assert ctx == jrtrace.encode_trace_context(tid, i, i % 5, tenant)
        assert trtrace.parse_trace_context(ctx) == jrtrace.parse_trace_context(ctx) is not None
        stages = {s: rng.choice([None, rng.uniform(0, 9), -1.0, float("nan")])
                  for s in trtrace.STAGES}
        stages = {k: v for k, v in stages.items() if v is not None}
        total = rng.uniform(0, 50)
        hdr = trtrace.encode_stage_header(tid, total, stages)
        assert hdr == jrtrace.encode_stage_header(tid, total, stages)
        assert trtrace.parse_stage_header(hdr) == jrtrace.parse_stage_header(hdr) is not None


def _refusal(cls, **kw):
    try:
        cls(**kw).validate()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


_CONFIG_CASES = [
    dict(artifact=""), dict(artifact="a", scenario="tsunami"), dict(artifact="a", priorities=0),
    dict(artifact="a", queue_depth=0), dict(artifact="a", tenant_quotas=("broken",)),
    dict(artifact="a", tenant_quotas=("t=10:0",)), dict(artifact="a", priority_weights=(1.0,)),
    dict(artifact="a", slow_fraction=1.5), dict(artifact="a", default_quota="10:0"),
    dict(artifact="a", replicas=0), dict(artifact="a", scenario="poisson", rate=0.0),
    dict(artifact="a", scenario="poisson", concurrency=0), dict(artifact="a", tenants=()),
    dict(artifact="a", tenant_weights=(1.0,)), dict(artifact="a", slo_p99_ms=-1.0),
    dict(artifact="a", slo_shed_rate=2.0), dict(artifact="a", stats_interval_s=0.0),
    dict(artifact="a", max_body_mb=0.0), dict(artifact="a", events_max_mb=-1.0),
    dict(artifact="a", max_delay_ms=-1.0), dict(artifact="a", buckets=(0,)),
    dict(artifact="a", scenario="poisson", swap_to="v0002", swap_at=1.0),
    dict(artifact="a", scenario="poisson", swap_at=0.5),
    dict(artifact="a", swap_to="v0002", swap_at=0.5),
    dict(artifact="a", scenario="poisson", swap_to="v0002"),
    # one replica swaps on the port (test_a_swap_under_load_validates_on_one_replica);
    # both refuse a swap under load with no replica at all
    dict(artifact="a", scenario="poisson", swap_to="v0002", swap_at=0.5, replicas=0),
    dict(artifact="a", canary_fraction=1.5), dict(artifact="a", canary_fraction=0.3),
    dict(artifact="a", canary_fraction=0.3, replicas=2, canary_replicas=2),
    dict(artifact="a", shadow_every=-1), dict(artifact="a", replica_queue_batches=0),
    dict(artifact="a", wedge_timeout_s=0.0), dict(artifact="a", packed_impl="xnor"),
    dict(artifact="a", resident_models=0), dict(artifact="a", resident_models=2),
    dict(artifact="a", models=("v0002",)),
    dict(artifact="a", models=("v0002",), scenario="poisson", registry="r"),
    dict(artifact="a", models=("path/x",), scenario="poisson", registry="r", resident_models=2),
    dict(artifact="v0001", models=("v0001", "v0002", "v0003"), scenario="poisson",
         registry="r", resident_models=2),
    dict(artifact="a", models=("v0002",), model_weights=(1.0, 1.0), scenario="poisson",
         registry="r", resident_models=2),
    dict(artifact="a", rtrace_sample_every=0), dict(artifact="a", rtrace_tail_k=-1),
]


@pytest.mark.parametrize("case", range(len(_CONFIG_CASES)))
def test_config_refusals_equal_the_reference(case):
    kw = _CONFIG_CASES[case]
    got, want = _refusal(TConfig, **kw), _refusal(JConfig, **kw)
    assert want is not None and want[0] == "ValueError"
    assert got == want


@pytest.mark.parametrize("kw,flag", [
    (dict(swap_to="v0002"), dict(scenario="poisson", swap_to="v0002")),
    (dict(scenario="poisson", swap_to="v0002", swap_at=0.5, replicas=2),
     dict(scenario="poisson", swap_to="v0002", swap_at=1.5, replicas=2)),
    (dict(canary_fraction=0.3, replicas=2), dict(canary_fraction=0.3, replicas=1)),
    (dict(canary_replicas=2, replicas=3, canary_fraction=0.2),
     dict(canary_replicas=3, replicas=3, canary_fraction=0.2)),
    (dict(shadow_every=0), dict(shadow_every=-1)),
    (dict(canary_thresholds=("p99_ratio=3",)), dict(canary_thresholds=("p99_ratio=x",))),
])
def test_rollout_options_refuse_by_name(kw, flag):
    """Each rollout option validates as the reference's does: a value the
    reference accepts passes, and a bad one (``flag``) is refused with
    the reference's error; the defaults, the pooled predicate and the
    field set are the reference's."""
    assert _refusal(JConfig, artifact="a", **kw) is None
    assert _refusal(TConfig, artifact="a", **kw) is None
    want = _refusal(JConfig, artifact="a", **flag)
    assert want is not None and want[0] == "ValueError"
    assert _refusal(TConfig, artifact="a", **flag) == want
    ok = TConfig(artifact="a").validate()
    assert ok.priorities == 3 and ok.scenario == "" and ok.default_quota == "100:200"
    assert set(TConfig.__dataclass_fields__) == set(JConfig.__dataclass_fields__) | {"device"}
    for f in JConfig.__dataclass_fields__:
        assert getattr(TConfig(artifact="a"), f) == getattr(JConfig(artifact="a"), f), f
    for pk in (dict(), dict(replicas=2), dict(registry="r"), dict(resident_models=2)):
        assert TConfig(artifact="a", **pk).pooled == JConfig(artifact="a", **pk).pooled


def test_a_swap_under_load_validates_on_one_replica():
    """The one departure from the reference's checks: one card holds one
    replica, so ``--swap-at`` runs on one (the reference asks for two)."""
    kw = dict(artifact="a", scenario="poisson", swap_to="v0002", swap_at=0.5)
    assert _refusal(JConfig, **kw)[0] == "ValueError"
    assert _refusal(TConfig, **kw) is None
    # a canary still needs two replicas, refused as the reference does
    one = dict(artifact="a", canary_fraction=0.3)
    assert _refusal(TConfig, **one) == _refusal(JConfig, **one) is not None


# ---------------------------------------------------------------------------
# mirrors of tests/test_http.py on the port
# ---------------------------------------------------------------------------


class TestHealthReady:
    def test_readyz_gates_on_warmup_then_drain(self, port_frontend):
        warm = threading.Event()
        fe = port_frontend(ready_fn=warm.is_set)
        status, _, body = _request(fe, "GET", "/healthz")
        assert status == 200 and body["status"] == "ok" and body["ready"] is False
        status, headers, body = _request(fe, "GET", "/readyz")
        assert status == 503 and body["state"] == "warming" and "retry-after" in headers
        warm.set()
        status, _, body = _request(fe, "GET", "/readyz")
        assert status == 200 and body["state"] == "ready"
        fe.drain(timeout=5.0)
        assert fe.draining

    def test_statsz_and_404(self, port_frontend):
        fe = port_frontend()
        status, _, body = _request(fe, "GET", "/statsz")
        assert status == 200 and body["state"] == "ready"
        assert len(body["batcher"]["per_priority"]) == 3
        assert {"batcher", "admission", "capacity", "rtrace", "canary"} <= set(body)
        assert _request(fe, "GET", "/nope")[0] == 404

    def test_undecodable_body_is_rejected_not_lost(self, port_frontend):
        fe = port_frontend()
        status, _, body = _predict(fe, priority=0, body=b"{not json")
        assert status == 400 and "undecodable" in body["error"]
        c = fe.accounting()["counts_by_priority"][0]
        assert c["submitted"] == 1 and c["rejected"] == 1
        assert (c["completed"] + c["failed"] + c["rejected"] + c["shed_draining"]
                + c["shed_over_quota"] + c["shed_queue_full"] + c["shed_unavailable"]
                == c["submitted"])
        assert fe.stats()["admission"]["tenants"]["anon"]["rejected"] == 1

    def test_bad_priority_is_400_not_reclassified(self, port_frontend):
        fe = port_frontend(priorities=2)
        for bad in ("7", "-1", "zero"):
            status, _, body = _predict(fe, priority=bad)
            assert status == 400 and "x-priority" in body["error"], bad
        status, _, body = _predict(fe)
        assert status == 200 and body["priority"] == 1

    def test_x_model_without_router_is_404_and_oversize_is_413(self, port_frontend):
        fe = port_frontend(max_body_bytes=16)
        status, _, body = _predict(fe, priority=0, model="v0002")
        assert status == 404 and "multi-model routing disabled" in body["error"]
        status, _, body = _predict(fe, priority=0, body=b"[" + b"1," * 20 + b"1]")
        assert status == 413

    def test_admin_routes_are_read_only(self, port_frontend, tmp_path):
        """The read routes, then ``POST /admin/swap``: a version without a
        registry is 400, a missing dir 404, an artifact dir 202, and the
        rollout runs to ``done`` (polled through ``GET /admin/swap``)."""
        from bdbnn_tpu_torch.serve.pool import PoolAdmin, ReplicaPool

        fe = port_frontend()
        status, _, body = _request(fe, "GET", "/admin/replicas")
        assert status == 404 and "no replica pool" in body["error"]
        pool = ReplicaPool(lambda ref, dev: (lambda batch: list(batch)), ["d0", "d1"],
                           version="v0001")
        try:
            fe = port_frontend(admin=PoolAdmin(pool))
            status, _, body = _request(fe, "GET", "/admin/replicas")
            assert status == 200 and body["n_replicas"] == 2
            assert [r["state"] for r in body["replicas"]] == ["ready", "ready"]
            status, _, body = _request(fe, "GET", "/admin/swap")
            assert status == 200 and body == {"current": {"state": "idle"}, "last": None}
            status, _, body = _request(fe, "POST", "/admin/swap", body=b'{"version": 2}')
            assert status == 400 and "no --registry configured" in body["error"]
            status, _, body = _request(fe, "POST", "/admin/swap",
                                       body=json.dumps({"artifact": str(tmp_path / "no")}).encode())
            assert status == 404
            status, _, body = _request(fe, "POST", "/admin/swap", body=b"[1]")
            assert status == 400 and "JSON object" in body["error"]
            (tmp_path / "v2").mkdir()
            status, _, body = _request(fe, "POST", "/admin/swap",
                                       body=json.dumps({"artifact": str(tmp_path / "v2")}).encode())
            assert status == 202 and body["version_to"] == "v2" and body["accepted"]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                _, _, body = _request(fe, "GET", "/admin/swap")
                if body["last"] is not None:
                    break
                time.sleep(0.02)
            assert body["current"]["state"] == body["last"]["state"] == "done"
            assert body["last"]["replicas_shifted"] == 2 and body["last"]["shed"] == 0
            _, _, body = _request(fe, "GET", "/admin/replicas")
            assert body["version"] == "v2"
            assert [r["version"] for r in body["replicas"]] == ["v2", "v2"]
        finally:
            pool.drain(timeout=5.0)


class TestQuota:
    def test_over_quota_is_429_and_isolated_per_tenant(self, port_frontend):
        fe = port_frontend(quotas={"small": (0.0, 3.0)})
        codes = [_predict(fe, tenant="small", priority=0)[0] for _ in range(5)]
        assert codes == [200, 200, 200, 429, 429]
        status, headers, body = _predict(fe, tenant="small", priority=0)
        assert status == 429 and body == {"error": "over_quota", "tenant": "small"}
        assert "retry-after" in headers
        assert _predict(fe, tenant="big", priority=0)[0] == 200
        tenants = fe.stats()["admission"]["tenants"]
        assert tenants["small"]["admitted"] == 3 and tenants["small"]["over_quota"] == 3
        assert tenants["big"]["over_quota"] == 0

    def test_bucket_refills_with_injected_clock(self, port_frontend):
        now = [0.0]
        fe = port_frontend(quotas={"t": (1.0, 1.0)}, clock=lambda: now[0])
        assert _predict(fe, tenant="t")[0] == 200
        assert _predict(fe, tenant="t")[0] == 429
        now[0] += 2.0
        assert _predict(fe, tenant="t")[0] == 200


class TestPriorityOrdering:
    def test_priority0_overtakes_full_low_queue(self, port_frontend):
        release = threading.Event()
        executed = []
        lock = threading.Lock()

        def runner(batch):
            release.wait(10)
            with lock:
                executed.extend(batch)
            return list(batch)

        fe = port_frontend(runner=runner, priorities=3, max_batch=1, max_delay_ms=0.0,
                           max_queue=2)
        results, threads = {}, []

        def spawn(key, priority, payload):
            t = threading.Thread(target=lambda: results.__setitem__(key, _predict(
                fe, priority=priority, body=json.dumps(payload).encode())), daemon=True)
            t.start()
            threads.append(t)

        def wait_for(cond):
            deadline = time.monotonic() + 5
            while not cond():
                assert time.monotonic() < deadline
                time.sleep(0.01)

        spawn("wedge", 2, "wedge")
        wait_for(lambda: executed or fe.stats()["inflight"] >= 1)
        spawn("low1", 2, "low1")
        spawn("low2", 2, "low2")
        wait_for(lambda: fe.batcher.stats()["per_priority"][2]["queue_depth"] >= 2)
        spawn("hi", 0, "hi")
        wait_for(lambda: fe.batcher.stats()["per_priority"][0]["queue_depth"] >= 1)
        status, _, body = _predict(fe, priority=2, body=b'"low3"')
        assert status == 503 and body["error"] == "queue full"
        release.set()
        for t in threads:
            t.join(10)
        assert all(r[0] == 200 for r in results.values()), results
        assert executed[:2] == ["wedge", "hi"] and set(executed[2:]) == {"low1", "low2"}
        per_prio = fe.batcher.stats()["per_priority"]
        assert per_prio[0]["shed"] == 0 and per_prio[2]["shed"] == 1


class TestDrainContract:
    def test_inflight_finishes_new_requests_shed(self, port_frontend):
        release = threading.Event()
        fe = port_frontend(runner=lambda batch: (release.wait(10), list(batch))[1], max_batch=4,
                           max_delay_ms=0.0)
        inflight = {}
        t = threading.Thread(target=lambda: inflight.__setitem__("r", _predict(
            fe, priority=0, body=b'"inflight"', timeout=30)), daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while fe.stats()["inflight"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        drained = {}
        d = threading.Thread(target=lambda: drained.__setitem__("clean", fe.drain(timeout=15.0)),
                             daemon=True)
        d.start()
        while not fe.draining:
            time.sleep(0.01)
        status, _, body = _request(fe, "GET", "/readyz")
        assert status == 503 and body["state"] == "draining"
        status, _, body = _predict(fe, priority=0)
        assert status == 503 and body["error"] == "draining"
        release.set()
        t.join(10)
        d.join(15)
        assert drained.get("clean") is True and inflight["r"][0] == 200
        counts = fe.accounting()["counts_by_priority"][0]
        assert counts["completed"] == 1 and counts["shed_draining"] >= 1


class TestScenarios:
    def test_deterministic_per_seed(self):
        a = build_schedule("flash_crowd", requests=200, rate=500, seed=7)
        assert a == build_schedule("flash_crowd", requests=200, rate=500, seed=7)
        assert a != build_schedule("flash_crowd", requests=200, rate=500, seed=8)
        assert all(isinstance(x, Arrival) for x in a)
        assert all(a[i].t <= a[i + 1].t for i in range(len(a) - 1))

    def test_flash_crowd_burst_density(self):
        sched = build_schedule("flash_crowd", requests=2000, rate=1000.0, seed=0,
                               flash_factor=10.0)
        t0, t1 = 2.0 / 3.0, 2.0 / 3.0 + 2.0 / 6.0
        burst = [a.t for a in sched if t0 <= a.t < t1]
        before = sum(1 for a in sched if a.t < t0)
        assert len(burst) / max(burst[-1] - burst[0], 1e-9) > 4.0 * max(before / t0, 1.0)

    def test_heavy_tail_is_heavier_than_poisson(self):
        def ratio(sched):
            ts = [a.t for a in sched]
            g = sorted(t2 - t1 for t1, t2 in zip(ts, ts[1:]))
            return g[-1] / max(percentile(g, 50.0), 1e-12)

        heavy = build_schedule("heavy_tail", requests=2000, rate=1000, seed=0, heavy_sigma=1.5)
        poisson = build_schedule("poisson", requests=2000, rate=1000, seed=0)
        assert ratio(heavy) > 3.0 * ratio(poisson)

    def test_diurnal_and_slow_client_and_mix(self):
        sched = build_schedule("diurnal", requests=2000, rate=1000, seed=3, diurnal_amp=0.8)
        first = sum(1 for a in sched if a.t % 2.0 < 1.0)
        assert first > 1.3 * (len(sched) - first)
        slow = build_schedule("slow_client", requests=1000, rate=500, seed=1, slow_fraction=0.25)
        assert 0.15 < sum(a.slow for a in slow) / 1000 < 0.35
        assert not any(a.slow for a in build_schedule("poisson", requests=100, rate=100, seed=0))
        mix = build_schedule("poisson", requests=3000, rate=1000, seed=0, tenants=("a", "b"),
                             tenant_weights=(0.8, 0.2))
        by_p = [sum(a.priority == p for a in mix) for p in range(3)]
        assert 0.05 < by_p[0] / 3000 < 0.15 and by_p[2] > by_p[1] > by_p[0]
        assert sum(a.tenant == "a" for a in mix) > 2.5 * sum(a.tenant == "b" for a in mix)


class TestVerdict:
    def test_per_priority_blocks_and_strict_json(self):
        v = http_slo_verdict(_accounting(), {"mean_occupancy": 0.5, "batches": 4,
                                             "max_queue_depth_seen": 3, "max_queue": 8},
                             _admission(), scenario="flash_crowd", rate=100.0, seed=0,
                             slo_p99_ms=10.0)
        assert v["requests_submitted"] == 12 and v["requests_completed"] == 5
        assert v["requests_shed"] + v["requests_failed"] + v["requests_rejected"] == 7
        assert v["per_priority"]["0"]["p99_ms"] == 3.0
        assert v["per_priority"]["2"]["p99_ms"] is None
        assert v["per_tenant"]["b"]["submitted"] == 5
        assert v["slo"] == {"p99_ms_target_priority0": 10.0, "p99_ms_priority0": 3.0,
                            "met": True}
        json.loads(json.dumps(v, allow_nan=False, sort_keys=True))


class TestFlashCrowdStub:
    def test_priority0_protected_sheds_only_low_or_quota(self, port_frontend):
        fe = port_frontend(runner=lambda batch: (time.sleep(0.004), list(batch))[1],
                           priorities=3, max_batch=4, max_delay_ms=1.0, max_queue=4,
                           quotas={"greedy": (50.0, 10.0)})
        sched = build_schedule("flash_crowd", requests=400, rate=400, seed=2, flash_factor=8.0,
                               tenants=("calm", "greedy"))
        raw = HttpLoadGenerator(fe.host, fe.port, sched, body_fn=lambda i: json.dumps(i).encode(),
                                content_type="application/json", concurrency=16).run()
        assert raw["dropped"] == 0 and raw["responses"] == raw["submitted"] == 400
        assert fe.drain(timeout=15.0)
        v = http_slo_verdict(fe.accounting(), fe.batcher.stats(), fe.admission.stats(),
                             scenario="flash_crowd", rate=400.0, seed=2, client=raw)
        assert (v["requests_completed"] + v["requests_shed"] + v["requests_failed"]
                == v["requests_submitted"] == 400)
        assert v["requests_shed"] > 0
        p0 = v["per_priority"]["0"]
        assert p0["shed_queue_full"] == 0 and p0["shed_draining"] == 0
        assert p0["completed"] == p0["submitted"] - p0["shed_over_quota"]
        assert (v["per_priority"]["1"]["shed_queue_full"]
                + v["per_priority"]["2"]["shed_queue_full"]) > 0
        assert v["per_tenant"]["greedy"]["over_quota"] > 0
        assert v["per_tenant"]["calm"]["over_quota"] == 0
        cap = fe.capacity.verdict_block()
        assert cap["demand"]["identity_ok"] is True


class TestTraceContextHardening:
    def _traced(self, port_frontend):
        from bdbnn_tpu_torch.obs.rtrace import RequestTracer

        tracer = RequestTracer(seed=0, sample_every=10**9)
        return port_frontend(lambda batch: list(batch), tracer=tracer), tracer

    @staticmethod
    def _wait(tracer, n=1):
        deadline = time.time() + 5
        while tracer.finished < n and time.time() < deadline:
            time.sleep(0.005)
        assert tracer.finished == n

    @pytest.mark.parametrize("bad", _BAD_CTX[:7])
    def test_malformed_header_means_fresh_local_trace(self, port_frontend, bad):
        fe, tracer = self._traced(port_frontend)
        status, headers, payload = _request(fe, "POST", "/v1/predict", body=b"[1]", headers={
            "x-priority": "0", "x-tenant": "tenant-a", "x-rtrace": bad})
        assert status == 200, payload
        assert "x-rtrace-stages" not in headers
        self._wait(tracer)
        assert _request(fe, "GET", "/healthz")[0] == 200

    def test_duplicate_header_is_ignored(self, port_frontend):
        fe, tracer = self._traced(port_frontend)
        ctx = "v=1;id=0123456789abcdef;seq=0;p=0"
        with socket.create_connection((fe.host, fe.port), timeout=10.0) as s:
            s.sendall(("POST /v1/predict HTTP/1.1\r\nhost: t\r\nx-priority: 0\r\n"
                       f"x-rtrace: {ctx}\r\nx-rtrace: {ctx}\r\ncontent-length: 3\r\n"
                       "connection: close\r\n\r\n[1]").encode("latin-1"))
            status, headers, _ = tloadgen.recv_response(s.makefile("rb"))
        assert status == 200 and "x-rtrace-stages" not in headers
        self._wait(tracer)

    def test_valid_context_is_adopted_and_stages_echoed(self, port_frontend):
        fe, tracer = self._traced(port_frontend)
        status, headers, payload = _request(fe, "POST", "/v1/predict", body=b"[1]", headers={
            "x-priority": "0", "x-rtrace": "v=1;id=0123456789abcdef;seq=7;p=0;tn=tenant-a"})
        assert status == 200, payload
        parsed = trtrace.parse_stage_header(headers["x-rtrace-stages"])
        assert parsed["id"] == "0123456789abcdef"
        assert sum(parsed["stages"].values()) == pytest.approx(parsed["total_ms"], abs=0.005)
        self._wait(tracer)
        assert tracer.attribution()["tail"]["0"][0]["trace"] == "0123456789abcdef"


# ---------------------------------------------------------------------------
# end to end on the tiny artifact, device="cpu"
# ---------------------------------------------------------------------------


def _http_kw(art, log_path, **kw):
    base = dict(artifact=art, log_path=str(log_path), buckets=(1, 4), priorities=3,
                queue_depth=8, max_delay_ms=2.0, scenario="poisson", rate=150.0, requests=60,
                concurrency=8, seed=0, default_quota="1000:1000", stats_interval_s=0.2,
                packed_weights=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def http_run(port_artifact, tmp_path_factory):  # noqa: F811
    """One port serve-http bench run and the reference's on the same config."""
    from bdbnn_tpu.serve.http import run_serve_http as jrun
    from bdbnn_tpu_torch.serve.http import run_serve_http as trun

    d = tmp_path_factory.mktemp("http")
    port = trun(TConfig(**_http_kw(port_artifact, d / "port", device="cpu")))
    ref = jrun(JConfig(**_http_kw(port_artifact, d / "ref")))
    return port, ref


def test_bench_verdict_has_the_reference_schema(http_run):
    from bdbnn_tpu_torch.obs.events import read_events

    (port, ref), v = http_run, http_run[0]["verdict"]
    rv = ref["verdict"]
    assert set(v) == set(rv) and v["serve_verdict"] == rv["serve_verdict"] == 8
    for block in ("per_priority", "per_tenant", "client", "attribution", "capacity",
                  "resident", "packed", "warmup_compile_s", "provenance"):
        assert set(v[block]) == set(rv[block]), block
    for p in v["per_priority"]:
        assert set(v["per_priority"][p]) == set(rv["per_priority"][p])
    assert set(v["capacity"]["demand"]) == set(rv["capacity"]["demand"])
    assert all(v[k] is None for k in ("replicas", "swap", "canary", "fleet", "scaling"))
    assert v["client"]["dropped"] == 0 and v["client"]["responses"] == v["client"]["submitted"]
    assert v["requests_completed"] + v["requests_shed"] + v["requests_failed"] == 60
    assert v["requests_failed"] == 0 and v["drained_clean"] and not v["preempted"]
    assert v["capacity"]["demand"]["identity_ok"] is True
    assert {"read", "admit", "queue", "compute", "respond"} <= {
        s for s, b in v["attribution"]["stages"].items() if b is not None}
    assert v["packed"]["resident_ratio"] == rv["packed"]["resident_ratio"]
    with open(os.path.join(port["run_dir"], "verdict.json")) as f:
        assert json.load(f) == v
    events = read_events(port["run_dir"])
    assert {"http", "admission", "serve", "capacity", "rtrace", "memory"} <= {
        e["kind"] for e in events}
    phases = [e["phase"] for e in events if e["kind"] == "http"]
    assert phases[0] == "start" and "ready" in phases and "drain" in phases
    assert phases[-1] == "stop"
    stop = [e for e in events if e["kind"] == "http"][-1]
    assert stop["forwards"] == 2 + v["batches"]  # the two warmup buckets, a batch each


def test_the_reference_tools_read_the_port_run(http_run, tmp_path):
    from bdbnn_tpu.obs.compare import compare_runs
    from bdbnn_tpu.obs.events import read_events
    from bdbnn_tpu.obs.summarize import summarize_run
    from bdbnn_tpu.obs.watch import render_status

    port, v = http_run[0], http_run[0]["verdict"]
    status = render_status(read_events(port["run_dir"]), None)
    assert "http:" in status and "SLO:" in status
    report, summary = summarize_run(port["run_dir"])
    assert summary["serving"]["http"]["port"] == port["port"]
    assert summary["serving"]["verdict"]["per_priority"] is not None
    assert "p99" in report
    base = os.path.join(port["run_dir"], "verdict.json")
    worse = str(tmp_path / "worse.json")
    with open(worse, "w") as f:
        json.dump({**v, "p99_ms": 3 * v["p99_ms"] + 1.0}, f)
    assert compare_runs([base, base], tol_rel=0.10)["verdict"] == "pass"
    r = compare_runs([base, worse], tol_rel=0.10)
    assert r["verdict"] == "regression"
    assert "serve_p99_ms" in [m["metric"] for c in r["comparisons"] for m in c["metrics"]
                              if m["verdict"] == "regression"]


def _serve_in_main_thread(cfg, client):
    """``run_serve_http`` in serve mode on this (main) thread; ``client(host,
    port)`` runs on another once /readyz answers 200, then SIGTERMs us."""
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.serve.http import run_serve_http

    out = {}

    def drive():
        try:
            deadline = time.monotonic() + 60
            start = None
            while start is None and time.monotonic() < deadline:
                for ev in glob.glob(os.path.join(cfg.log_path, "*", "events.jsonl")):
                    start = next((e for e in read_events(os.path.dirname(ev), "http")
                                  if e["phase"] == "start"), None)
                time.sleep(0.01)

            class _Fe:
                host, port = start["host"], start["port"]

            seen = set()
            while time.monotonic() < deadline:
                status, _, body = _request(_Fe, "GET", "/readyz")
                seen.add((status, body["state"]))
                assert _request(_Fe, "GET", "/healthz")[0] == 200
                if status == 200:
                    break
                time.sleep(0.005)
            out["readyz"] = seen
            out["result"] = client(_Fe)
        except BaseException as e:  # pragma: no cover - reported below
            out["error"] = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    res = run_serve_http(cfg)
    t.join(30)
    if "error" in out:
        raise out["error"]
    return res, out


def test_answers_over_the_wire(port_artifact, tmp_path):  # noqa: F811
    """Serve mode: 12 requests one at a time (6 raw float32, 6 JSON) each
    equal to the port engine's logits of that image alone rounded to 4
    places, bitwise; 16 more at once over several priorities and tenants;
    every answer within 5e-5 + 2e-5·max|logit| of the JAX engine's, with
    its top-1; SIGTERM drains and the verdict's ledger identity holds."""
    from bdbnn_tpu.serve.engine import InferenceEngine as JEngine
    from bdbnn_tpu_torch.serve.engine import InferenceEngine as TEngine

    x = _images(28, 5)
    cfg = TConfig(**_http_kw(port_artifact, tmp_path, scenario="", packed_weights=False,
                             device="cpu"))

    def post(fe, i, raw, priority, tenant):
        headers = {"x-priority": str(priority), "x-tenant": tenant}
        if raw:
            headers["content-type"] = "application/octet-stream"
            body = x[i].astype("<f4").tobytes()
        else:
            headers["content-type"] = "application/json"
            body = json.dumps(x[i].tolist()).encode()
        status, _, payload = _request(fe, "POST", "/v1/predict", headers=headers, body=body)
        return status, payload

    def client(fe):
        answers = {i: post(fe, i, i % 2 == 0, i % 3, "tenant-a") for i in range(12)}
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, post(fe, i, i % 2 == 1, i % 3, f"t{i % 2}"))) for i in range(12, 28)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        status, _, stats = _request(fe, "GET", "/statsz")
        return answers, status, stats

    res, out = _serve_in_main_thread(cfg, client)
    answers, st_status, stats = out["result"]
    assert (503, "warming") in out["readyz"] or (200, "ready") in out["readyz"]
    assert st_status == 200 and {"batcher", "admission", "capacity"} <= set(stats)
    assert all(answers[i][0] == 200 for i in range(28)), answers
    got = np.array([answers[i][1]["result"]["logits"] for i in range(28)])
    engine = TEngine(port_artifact, buckets=(1,), device="cpu")
    alone = np.concatenate([engine.predict_logits(x[i:i + 1]) for i in range(28)])
    for i in range(12):
        assert answers[i][1]["result"]["logits"] == [round(float(v), 4) for v in alone[i]]
        assert answers[i][1]["result"]["pred"] == int(np.argmax(alone[i]))
    ref = JEngine(port_artifact, buckets=(1,)).predict_logits(x)
    tol = 5e-5 + 2e-5 * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    assert [answers[i][1]["result"]["pred"] for i in range(28)] == ref.argmax(-1).tolist()
    v = res["verdict"]
    assert v["preempted"] is True and v["drained_clean"] is True and v["scenario"] == "serve"
    assert v["requests_submitted"] == v["requests_completed"] == 28
    assert v["rate_rps"] is not None and v["client"] is None
    assert v["capacity"]["demand"]["identity_ok"] is True


def test_sigterm_mid_flash_crowd_zero_dropped(port_artifact, tmp_path):  # noqa: F811
    from bdbnn_tpu_torch.serve.http import run_serve_http

    cfg = TConfig(**_http_kw(port_artifact, tmp_path, scenario="flash_crowd",
                             requests=10_000, rate=100.0, packed_weights=False, device="cpu"))
    pid = os.getpid()
    killer = threading.Timer(2.5, lambda: os.kill(pid, signal.SIGTERM))
    killer.start()
    try:
        v = run_serve_http(cfg)["verdict"]
    finally:
        killer.cancel()
    assert v["preempted"] is True and v["drained_clean"] is True
    assert v["client"]["dropped"] == 0
    assert v["client"]["responses"] == v["client"]["submitted"] < 10_000
    assert v["requests_completed"] + v["requests_shed"] + v["requests_failed"] == (
        v["requests_submitted"])
    assert v["requests_failed"] == 0


@pytest.mark.slow
def test_flash_crowd_soak_priority0_slo(port_artifact, tmp_path):  # noqa: F811
    """The reference's flash-crowd soak on the port: priority 0's p99 within
    the SLO, server-overload sheds never on priority 0, the throttled
    tenant over quota and the calm one not."""
    from bdbnn_tpu_torch.serve.http import run_serve_http

    cfg = TConfig(**_http_kw(port_artifact, tmp_path, scenario="flash_crowd", requests=2000,
                             rate=400.0, flash_factor=8.0, concurrency=24, slo_p99_ms=2000.0,
                             tenant_quotas=("greedy=100:50",), tenants=("calm", "greedy"),
                             packed_weights=False, device="cpu"))
    v = run_serve_http(cfg)["verdict"]
    assert v["client"]["dropped"] == 0 and v["requests_failed"] == 0
    p0 = v["per_priority"]["0"]
    assert p0["shed_queue_full"] == 0 and p0["shed_draining"] == 0
    assert v["slo"]["met"], p0["p99_ms"]
    assert v["per_tenant"]["greedy"]["over_quota"] > 0
    assert v["per_tenant"]["calm"]["over_quota"] == 0


@pytest.mark.slow
def test_slow_client_soak(port_artifact, tmp_path):  # noqa: F811
    """Slow writers dribbling bodies stall no one: every request answered."""
    from bdbnn_tpu_torch.serve.http import run_serve_http

    cfg = TConfig(**_http_kw(port_artifact, tmp_path, scenario="slow_client", requests=600,
                             rate=150.0, slow_fraction=0.25, concurrency=24,
                             packed_weights=False, device="cpu"))
    v = run_serve_http(cfg)["verdict"]
    assert v["client"]["dropped"] == 0
    assert v["client"]["responses"] == v["client"]["submitted"]
    assert v["requests_completed"] + v["requests_shed"] == v["requests_submitted"]
    assert v["requests_failed"] == 0 and v["drained_clean"] and not v["preempted"]


def test_cli_runs_on_the_cpu_only_when_asked(port_artifact, tmp_path, capsys):  # noqa: F811
    """``python -m bdbnn_tpu_torch.cli serve-http ... --device cpu`` exits 0
    with the verdict on stdout; without ``--device cpu`` there is no card
    here and it raises before any run dir; ``--swap-to/--swap-at`` swaps
    under the load (one replica) and the verdict's ``swap`` block has the
    reference's keys; the ``degrade`` hook fails the swapped-to version's
    batches alone."""
    from bdbnn_tpu_torch import cli

    args = ["serve-http", port_artifact, "--scenario", "poisson", "--rate", "100", "--requests",
            "24", "--buckets", "1", "4", "--default-quota", "1000:1000", "--log-path",
            str(tmp_path / "log")]
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", *args, "--device", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    v = json.loads(r.stdout)
    assert v["requests_completed"] == 24 and v["client"]["dropped"] == 0
    assert "[serve-http] run dir:" in r.stderr
    if not torch.cuda.is_available():
        args[-1] = str(tmp_path / "not-written")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
        assert not os.path.exists(args[-1])
    import shutil

    from bdbnn_tpu.serve import pool as jpool
    from bdbnn_tpu_torch.serve.http import run_serve_http

    v2 = str(tmp_path / "v2")
    shutil.copytree(port_artifact, v2)
    args[-1] = str(tmp_path / "swap")
    capsys.readouterr()
    assert cli.main([*args, "--device", "cpu", "--swap-to", v2, "--swap-at", "0.5"]) == 0
    v = json.loads(capsys.readouterr().out)
    swap = v["swap"]
    jp = jpool.ReplicaPool(lambda ref, dev: (lambda b: list(b)), ["d0", "d1"])
    try:
        jadmin = jpool.PoolAdmin(jp)
        assert jadmin.start_swap({"artifact": v2})[0] == 202 and jadmin.wait(10)
        assert set(swap) == set(jadmin.swap_report())
    finally:
        jp.drain(timeout=5.0)
    assert swap["performed"] and swap["state"] == "done" and swap["version_to"] == "v2"
    assert swap["replicas_shifted"] == 1
    assert sum(swap["answered_by"].values()) == v["requests_completed"]
    assert v["requests_completed"] + v["requests_shed"] == 24 and v["client"]["dropped"] == 0
    # the degrade hook: every batch of the swapped-to version fails, and
    # the incumbent's answer
    # the swap fires after 10 of 120 requests, so the later ones meet v2
    out = run_serve_http(TConfig(**_http_kw(port_artifact, tmp_path / "deg", swap_to=v2,
                                            swap_at=0.09, requests=120, device="cpu")),
                         degrade={"artifact": v2, "error_rate": 1.0})
    dv = out["verdict"]
    assert dv["swap"]["performed"] and dv["client"]["dropped"] == 0
    assert set(dv["swap"]["answered_by"]) == {swap["version_from"]}
    assert dv["requests_failed"] > 0
    assert dv["requests_completed"] == dv["swap"]["answered_by"][swap["version_from"]]


def test_two_resident_models_route_by_x_model(port_artifact, tmp_path):  # noqa: F811
    """``--registry`` with ``--resident-models 2``: requests naming v0001
    and v0002 answer from their own version's engine; an unknown version
    is 404 and reaches no engine."""
    from test_torch_serve import _port_tiny

    from bdbnn_tpu_torch.serve import export as texport
    from bdbnn_tpu_torch.serve.engine import InferenceEngine as TEngine
    from bdbnn_tpu_torch.serve.registry import ArtifactRegistry

    other = str(tmp_path / "other")
    texport.write_artifact(_port_tiny(seed=1).to_flax(), other, arch="resnet8_tiny",
                           dataset="cifar10")
    root = str(tmp_path / "reg")
    ArtifactRegistry(root).publish(port_artifact)
    ArtifactRegistry(root).publish(other)
    x = _images(4, 9)
    cfg = TConfig(**_http_kw("v0001", tmp_path / "log", scenario="", packed_weights=True,
                             registry=root, resident_models=2, device="cpu"))

    def client(fe):
        out = {}
        for model in ("v0001", "v0002"):
            out[model] = [_request(fe, "POST", "/v1/predict", body=x[i].astype("<f4").tobytes(),
                                   headers={"content-type": "application/octet-stream",
                                            "x-model": model, "x-priority": "0"})
                          for i in range(4)]
        out["bad"] = _predict(fe, priority=0, model="v0009", body=json.dumps(
            x[0].tolist()).encode())
        out["replicas"] = _request(fe, "GET", "/admin/replicas")
        return out

    res, out = _serve_in_main_thread(cfg, client)
    answers = out["result"]
    for model, art in (("v0001", port_artifact), ("v0002", other)):
        want = TEngine(art, buckets=(1,), device="cpu").predict_logits(x)
        for i, (status, _, payload) in enumerate(answers[model]):
            assert status == 200
            assert payload["model"] == (None if model == "v0001" else model)
            assert payload["result"]["logits"] == [round(float(v), 4) for v in want[i]]
    assert answers["v0001"] != answers["v0002"]
    status, _, body = answers["bad"]
    assert status == 404 and "v0009" in json.dumps(body)
    assert answers["replicas"][0] == 200
    v = res["verdict"]
    assert v["requests_completed"] == 8 and v["requests_rejected"] == 1
    assert set(v["resident"]["models"]) == {"default", "v0002"}
    assert v["resident"]["models"]["v0002"]["completed"] == 4
    assert v["replicas"]["n"] == 1 and v["packed"]["mode"] == "on"
    from bdbnn_tpu_torch.obs.events import read_events

    stop = [e for e in read_events(res["run_dir"], "http") if e["phase"] == "stop"][0]
    # the two engines' forwards: two warmup buckets each, and 4 requests each one at a time
    assert stop["forwards"] == 2 * 2 + 8

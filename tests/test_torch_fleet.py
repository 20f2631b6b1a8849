"""The fleet router on the port (``bdbnn_tpu_torch/serve/fleet.py``, the
``ServeFleetConfig`` of ``serve/config.py`` and ``cli serve-fleet``)
against the JAX package's (``bdbnn_tpu/serve/fleet.py``), on the CPU.

- Exact parity (``==``): ``backoff_s`` over a grid, ``parse_hosts``,
  ``ServeFleetConfig.validate``'s refusals and their messages, and
  ``fleet_slo_verdict`` on fixed ledgers.
- Both routers over the reference's stub backends (raw threaded HTTP
  servers scripted per route, ``tests/test_fleet.py``), driven through the
  same scenarios: occupancy spread, retry never duplicates, connect
  refused, relayed 429/503, a draining host's bleed, the probe's debounce
  and recovery, a failing ``/statsz`` never feeding the detector, the
  host-by-host swap, the endpoints, the scraped capacity merge and the
  verdict over a socket load. Per-host counts, retry causes, relayed
  sheds and probe transitions are compared; latencies are not. Retry
  backoff is zero there, so which host a request meets depends on the
  round-robin alone.
- The reference's ``compare`` reads a port fleet verdict's
  ``serve_fleet_*`` keys and exits 3 on a doctored dropped count.

The end-to-end runs over real port ``serve-http`` hosts are in
``test_torch_fleet_e2e.py`` and ``test_torch_fleet_faults.py``; the
helpers that spawn and reap those hosts live here.
"""

import dataclasses
import json
import os
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time

import pytest

from bdbnn_tpu.configs.config import ServeFleetConfig as JConfig
from bdbnn_tpu.serve import fleet as jfleet
from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.serve import fleet as tfleet
from bdbnn_tpu_torch.serve.config import ServeFleetConfig as TConfig
from bdbnn_tpu_torch.serve.loadgen import HttpLoadGenerator, build_schedule, recv_response

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTERS = {"jax": jfleet, "port": tfleet}


# ---------------------------------------------------------------------------
# exact parity
# ---------------------------------------------------------------------------


def test_backoff_and_parse_hosts_equal_the_reference():
    assert tfleet.RETRY_CAUSES == jfleet.RETRY_CAUSES
    assert (tfleet.HOST_WARMING, tfleet.HOST_READY, tfleet.HOST_DRAINING, tfleet.HOST_DEAD) == (
        jfleet.HOST_WARMING, jfleet.HOST_READY, jfleet.HOST_DRAINING, jfleet.HOST_DEAD)
    for base in (0.0, 0.001, 0.025, 1.5):
        for cap in (0.0, 0.01, 0.25, 10.0):
            got = [tfleet.backoff_s(a, base, cap) for a in range(-3, 70)]
            assert got == [jfleet.backoff_s(a, base, cap) for a in range(-3, 70)]
    assert tfleet.backoff_s(4, 0.025, 0.25) == 0.25 and tfleet.backoff_s(2, 0.025, 0.25) == 0.1
    specs = ("127.0.0.1:81", "h:9", "[::1]:8100", "a.b.c:65535", "x:0")
    assert tfleet.parse_hosts(specs) == jfleet.parse_hosts(specs)
    assert tfleet.parse_hosts(specs)[2] == ("[::1]", 8100)


FLEET_CASES = [
    dict(hosts=()),
    dict(hosts=("nope",)),
    dict(hosts=("a:x",)),
    dict(hosts=(":80",)),
    dict(hosts=("a:1", "a:1")),
    dict(hosts=("a:1",), priorities=0),
    dict(hosts=("a:1",), probe_interval_s=0.0),
    dict(hosts=("a:1",), probe_timeout_s=-1.0),
    dict(hosts=("a:1",), health_warmup=-1),
    dict(hosts=("a:1",), health_debounce=0),
    dict(hosts=("a:1",), max_attempts=0),
    dict(hosts=("a:1",), backoff_base_ms=-1.0),
    dict(hosts=("a:1",), proxy_timeout_s=0.0),
    dict(hosts=("a:1",), ready_timeout_s=0.0),
    dict(hosts=("a:1",), scenario="bogus"),
    dict(hosts=("a:1",), scenario="poisson"),
    dict(hosts=("a:1",), scenario="poisson", artifact="art", requests=0),
    dict(hosts=("a:1",), scenario="poisson", artifact="art", concurrency=0),
    dict(hosts=("a:1",), priority_weights=(1.0, 2.0)),
    dict(hosts=("a:1",), priority_weights=(0.0, 0.0, 0.0)),
    dict(hosts=("a:1",), tenants=()),
    dict(hosts=("a:1",), tenant_weights=(1.0,)),
    dict(hosts=("a:1",), slow_fraction=1.5),
    dict(hosts=("a:1",), slo_p99_ms=-1.0),
    dict(hosts=("a:1",), slo_shed_rate=2.0),
    dict(hosts=("a:1",), stats_interval_s=0.0),
    dict(hosts=("a:1",), events_max_mb=-1.0),
    dict(hosts=("a:1",), rtrace_sample_every=0),
    dict(hosts=("a:1",), rtrace_tail_k=-1),
    dict(hosts=("a:1",), scrape_timeout_s=0.0),
    dict(hosts=("a:1",), scrape_stale_after=0),
    dict(hosts=("a:1",), swap_at=1.0),
    dict(hosts=("a:1",), swap_at=0.5),
    dict(hosts=("a:1",), swap_at=0.5, swap_to="art2"),
    dict(hosts=("a:1",), swap_to="v0002"),
    dict(hosts=("a:1", "b:2"), host_registries=("r1",)),
    dict(hosts=("a:1",), swap_host_timeout_s=0.0),
    # these validate
    dict(hosts=("a:1", "b:2")),
    dict(hosts=("a:1",), scenario="flash_crowd", artifact="art", swap_at=0.5, swap_to="art2"),
    dict(hosts=("a:1", "b:2"), registry="reg", swap_to="v0002", host_registries=("r1", "r2")),
]


@pytest.mark.parametrize("kw", FLEET_CASES, ids=lambda kw: ",".join(sorted(kw)) or "none")
def test_config_refusals_equal_the_reference(kw):
    out = []
    for cls in (TConfig, JConfig):
        try:
            out.append(("ok", dataclasses.asdict(cls(**kw).validate())))
        except ValueError as e:
            out.append(("refused", str(e)))
    assert out[0] == out[1]


def _fleet_block(completed=(40, 37)):
    hosts = {
        f"h{i}": {"host": "127.0.0.1", "port": 8100 + i, "state": "ready", "server_id": f"h{i}",
                  "inflight": 0, "proxied": c + 2, "completed": c, "relayed_429": 1,
                  "relayed_503": 1, "relayed_other": 0,
                  "retries": {"connect": i, "timeout": 0, "reset": 2 * i},
                  "retried_away": 3 * i, "probes": 50, "probe_transitions": 1,
                  "p99_ms": 20.0 + 5 * i}
        for i, c in enumerate(completed)}
    return {"n_hosts": 2, "hosts": hosts, "submitted": sum(completed) + 5,
            "completed_total": sum(completed), "relayed_total": 4, "router_unrouteable": 1,
            "router_shed_draining": 0, "retries_total": 3, "retry_rate": 0.03659,
            "host_p99_spread": 1.25, "dropped": 0, "ledger_consistent": True, "swap": None}


def _accounting():
    lats = [[3.0 + 0.5 * i for i in range(13)], [4.0 + 0.25 * i for i in range(30)],
            [6.0 + i for i in range(34)]]
    counts = [
        {"submitted": 14, "completed": 13, "failed": 0, "rejected": 0, "shed_draining": 0,
         "shed_over_quota": 1, "shed_queue_full": 0, "shed_unavailable": 0},
        {"submitted": 32, "completed": 30, "failed": 0, "rejected": 1, "shed_draining": 0,
         "shed_over_quota": 0, "shed_queue_full": 1, "shed_unavailable": 0},
        {"submitted": 36, "completed": 34, "failed": 0, "rejected": 0, "shed_draining": 1,
         "shed_over_quota": 0, "shed_queue_full": 0, "shed_unavailable": 1},
    ]
    return {"wall_s": 1.75, "latencies_ms_by_priority": lats, "counts_by_priority": counts,
            "measured_rate_rps": 47.5}


@pytest.mark.parametrize("slo", [0.0, 10.0, 100.0])
@pytest.mark.parametrize("blocks", [False, True])
def test_fleet_slo_verdict_equals_the_reference(slo, blocks):
    client = {"submitted": 82, "responses": 82, "dropped": 0,
              "by_status": {"200": 77, "429": 1, "503": 4}, "wall_s": 1.8}
    kw = dict(scenario="flash_crowd", rate=50.0, seed=3, client=client, slo_p99_ms=slo,
              provenance={"hosts": ["a:1", "b:2"], "artifact": "/x", "config_hash": None,
                          "recipe": {}, "serve_config_hash": "abc"}, drained_clean=True)
    if blocks:
        kw["fleet_attribution"] = {"requests": 77, "retry_hop_share": 0.0}
        kw["capacity"] = {"fleet": {}, "burn_rate_max": 0.5, "headroom_rps": 10.0,
                          "demand_shed_ratio_max": 0.1}
    got = tfleet.fleet_slo_verdict(_accounting(), _fleet_block(), **kw)
    want = jfleet.fleet_slo_verdict(_accounting(), _fleet_block(), **kw)
    assert got == want
    assert got["mode"] == "fleet" and got["requests_completed"] == 77
    assert (got["slo"] is None) == (slo == 0.0)


# ---------------------------------------------------------------------------
# both routers over scripted stub backends
# ---------------------------------------------------------------------------


class StubBackend:
    """The reference's scriptable stub backend (``tests/test_fleet.py``):
    a threaded HTTP server whose ``predict`` returns ``(status, obj)`` or
    ``"die"`` (tear the connection without a response); ``admin`` answers
    ``/admin/swap``."""

    def __init__(self, server_id, predict=None, admin=None, port=0):
        self.server_id = server_id
        self.predict = predict or (lambda headers, body: (200, {"result": 1}))
        self.admin = admin
        self.ready_state = "ready"
        self.predict_seen = 0
        self._lock = threading.Lock()
        backend = self

        class Handler(socketserver.StreamRequestHandler):
            timeout = 10.0

            def handle(self):
                while True:
                    try:
                        req = tfleet._read_request(self.rfile, 2**20)
                    except (ValueError, OSError):
                        return
                    if req is None:
                        return
                    method, path, headers, body = req
                    out = backend._route(method, path, headers, body)
                    if out == "die":
                        return
                    status, obj = out
                    payload = json.dumps(obj).encode()
                    head = (f"HTTP/1.1 {status} X\r\ncontent-type: application/json\r\n"
                            f"content-length: {len(payload)}\r\n")
                    if status in (429, 503):
                        head += "retry-after: 1\r\n"
                    try:
                        self.wfile.write(head.encode() + b"\r\n" + payload)
                        self.wfile.flush()
                    except OSError:
                        return
                    if headers.get("connection", "") == "close":
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._srv = Server(("127.0.0.1", port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True,
                                        kwargs={"poll_interval": 0.05})
        self._thread.start()

    def _route(self, method, path, headers, body):
        if path == "/readyz":
            state = self.ready_state
            return (200, {"state": state}) if state == "ready" else (503, {"state": state})
        if path == "/statsz":
            return 200, {"state": self.ready_state, "inflight": 0, "server_id": self.server_id}
        if path.startswith("/admin/swap") and self.admin is not None:
            return self.admin(method, body)
        if path == "/v1/predict":
            with self._lock:
                self.predict_seen += 1
            return self.predict(headers, body)
        return 404, {"error": "no route"}

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)


def _predict(port, body=b"[1]", priority=0, timeout=10.0):
    """One raw predict against a router: (status, headers, parsed body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall((f"POST /v1/predict HTTP/1.1\r\nhost: x\r\nx-priority: {priority}\r\n"
                   "content-type: application/octet-stream\r\n"
                   f"content-length: {len(body)}\r\nconnection: close\r\n\r\n").encode() + body)
        status, headers, raw = recv_response(s.makefile("rb"))
    return status, headers, json.loads(raw) if raw else None


def _get(port, path):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nhost: x\r\nconnection: close\r\n\r\n".encode())
        return recv_response(s.makefile("rb"))[0]


def _router_over(mod, backends, **kw):
    """``mod.FleetRouter`` over ``backends``, started, once every host
    probed ready and advertised its id (so both routers begin from the
    same table). Retry backoff is zero unless asked for."""
    kw.setdefault("probe_interval_s", 0.05)
    kw.setdefault("probe_timeout_s", 1.0)
    kw.setdefault("health_debounce", 2)
    kw.setdefault("backoff_base_s", 0.0)
    kw.setdefault("backoff_cap_s", 0.0)
    router = mod.FleetRouter([("127.0.0.1", b.port) for b in backends], **kw)
    router.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with router._lock:
            if all(h.state == mod.HOST_READY and h.server_id for h in router.hosts):
                break
        time.sleep(0.01)
    else:
        raise AssertionError("the stub hosts never all probed ready")
    return router


def _ledger(router):
    """What is compared between the routers: each host's counters and
    state (its p99 left out), and the per-priority counts."""
    hosts = {k: {f: v for f, v in h.items() if f not in ("p99_ms", "port", "probes")}
             for k, h in router.stats()["hosts"].items()}
    return {"hosts": hosts, "counts": router.accounting()["counts_by_priority"]}


def _spread(mod):
    a, b = StubBackend("a"), StubBackend("b")
    router = _router_over(mod, [a, b])
    try:
        out = [_predict(router.port) for _ in range(12)]
        return {"statuses": [s for s, _, _ in out],
                "served_by": [h.get("x-served-by") for _, h, _ in out], **_ledger(router)}
    finally:
        router.drain(5.0)
        a.stop()
        b.stop()


def _no_duplicates(mod):
    a, b = StubBackend("a", predict=lambda h, body: "die"), StubBackend("b")
    router = _router_over(mod, [a, b], max_attempts=3)
    try:
        statuses = [_predict(router.port)[0] for _ in range(10)]
        return {"statuses": statuses, "seen": (a.predict_seen, b.predict_seen), **_ledger(router)}
    finally:
        router.drain(5.0)
        a.stop()
        b.stop()


def _connect_refused(mod):
    a, b = StubBackend("a"), StubBackend("b")
    router = _router_over(mod, [a, b])
    router.probe_interval_s = 60.0  # from the next wait on: only the retry can save it
    try:
        time.sleep(0.1)
        a.stop()  # dies between probe-ready and dispatch
        statuses = [_predict(router.port)[0] for _ in range(8)]
        return {"statuses": statuses, **_ledger(router)}
    finally:
        router.drain(5.0)
        b.stop()


def _relayed(mod):
    a = StubBackend("a", predict=lambda h, body: (503, {"error": "queue full"}))
    router = _router_over(mod, [a])
    try:
        out = [_predict(router.port), _predict(router.port, priority=1)]
        a.predict = lambda h, body: (429, {"error": "over_quota"})
        out.append(_predict(router.port))
        a.predict = lambda h, body: (503, {"error": "no healthy replica"})
        out.append(_predict(router.port, priority=2))
        a.predict = lambda h, body: (503, {"error": "draining"})
        out.append(_predict(router.port, priority=2))
        return {"answers": [(s, h.get("retry-after"), o) for s, h, o in out],
                "seen": a.predict_seen, **_ledger(router)}
    finally:
        router.drain(5.0)
        a.stop()


def _draining_bleed(mod):
    gate = threading.Event()

    def slow(headers, body):
        gate.wait(5.0)
        return 200, {"result": "slow"}

    a = StubBackend("a", predict=slow)
    router = _router_over(mod, [a])
    try:
        results = []
        t = threading.Thread(target=lambda: results.append(_predict(router.port)))
        t.start()
        time.sleep(0.2)
        a.ready_state = "draining"
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with router._lock:
                if router.hosts[0].state == mod.HOST_DRAINING:
                    break
            time.sleep(0.02)
        with router._lock:
            state, fired = router.hosts[0].state, router.hosts[0].detector.fired
        gate.set()
        t.join(5.0)
        after = _predict(router.port)
        return {"state": state, "fired": fired, "bled": results[0][0],
                "after": (after[0], after[2]["error"], bool(after[1].get("retry-after"))),
                **_ledger(router)}
    finally:
        gate.set()
        router.drain(5.0)
        a.stop()


def _debounce(mod):
    a = StubBackend("a")
    port = a.port
    router = mod.FleetRouter([("127.0.0.1", port)], probe_interval_s=60.0, probe_timeout_s=0.5,
                             health_debounce=3)
    router.start()
    h = router.hosts[0]
    trail = []

    def probe():
        router._probe_host(h)
        with router._lock:
            trail.append((h.state, h.detector.fired, h.transitions))

    try:
        probe()
        a.stop()
        for _ in range(4):
            probe()
        b = StubBackend("a2", port=port)  # back on the same port
        probe()
        b.stop()
        return {"trail": trail}
    finally:
        router.drain(5.0)


def _statsz_fails(mod):
    a = StubBackend("a")
    route = a._route
    a._route = lambda m, p, hd, b: "die" if p == "/statsz" else route(m, p, hd, b)
    router = mod.FleetRouter([("127.0.0.1", a.port)], probe_interval_s=60.0,
                             probe_timeout_s=0.5, health_debounce=2)
    router.start()
    h = router.hosts[0]
    try:
        for _ in range(5):
            router._probe_host(h)
        with router._lock:
            out = {"state": h.state, "fired": h.detector.fired, "statsz": h.last_statsz}
        out["predict"] = _predict(router.port)[0]
        return out
    finally:
        router.drain(5.0)
        a.stop()


def _swap(mod):
    active, max_active, lock = [], [0], threading.Lock()

    def make_admin(label, shed):
        state = {"state": "idle"}
        last = [None]

        def admin(method, body):
            if method == "POST":
                with lock:
                    active.append(label)
                    max_active[0] = max(max_active[0], len(active))
                state["state"] = "shifting"

                def finish():
                    time.sleep(0.15)
                    state["state"] = "done"
                    last[0] = {"state": "done", "shed": shed}
                    with lock:
                        active.remove(label)

                threading.Thread(target=finish, daemon=True).start()
                return 202, {"accepted": label}
            return 200, {"current": dict(state), "last": last[0]}

        return admin

    a = StubBackend("a", admin=make_admin("a", 3))
    b = StubBackend("b", admin=make_admin("b", 0))
    router = _router_over(mod, [a, b], swap_host_timeout_s=10.0)
    try:
        first = router.start_fleet_swap({"artifact": "/tmp/whatever"})[0]
        second = router.start_fleet_swap({"artifact": "/tmp/other"})[0]
        bad = router.start_fleet_swap({})[0]
        router.wait_swap(15.0)
        with router._lock:
            swap = dict(router._swap)
        return {"codes": (first, second, bad), "max_active": max_active[0], "swap": swap}
    finally:
        router.drain(10.0)
        a.stop()
        b.stop()


def _endpoints(mod):
    a = StubBackend("a")
    router = _router_over(mod, [a])
    try:
        codes = {p: _get(router.port, p) for p in (
            "/healthz", "/readyz", "/statsz", "/fleet/hosts", "/fleet/swap", "/nope")}
        s, _, obj = _predict(router.port, priority=9)
        codes["bad priority"] = (s, obj["error"])
        router.drain(5.0)
        codes["readyz drained"] = router.handle_request("GET", "/readyz", {}, b"")[0]
        codes["predict drained"] = router.handle_request("POST", "/v1/predict", {}, b"[1]")[:1]
        return {"codes": codes, **_ledger(router)}
    finally:
        router.drain(5.0)
        a.stop()


def _capacity(mod):
    cap_block = {"demand": {"offered_rps": 40.0, "demand_shed_ratio_max": 0.2},
                 "headroom": {"headroom_rps": 60.0, "capacity_rps_est": 100.0},
                 "slo_budget": {"detectors": {"p2:shed": {"burn_rate_fast": 3.0,
                                                          "burn_rate_slow": 2.0}}}}
    a = StubBackend("cap-a")
    route = a._route

    def with_capacity(method, path, headers, body):
        out = route(method, path, headers, body)
        if path == "/statsz":
            return out[0], dict(out[1], capacity=cap_block, rtrace={
                "stage_p99_ms": {"queue": 2.0}, "e2e_p99_ms_by_priority": {"0": 5.0}})
        return out

    a._route = with_capacity
    b = StubBackend("plain-b")
    router = _router_over(mod, [a, b], scrape_stale_after=2)
    try:
        measured = [router.accounting()["measured_rate_rps"]]
        _predict(router.port)
        measured.append(router.accounting()["measured_rate_rps"])
        for _ in range(3):
            router.scrape_host_stats()
        windows = router.stats()["host_windows"]
        for h in windows["hosts"].values():
            h.pop("age_s")
        return {"capacity": router.stats()["capacity"], "block": router.capacity_block(),
                "windows": windows, "measured": measured}
    finally:
        router.drain(5.0)
        a.stop()
        b.stop()


def _verdict(mod):
    a, b = StubBackend("a"), StubBackend("b")
    router = _router_over(mod, [a, b])
    try:
        gen = HttpLoadGenerator("127.0.0.1", router.port,
                                build_schedule("poisson", requests=40, rate=400.0, seed=0),
                                body_fn=lambda i: b"[1]", concurrency=4)
        client = gen.run()
        router.drain(5.0)
        fleet = router.fleet_block(client=client)
        v = mod.fleet_slo_verdict(router.accounting(), fleet, scenario="poisson", rate=400.0,
                                  seed=0, client=client)
        return {"client": {k: client[k] for k in ("submitted", "responses", "dropped",
                                                  "by_status")},
                "fleet": {k: fleet[k] for k in ("n_hosts", "submitted", "completed_total",
                                                "relayed_total", "retries_total", "retry_rate",
                                                "dropped", "ledger_consistent", "swap")},
                "host_keys": {k: sorted(h) for k, h in fleet["hosts"].items()},
                "verdict_keys": sorted(v), "requests_completed": v["requests_completed"],
                "schema": (v["serve_verdict"], v["mode"]), "spread": fleet["host_p99_spread"]
                is not None}
    finally:
        a.stop()
        b.stop()


SCENARIOS = {"spread": _spread, "no_duplicates": _no_duplicates,
             "connect_refused": _connect_refused, "relayed": _relayed,
             "draining_bleed": _draining_bleed, "debounce": _debounce,
             "statsz_fails": _statsz_fails, "swap": _swap, "endpoints": _endpoints,
             "capacity": _capacity, "verdict": _verdict}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_routers_agree_over_stub_backends(name):
    port, ref = (SCENARIOS[name](ROUTERS[k]) for k in ("port", "jax"))
    if name == "swap":
        # the port's router also sums each host's shift-window shed (its
        # one-replica hosts shed while they swap); the rest is the
        # reference's document
        assert port["swap"].pop("shed_by_host") == {"h0": 3, "h1": 0}
        assert port["swap"].pop("shed") == 3
        port["swap"].pop("seconds")
        ref["swap"].pop("seconds")
    assert port == ref
    check = CHECKS.get(name)
    if check is not None:
        check(port)


def _check_spread(r):
    assert set(r["statuses"]) == {200} and r["hosts"]["h0"]["completed"] > 0
    assert r["hosts"]["h1"]["completed"] > 0
    assert r["hosts"]["h0"]["completed"] + r["hosts"]["h1"]["completed"] == 12
    assert (r["hosts"]["h0"]["server_id"], r["hosts"]["h1"]["server_id"]) == ("a", "b")


def _check_no_duplicates(r):
    h0, h1 = r["hosts"]["h0"], r["hosts"]["h1"]
    assert set(r["statuses"]) == {200} and h1["completed"] == r["seen"][1] == 10
    assert h0["completed"] == 0 and 0 < h0["retried_away"] == h0["retries"]["reset"] == r["seen"][0]
    assert sum(h1["retries"].values()) == 0


def _check_connect_refused(r):
    h0 = r["hosts"]["h0"]
    assert set(r["statuses"]) == {200} and r["hosts"]["h1"]["completed"] == 8
    assert h0["completed"] == 0 and h0["retries"]["connect"] + h0["retries"]["reset"] > 0


def _check_relayed(r):
    assert [a[0] for a in r["answers"]] == [503, 503, 429, 503, 503] and r["seen"] == 5
    assert all(a[1] == "1" for a in r["answers"])
    h0 = r["hosts"]["h0"]
    assert (h0["relayed_503"], h0["relayed_429"], sum(h0["retries"].values())) == (4, 1, 0)
    c = r["counts"]
    assert (c[0]["shed_queue_full"], c[1]["shed_queue_full"], c[0]["shed_over_quota"]) == (1, 1, 1)
    assert (c[2]["shed_unavailable"], c[2]["shed_draining"]) == (1, 1)


def _check_draining(r):
    assert (r["state"], r["fired"], r["bled"]) == ("draining", 0, 200)
    assert r["after"] == (503, "no host available", True)
    assert r["counts"][0]["shed_unavailable"] == 1


def _check_debounce(r):
    assert [s for s, _, _ in r["trail"]] == ["ready", "ready", "ready", "dead", "dead", "ready"]
    assert [f for _, f, _ in r["trail"]] == [0, 0, 0, 1, 1, 1]


def _check_statsz(r):
    assert r == {"state": "ready", "fired": 0, "statsz": None, "predict": 200}


def _check_swap(r):
    assert r["codes"] == (202, 409, 400) and r["max_active"] == 1
    assert r["swap"]["state"] == "done" and r["swap"]["hosts_shifted"] == ["h0", "h1"]
    assert r["swap"]["hosts_unshifted"] == []


def _check_endpoints(r):
    c = r["codes"]
    assert [c[p] for p in ("/healthz", "/readyz", "/statsz", "/fleet/hosts", "/fleet/swap",
                           "/nope")] == [200, 200, 200, 200, 200, 404]
    assert c["bad priority"] == (400, "bad x-priority")
    assert (c["readyz drained"], c["predict drained"]) == (503, (503,))


def _check_capacity(r):
    snap = r["capacity"]
    assert (snap["hosts"]["h0"]["stale"], snap["hosts"]["h1"]["stale"]) == (False, True)
    assert snap["merged"]["offered_rps"] == 40.0 and snap["merged"]["burn_rate_max"] == 3.0
    assert r["block"]["headroom_rps"] == 60.0 and r["measured"] == [None, None]
    assert r["windows"]["hosts"]["h1"]["stale"] and not r["windows"]["hosts"]["h0"]["stale"]


def _check_verdict(r):
    assert r["client"]["dropped"] == 0 and r["fleet"]["ledger_consistent"] is True
    assert r["fleet"]["completed_total"] == r["requests_completed"] == 40
    assert r["schema"] == (8, "fleet") and r["spread"]


CHECKS = {"spread": _check_spread, "no_duplicates": _check_no_duplicates,
          "connect_refused": _check_connect_refused, "relayed": _check_relayed,
          "draining_bleed": _check_draining, "debounce": _check_debounce,
          "statsz_fails": _check_statsz, "swap": _check_swap, "endpoints": _check_endpoints,
          "capacity": _check_capacity, "verdict": _check_verdict}


def _scheduled_swap(mod, cfg_cls, art, root):
    """``mod.run_serve_fleet`` in scenario mode over two stub hosts with
    a swap at half the schedule (to ``art``, an artifact dir): the
    verdict and the ``fleet`` ``swap`` events."""

    def make_admin():
        state, last = {"state": "idle"}, [None]

        def admin(method, body):
            if method == "POST":
                state["state"] = "shifting"

                def finish():
                    time.sleep(0.05)
                    state["state"] = "done"
                    last[0] = {"state": "done", "shed": 1}

                threading.Thread(target=finish, daemon=True).start()
                return 202, {}
            return 200, {"current": dict(state), "last": last[0]}

        return admin

    a, b = StubBackend("a", admin=make_admin()), StubBackend("b", admin=make_admin())
    try:
        cfg = cfg_cls(hosts=(f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"), artifact=art,
                      log_path=os.path.join(root, "log"), scenario="poisson", rate=200.0,
                      requests=40, concurrency=4, probe_interval_s=0.05, swap_to=art,
                      swap_at=0.5, stats_interval_s=0.1)
        res = mod.run_serve_fleet(cfg)
    finally:
        a.stop()
        b.stop()
    swaps = [e for e in read_events(res["run_dir"], "fleet") if e.get("phase") == "swap"]
    return res["verdict"], swaps


def test_a_scheduled_fleet_swap_against_the_reference(tmp_path):
    """``--swap-to/--swap-at`` through ``run_serve_fleet`` on both
    packages: the same verdict counts and fleet swap document, and the
    port also sums each host's shift-window shed. The port's ``trigger``
    event lands; the reference's never does (its emit passes ``state``
    twice and raises inside the load generator's hook guard)."""
    art = tmp_path / "art"
    art.mkdir()
    (art / "artifact.json").write_text(json.dumps(
        {"image_size": 4, "provenance": {"recipe": {"arch": "resnet8_tiny"}}}))
    tv, tswaps = _scheduled_swap(tfleet, TConfig, str(art), str(tmp_path / "port"))
    jv, jswaps = _scheduled_swap(jfleet, JConfig, str(art), str(tmp_path / "jax"))
    tsw, jsw = dict(tv["fleet"]["swap"]), dict(jv["fleet"]["swap"])
    assert (tsw.pop("shed"), tsw.pop("shed_by_host")) == (2, {"h0": 1, "h1": 1})
    tsw.pop("seconds")
    jsw.pop("seconds")
    assert tsw == jsw and tsw["state"] == "done" and tsw["hosts_shifted"] == ["h0", "h1"]
    for key in ("requests_submitted", "requests_completed", "requests_shed"):
        assert tv[key] == jv[key]
    assert tv["fleet"]["ledger_consistent"] is jv["fleet"]["ledger_consistent"] is True
    assert [e["state"] for e in tswaps] == ["trigger", "shifted", "shifted", "done"]
    assert tswaps[0]["at_request"] == 20 and tswaps[0]["swap_state"] == "replicating"
    assert [e["state"] for e in jswaps] == ["shifted", "shifted", "done"]


def test_port_verdict_passes_the_references_compare(tmp_path):
    """The reference's ``compare`` flattens a port fleet verdict's
    ``serve_fleet_*`` keys, passes it against itself and exits 3 on a
    doctored dropped count."""
    from bdbnn_tpu.cli import main as jcli
    from bdbnn_tpu.obs.compare import _serve_metrics

    a, b = StubBackend("a"), StubBackend("b")
    router = _router_over(tfleet, [a, b])
    try:
        client = HttpLoadGenerator("127.0.0.1", router.port,
                                   build_schedule("poisson", requests=24, rate=300.0, seed=1),
                                   body_fn=lambda i: b"[1]", concurrency=4).run()
        router.drain(5.0)
        v = tfleet.fleet_slo_verdict(router.accounting(), router.fleet_block(client=client),
                                     scenario="poisson", rate=300.0, seed=1, client=client,
                                     fleet_attribution=None,
                                     capacity=router.capacity_block())
    finally:
        a.stop()
        b.stop()
    m = _serve_metrics(v)
    assert m["serve_fleet_dropped"] == 0 and m["serve_fleet_retry_rate"] == 0.0
    assert m["serve_fleet_host_p99_spread"] == v["fleet"]["host_p99_spread"]
    base, cand = tmp_path / "v.json", tmp_path / "doctored.json"
    base.write_text(json.dumps(v))
    cand.write_text(json.dumps({**v, "fleet": {**v["fleet"], "dropped": 3}}))
    assert jcli(["compare", str(base), str(base), "--json"]) == 0
    assert jcli(["compare", str(base), str(cand), "--json"]) == 3


# ---------------------------------------------------------------------------
# helpers of the end-to-end tests: port serve-http hosts on the CPU
# ---------------------------------------------------------------------------


def _events(root, kind):
    out = []
    for d, _, files in os.walk(str(root)):
        if "events.jsonl" in files:
            out += read_events(d, kind)
    return out


def spawn_host(art, root, server_id, extra=()):
    """One fleet host: the port's ``serve-http`` CLI in serve mode on the
    CPU, port 0 (read back from its ``http`` ``start`` event)."""
    return subprocess.Popen(
        [sys.executable, "-m", "bdbnn_tpu_torch.cli", "serve-http", art, "--device", "cpu",
         "--log-path", str(root), "--port", "0", "--buckets", "1", "8", "--queue-depth", "8",
         "--max-delay-ms", "2", "--default-quota", "100000:100000", "--server-id", server_id,
         "--rtrace-sample-every", "64", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_host(root, proc, timeout=120.0):
    """The host's bound port once its ``http`` ``ready`` event landed."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = _events(root, "http")
        start = [e for e in ev if e.get("phase") == "start"]
        if start and any(e.get("phase") == "ready" for e in ev):
            return start[0]["port"]
        if proc.poll() is not None:
            out, err = proc.communicate(timeout=10)
            raise AssertionError(f"host died rc={proc.returncode}\n{err[-2500:]}")
        time.sleep(0.05)
    raise AssertionError("host never reached http ready")


def reap(procs, timeout=60):
    outs = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs

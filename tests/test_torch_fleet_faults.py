"""Host faults under the port's fleet router, on the CPU: two port
``serve-http --device cpu`` hosts behind ``run_serve_fleet`` (the router
and its load in this process, as the reference's tests drive it).

- SIGSTOP one host mid-run with a short proxy timeout: the exchanges
  parked on it time out and hop to its peer, nothing is dropped, the
  ledger holds, the host's scraped window goes stale, and the v7
  ``fleet_attribution`` block charges the hop to ``retry_hop``; SIGCONT
  brings it back.
- Then SIGKILL the same host mid-run: its transport failures are retried
  on the peer (``connect``/``reset``), nothing is dropped, and the probe
  declares it ``dead`` only after the debounce.
"""

import signal
import time

from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.serve.config import ServeFleetConfig
from bdbnn_tpu_torch.serve.fleet import HOST_DEAD, run_serve_fleet

from test_torch_fleet import reap, spawn_host, wait_host
from test_torch_serve import port_artifact  # noqa: F401  (fixture)


def _cfg(art, ports, log_path, **kw):
    base = dict(hosts=tuple(f"127.0.0.1:{p}" for p in ports), artifact=art, log_path=log_path,
                scenario="poisson", rate=60.0, requests=60, concurrency=8, seed=0,
                probe_interval_s=0.1, health_debounce=2, max_attempts=3, proxy_timeout_s=30.0,
                ready_timeout_s=60.0, stats_interval_s=0.2, rtrace_sample_every=1,
                scrape_timeout_s=0.2, scrape_stale_after=2)
    base.update(kw)
    return ServeFleetConfig(**base)


def test_sigstop_then_sigkill_one_host(port_artifact, tmp_path):  # noqa: F811
    roots = [tmp_path / f"h{i}" for i in range(2)]
    hosts = [spawn_host(port_artifact, r, f"h{i}") for i, r in enumerate(roots)]
    try:
        ports = [wait_host(r, p) for r, p in zip(roots, hosts)]

        # SIGSTOP h1 after 10 arrivals; SIGCONT it when the run is over
        stopped = []

        def wedge(i):
            if not stopped and i >= 10:
                stopped.append(i)
                hosts[1].send_signal(signal.SIGSTOP)

        try:
            res = run_serve_fleet(_cfg(port_artifact, ports, str(tmp_path / "wedged"),
                                       proxy_timeout_s=0.75), on_arrival=wedge)
        finally:
            hosts[1].send_signal(signal.SIGCONT)
        v = res["verdict"]
        assert stopped and v["client"]["dropped"] == 0 and v["requests_failed"] == 0
        flt = v["fleet"]
        assert flt["ledger_consistent"] is True and flt["hosts"]["h1"]["retries"]["timeout"] > 0
        fa = v["fleet_attribution"]
        assert fa["retry_hop_share"] > 0 and fa["stages"]["retry_hop"]["p99_ms"] > 0
        assert fa["reconciliation"]["violations"] == 0
        events = read_events(res["run_dir"])
        rows = [e["host_windows"]["hosts"]["h1"] for e in events
                if e["kind"] == "fleet" and e.get("phase") == "stats"
                and "h1" in (e.get("host_windows") or {}).get("hosts", {})]
        assert any(r["stale"] for r in rows) and any(r["failures"] > 0 for r in rows)
        waterfalls = [e for e in events if e["kind"] == "rtrace" and e.get("phase") == "request"]
        assert any(w["attempts"] >= 2 and w["slowest_stage"] == "retry_hop" for w in waterfalls)

        # SIGKILL h1 after 20 arrivals: no drain, no goodbye
        killed = []

        def kill(i):
            if not killed and i >= 20:
                killed.append(time.time())
                hosts[1].kill()

        res = run_serve_fleet(_cfg(port_artifact, ports, str(tmp_path / "killed"),
                                   requests=80), on_arrival=kill)
        v = res["verdict"]
        flt = v["fleet"]
        assert killed and v["client"]["dropped"] == 0 and flt["dropped"] == 0
        assert flt["ledger_consistent"] is True and v["requests_failed"] == 0
        h1 = flt["hosts"]["h1"]
        assert h1["retries"]["connect"] + h1["retries"]["reset"] > 0
        assert h1["state"] == HOST_DEAD and flt["hosts"]["h0"]["completed"] > 0
        # dead only once two probes in a row failed (debounce 2): at least
        # one probe interval after the kill, straight from ready
        dead = [e for e in read_events(res["run_dir"], "fleet") if e.get("phase") == "probe"
                and e.get("host") == "h1" and e["state_to"] == HOST_DEAD]
        assert len(dead) == 1 and dead[0]["state_from"] == "ready"
        assert dead[0]["t"] - killed[0] >= 0.1
        assert hosts[1].wait(30) == -signal.SIGKILL
    finally:
        reap(hosts)

"""The fleet end to end on the port, on the CPU: two port ``serve-http
--device cpu`` hosts (subprocesses on port 0, each port read from the
host's ``http`` ``start`` event) behind ``python -m bdbnn_tpu_torch.cli
serve-fleet``, which drives a flash crowd from its own process; one host
is SIGTERMed half way through."""

import json
import signal
import subprocess
import sys
import time

from test_torch_fleet import REPO, _events, reap, spawn_host, wait_host
from test_torch_serve import port_artifact  # noqa: F401  (fixture)


def test_cli_flash_crowd_with_one_host_sigtermed(port_artifact, tmp_path):  # noqa: F811
    """Two hosts, a flash crowd of 240 requests at 40 req/s (× 8 in its
    burst, which holds the schedule's second half) through ``serve-fleet``
    (its own process drives the load), SIGTERM to h1 once the router has
    proxied half of them: exit 0, nothing dropped, the per-host ledgers
    sum to the client's, h1 drained what it accepted and exited 0, the
    router saw it leave, and the reference's ``compare`` reads the
    verdict's ``serve_fleet_*`` keys."""
    from bdbnn_tpu.cli import main as jcli
    from bdbnn_tpu.obs.compare import _serve_metrics

    roots = [tmp_path / f"h{i}" for i in range(2)]
    hosts = [spawn_host(port_artifact, r, f"h{i}") for i, r in enumerate(roots)]
    try:
        ports = [wait_host(r, p) for r, p in zip(roots, hosts)]
        out = tmp_path / "verdict.json"
        log = tmp_path / "fleet"
        n = 240
        router = subprocess.Popen(
            [sys.executable, "-m", "bdbnn_tpu_torch.cli", "serve-fleet", port_artifact,
             "--hosts", *(f"127.0.0.1:{p}" for p in ports), "--scenario", "flash_crowd",
             "--rate", "40", "--requests", str(n), "--concurrency", "12",
             "--probe-interval-s", "0.1", "--stats-interval-s", "0.1", "--log-path", str(log),
             "--out", str(out)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        termed = False
        deadline = time.monotonic() + 120
        while router.poll() is None and time.monotonic() < deadline:
            stats = [e for e in _events(log, "fleet") if e.get("phase") == "stats"]
            if stats and sum(h["proxied"] for h in stats[-1]["hosts"].values()) >= n // 2:
                hosts[1].send_signal(signal.SIGTERM)
                termed = True
                break
            time.sleep(0.02)
        r_out, r_err = router.communicate(timeout=180)
        assert router.returncode == 0, r_err[-3000:]
        # h1 got its SIGTERM: wait for it (a second one during its exit
        # would meet the default handler)
        h1_out, h1_err = hosts[1].communicate(timeout=120)
        h1_rc = hosts[1].returncode
    finally:
        reap(hosts)
    assert termed, "the router finished before it had proxied half the requests"
    v = json.loads(r_out)
    assert json.loads(out.read_text()) == v
    flt = v["fleet"]
    assert v["client"]["dropped"] == 0 and flt["dropped"] == 0
    assert v["client"]["responses"] == v["client"]["submitted"] == n
    assert flt["ledger_consistent"] is True
    assert flt["completed_total"] == v["requests_completed"] == v["client"]["by_status"]["200"]
    assert flt["hosts"]["h0"]["completed"] > 0 and flt["hosts"]["h1"]["completed"] > 0
    assert flt["hosts"]["h1"]["state"] in ("draining", "dead")
    assert (flt["hosts"]["h0"]["server_id"], flt["hosts"]["h1"]["server_id"]) == ("h0", "h1")
    assert v["requests_failed"] == 0 and v["drained_clean"] is True
    # h1 answered everything it accepted, drained and exited 0
    assert h1_rc == 0, h1_err[-3000:]
    hv = json.loads(h1_out)
    assert hv["preempted"] is True and hv["drained_clean"] is True
    assert hv["requests_failed"] == 0
    assert hv["requests_completed"] + hv["requests_shed"] == hv["requests_submitted"]
    probes = [(e["state_from"], e["state_to"]) for e in _events(log, "fleet")
              if e.get("phase") == "probe" and e.get("host") == "h1"]
    assert probes and probes[-1][1] in ("draining", "dead")
    phases = [e["phase"] for e in _events(log, "fleet")]
    assert phases[0] == "start" and phases[-1] == "stop" and "ready" in phases
    # the reference's compare reads it
    m = _serve_metrics(v)
    assert m["serve_fleet_dropped"] == 0 and m["serve_fleet_retry_rate"] is not None
    cand = tmp_path / "doctored.json"
    cand.write_text(json.dumps({**v, "fleet": {**flt, "dropped": 3}}))
    assert jcli(["compare", str(out), str(out), "--json"]) == 0
    assert jcli(["compare", str(out), str(cand), "--json"]) == 3

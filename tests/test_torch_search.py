"""The port's recipe-search harness (``bdbnn_tpu_torch/search/``, ``cli
search``) against the JAX package's (``bdbnn_tpu/search/``).

- config: ``SearchConfig`` expands the same trial ids, hashes the same
  sweep identity (``device`` at its default) and refuses what the
  reference refuses, with its messages;
- ledger: entries committed by either package are byte-identical files
  that the other loads; tamper, torn-file and stale-running cases;
- leaderboard: the port's ``build_leaderboard`` over port trial run dirs
  equals the reference's;
- end to end on the CPU (``resnet8_tiny``, ``cli search --device cpu``):
  one uninterrupted sweep shared by the module; a sweep whose first
  worker is SIGTERMed alone (relaunched from its checkpoint) and whose
  harness is SIGTERMed next (exit 75), then ``--resume`` (exit 0): the
  same ranking and every trial's final state bitwise the uninterrupted
  sweep's; ``summarize``, ``watch`` and ``compare`` of the sweep dirs;
  exit 1 when a trial fails, as a trial without ``--device cpu`` does on
  a host with no card;
- ``fit`` holds cuDNN to its deterministic algorithms on the card.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from bdbnn_tpu.configs.config import SearchConfig as RefSearchConfig
from chip_smoke import state_diff
from bdbnn_tpu.search import harness as ref_h
from bdbnn_tpu_torch.search import harness as H
from bdbnn_tpu_torch.search.config import SearchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CPU sweep: two families, 16 steps of -b 16 a trial (time enough to
# land a signal after a worker's first step), one thread a process
SWEEP = ["-a", "resnet8_tiny", "--epochs", "1", "-b", "16", "-p", "2", "--synthetic",
         "--synthetic-train-size", "256", "--synthetic-val-size", "32", "--seed", "0",
         "--families", "ste", "ede", "--device", "cpu"]
SWEEP_KW = dict(arch="resnet8_tiny", epochs=1, batch_size=16, print_freq=2, synthetic=True,
                synthetic_train_size=256, synthetic_val_size=32, seed=0,
                families=("ste", "ede"), lrs=(0.1,))


def _argv(out_dir, *extra):
    return [sys.executable, "-m", "bdbnn_tpu_torch.cli", "search", "--out-dir", str(out_dir),
            *SWEEP, *extra]


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _ledger(sweep_dir):
    try:
        with open(os.path.join(str(sweep_dir), H.LEDGER_NAME)) as f:
            return json.load(f)["trials"]
    except (OSError, ValueError, KeyError):
        return {}


def _past_first_step(sweep_dir, tid):
    """The trial's newest run dir once it holds a ``compile`` event (the
    first step ended) and no ``run_end``."""
    from bdbnn_tpu_torch.obs.events import read_events

    trial_dir = os.path.join(str(sweep_dir), "trials", tid)
    runs = sorted(os.path.dirname(os.path.join(dp, "events.jsonl"))
                  for dp, _, fs in os.walk(trial_dir) if "events.jsonl" in fs)
    if not runs:
        return None
    kinds = {e["kind"] for e in read_events(runs[-1])}
    return runs[-1] if "compile" in kinds and "run_end" not in kinds else None


def _children(pid):
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(name))
    return out


def _final_state(run_dir):
    from bdbnn_tpu_torch.utils import checkpoint as ck

    return torch.load(os.path.join(run_dir, ck.CKPT_NAME, ck.PAYLOAD_NAME),
                      map_location="cpu", weights_only=True)["state"]


# -- config ------------------------------------------------------------------

GRIDS = [
    dict(families=("ste", "ede"), lrs=(0.1, 0.05)),
    dict(families=("proximal:delta1=0.25", "lab", "stochastic"), lrs=(0.2,)),
    dict(trials=("proximal:delta1=0.25@0.1", "approx@0.01", "ste@1e-3")),
    dict(families=("ede",), lrs=(0.1,), dataset="imagenet", arch="resnet18", epochs=2,
         batch_size=256, workers=4, resume=True, out="x.json", events_max_mb=1.0),
]


@pytest.mark.parametrize("grid", GRIDS, ids=range(len(GRIDS)))
def test_trial_ids_and_sweep_hash_are_the_references(grid):
    port = SearchConfig(out_dir="sweep", synthetic=True, **grid).validate()
    ref = RefSearchConfig(out_dir="sweep", synthetic=True, **grid).validate()
    assert port.expand_trials() == ref.expand_trials()
    assert H.sweep_config_hash(port) == ref_h.sweep_config_hash(ref)
    # a device other than the card is part of the sweep's identity
    on_cpu = SearchConfig(out_dir="sweep", synthetic=True, device="cpu", **grid)
    assert H.sweep_config_hash(on_cpu) != H.sweep_config_hash(port)


REFUSALS = [
    dict(out_dir="", synthetic=True),
    dict(out_dir="x", families=("nope",), synthetic=True),
    dict(out_dir="x", families=("proximal:gamma=1",), synthetic=True),
    dict(out_dir="x", families=(), synthetic=True),
    dict(out_dir="x", lrs=(0.1, -1.0), synthetic=True),
    dict(out_dir="x", trials=("ste",), synthetic=True),
    dict(out_dir="x", trials=("ste@fast",), synthetic=True),
    dict(out_dir="x", trials=("ste@0",), synthetic=True),
    dict(out_dir="x", trials=("@0.1",), synthetic=True),
    dict(out_dir="x", dataset="mnist", synthetic=True),
    dict(out_dir="x", epochs=0, synthetic=True),
    dict(out_dir="x", print_freq=0, synthetic=True),
    dict(out_dir="x", workers=0, synthetic=True),
    dict(out_dir="x", events_max_mb=-1.0, synthetic=True),
    dict(out_dir="x"),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=range(len(REFUSALS)))
def test_refusals_are_the_references(kw):
    with pytest.raises(ValueError) as ref_err:
        RefSearchConfig(**kw).validate()
    with pytest.raises(ValueError) as port_err:
        SearchConfig(**kw).validate()
    assert str(port_err.value) == str(ref_err.value)


def test_validation_loads_no_torch():
    """The family specs parse through ``nn/families.py``: a harness process
    validates a grid, and imports the whole harness, without torch."""
    code = ("import sys\n"
            "from bdbnn_tpu_torch.search import SearchConfig, run_search\n"
            "SearchConfig(out_dir='x', families=('proximal:delta1=0.25', 'ede'),\n"
            "             synthetic=True).validate()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_search_digest_is_one_copy():
    from bdbnn_tpu_torch.obs import events

    assert H.search_digest is events.search_digest


# -- ledger ------------------------------------------------------------------

TRIALS = (("t000_ste_lr0.1", "ste", 0.1), ("t001_ede_lr0.1", "ede", 0.1))


def _commit_both(tmp_path, marks):
    out = {}
    for name, cls in (("port", H.TrialLedger), ("ref", ref_h.TrialLedger)):
        d = tmp_path / name
        d.mkdir()
        ledger = cls(str(d))
        ledger.init_trials(TRIALS, "hash1")
        for tid, status, fields in marks:
            ledger.mark(tid, status, **fields)
        out[name] = d
    return out


MARKS = [
    [],
    [("t000_ste_lr0.1", "running", {"attempts": 1})],
    [("t000_ste_lr0.1", "done", {"attempts": 1, "run_dirs": ["/r/a"],
                                 "metrics": {"best_top1": 12.5, "final_top1": float("nan"),
                                             "wall_s": 3.25, "alerts_critical": 0},
                                 "curve": [[12.5, 1.5]]}),
     ("t001_ede_lr0.1", "failed", {"attempts": 2, "rc": 1})],
]


@pytest.mark.parametrize("marks", MARKS, ids=range(len(MARKS)))
def test_ledgers_are_byte_identical_and_cross_load(tmp_path, marks):
    dirs = _commit_both(tmp_path, marks)
    for name in (H.LEDGER_NAME, H.LEDGER_NAME + ".old"):
        p, r = dirs["port"] / name, dirs["ref"] / name
        assert p.exists() == r.exists()
        if p.exists():
            assert p.read_bytes() == r.read_bytes()
    port_reads_ref = H.TrialLedger(str(dirs["ref"]))
    ref_reads_port = ref_h.TrialLedger(str(dirs["port"]))
    assert port_reads_ref.load() and ref_reads_port.load()
    assert port_reads_ref.trials == ref_reads_port.trials
    assert port_reads_ref.config_hash == ref_reads_port.config_hash == "hash1"


def test_tampered_ledger_falls_back_to_old_in_both(tmp_path):
    dirs = _commit_both(tmp_path, [("t000_ste_lr0.1", "done", {"metrics": {"best_top1": 10.0}})])
    for d in dirs.values():
        path = d / H.LEDGER_NAME
        data = json.loads(path.read_text())
        data["trials"]["t000_ste_lr0.1"]["metrics"]["best_top1"] = 99.9
        path.write_text(json.dumps(data))
    for cls, d in ((H.TrialLedger, dirs["port"]), (ref_h.TrialLedger, dirs["port"]),
                   (H.TrialLedger, dirs["ref"])):
        fresh = cls(str(d))
        assert fresh.load()
        assert fresh.loaded_from == str(d / H.LEDGER_NAME) + ".old"
        assert fresh.status("t000_ste_lr0.1") == "pending"


def test_swapped_entries_fail_verification(tmp_path):
    dirs = _commit_both(tmp_path, [("t000_ste_lr0.1", "done", {"metrics": {"best_top1": 99.0}})])
    path = dirs["port"] / H.LEDGER_NAME
    data = json.loads(path.read_text())
    t = data["trials"]
    t["t000_ste_lr0.1"], t["t001_ede_lr0.1"] = t["t001_ede_lr0.1"], t["t000_ste_lr0.1"]
    path.write_text(json.dumps(data))
    fresh = H.TrialLedger(str(dirs["port"]))
    assert fresh.load() and fresh.loaded_from == str(path) + ".old"


def test_both_torn_refuses(tmp_path):
    dirs = _commit_both(tmp_path, [("t000_ste_lr0.1", "done", {})])
    d = dirs["port"]
    (d / H.LEDGER_NAME).write_text("{torn")
    (d / (H.LEDGER_NAME + ".old")).write_text("also torn")
    with pytest.raises(RuntimeError, match="integrity"):
        H.TrialLedger(str(d)).load()


def test_stale_running_reconciles_as_the_reference(tmp_path):
    run_dir = tmp_path / "rd"
    (run_dir / "checkpoint").mkdir(parents=True)
    marks = [("t000_ste_lr0.1", "running", {"attempts": 1, "run_dirs": []}),
             ("t001_ede_lr0.1", "running", {"attempts": 1, "run_dirs": [str(run_dir)]})]
    dirs = _commit_both(tmp_path, marks)
    for cls, d in ((H.TrialLedger, dirs["port"]), (ref_h.TrialLedger, dirs["ref"])):
        fresh = cls(str(d))
        fresh.load()
        assert fresh.reconcile_stale() == ["t000_ste_lr0.1", "t001_ede_lr0.1"]
        assert fresh.status("t000_ste_lr0.1") == "pending"
        assert fresh.status("t001_ede_lr0.1") == "preempted"
    assert ((dirs["port"] / H.LEDGER_NAME).read_bytes()
            == (dirs["ref"] / H.LEDGER_NAME).read_bytes())


# -- end to end on the CPU ---------------------------------------------------


@pytest.fixture(scope="module")
def clean_sweep(tmp_path_factory):
    """ONE uninterrupted sweep, two trials on two workers."""
    out_dir = tmp_path_factory.mktemp("clean") / "sweep"
    r = subprocess.run(_argv(out_dir, "--workers", "2"), cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(out_dir)


@pytest.fixture(scope="module")
def preempted_sweep(tmp_path_factory):
    """The same sweep on one worker, its harness SIGTERMed once t000 is
    done and t001 is past its first step (exit 75)."""
    out_dir = tmp_path_factory.mktemp("preempted") / "sweep"
    proc = subprocess.Popen(_argv(out_dir), cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        _wait_for(lambda: _ledger(out_dir).get("t000_ste_lr0.1", {}).get("status") == "done",
                  120, "t000 done")
        first = _wait_for(lambda: _past_first_step(out_dir, "t001_ede_lr0.1"), 120,
                          "t001's first step")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"dir": str(out_dir), "rc": proc.returncode, "out": out, "first": first,
            "ledger": json.load(open(os.path.join(str(out_dir), H.LEDGER_NAME)))}


def test_clean_sweep_leaderboard(clean_sweep):
    lb = json.load(open(os.path.join(clean_sweep, H.LEADERBOARD_NAME)),
                   parse_constant=pytest.fail)
    assert lb["search_verdict"] == 1
    assert lb["trials_total"] == 2 and lb["completed"] == 2 and lb["failed"] == 0
    assert {r["family"] for r in lb["ranking"]} == {"ste", "ede"}
    assert lb["winner"]["trial"] == lb["ranking"][0]["trial"]
    assert all(t["attempts"] == 1 and not t["resumed"] for t in lb["trials"].values())
    assert os.path.exists(os.path.join(lb["winner"]["run_dir"], "manifest.json"))
    manifest = json.load(open(os.path.join(clean_sweep, "manifest.json")))
    assert manifest["config"]["search"]["device"] == "cpu"


def test_sigterm_on_the_harness_exits_75(preempted_sweep):
    assert preempted_sweep["rc"] == 75, preempted_sweep["out"][-3000:]
    trials = preempted_sweep["ledger"]["trials"]
    t0, t1 = trials["t000_ste_lr0.1"], trials["t001_ede_lr0.1"]
    assert t0["status"] == "done" and t0["attempts"] == 1
    # the forwarded signal: the worker checkpointed mid-epoch and exited 75
    assert t1["status"] == "preempted" and t1["attempts"] == 1
    assert os.path.isdir(os.path.join(t1["run_dirs"][-1], "checkpoint"))
    assert not os.path.exists(os.path.join(preempted_sweep["dir"], H.LEADERBOARD_NAME))
    from bdbnn_tpu_torch.obs.events import read_events

    phases = [(e["kind"], e["phase"], e.get("trial")) for e in read_events(preempted_sweep["dir"])]
    assert ("trial", "preempted", "t001_ede_lr0.1") in phases
    assert ("search", "preempted", None) in phases


def test_resume_with_a_worker_preempted_alone_reaches_the_same_leaderboard_and_states(
        clean_sweep, preempted_sweep):
    """``--resume``: t001 relaunched from its checkpoint; that worker
    SIGTERMed alone past its first step exits 75 and the harness relaunches
    it again; the sweep exits 0 with the uninterrupted sweep's ranking and
    every trial's final state bitwise its."""
    out_dir = preempted_sweep["dir"]
    proc = subprocess.Popen(_argv(out_dir, "--resume"), cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait_for(lambda: _past_first_step(out_dir, "t001_ede_lr0.1")
                  not in (None, preempted_sweep["first"]), 120, "the resumed t001's first step")
        (worker,) = _children(proc.pid)
        os.kill(worker, signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    lb = json.load(open(os.path.join(out_dir, H.LEADERBOARD_NAME)))
    clean = json.load(open(os.path.join(clean_sweep, H.LEADERBOARD_NAME)))
    assert lb["ranking"] == clean["ranking"]
    assert lb["completed"] == 2 and lb["failed"] == 0
    t1 = lb["trials"]["t001_ede_lr0.1"]
    assert t1["resumed"] and t1["attempts"] == 3 and t1["wall_s"] is None
    after = json.load(open(os.path.join(out_dir, H.LEDGER_NAME)))["trials"]
    # the done trial is carried verbatim
    assert after["t000_ste_lr0.1"] == preempted_sweep["ledger"]["trials"]["t000_ste_lr0.1"]
    assert len(after["t001_ede_lr0.1"]["run_dirs"]) == 3
    from bdbnn_tpu_torch.obs.events import read_events

    phases = [(e["kind"], e["phase"], e.get("trial")) for e in read_events(out_dir)]
    assert ("search", "resume", None) in phases
    assert phases.count(("trial", "resumed", "t001_ede_lr0.1")) == 2
    assert phases.count(("trial", "preempted", "t001_ede_lr0.1")) == 2
    ref_trials = json.load(open(os.path.join(clean_sweep, H.LEDGER_NAME)))["trials"]
    for tid, entry in after.items():
        got = _final_state(entry["run_dirs"][-1])
        want = _final_state(ref_trials[tid]["run_dirs"][-1])
        assert state_diff(got, want) == [], tid


def test_sweep_dirs_through_summarize_watch_and_compare(clean_sweep):
    from bdbnn_tpu_torch.obs.compare import compare_runs
    from bdbnn_tpu_torch.obs.events import read_events
    from bdbnn_tpu_torch.obs.summarize import summarize_run
    from bdbnn_tpu_torch.obs.watch import render_status

    report, summary = summarize_run(clean_sweep)
    assert summary["search"]["completed"] == 2
    assert "recipe search: 2 trial(s)" in report and "winner:" in report
    status = render_status(read_events(clean_sweep))
    assert "VERDICT: 2/2 completed" in status
    result = compare_runs([clean_sweep, os.path.join(clean_sweep, H.LEADERBOARD_NAME)])
    assert result["verdict"] == "pass"
    assert "search_best_top1" in {m["metric"] for m in result["comparisons"][0]["metrics"]}
    for cmd in (["summarize", clean_sweep], ["watch", clean_sweep, "--once"],
                ["compare", clean_sweep, clean_sweep]):
        r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.cli", *cmd], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, (cmd, r.stderr[-2000:])


def test_leaderboard_is_the_references_over_port_trials(clean_sweep):
    port = H.TrialLedger(clean_sweep)
    assert port.load()
    for tid, entry in port.trials.items():
        got = H._extract_trial_metrics(entry["run_dirs"][-1])
        assert got == ref_h._extract_trial_metrics(entry["run_dirs"][-1]), tid
        assert got[0] == entry["metrics"]
    ref = ref_h.TrialLedger(clean_sweep)
    assert ref.load()
    kw = {k: v for k, v in SWEEP_KW.items()}
    lb_port = H.build_leaderboard(SearchConfig(out_dir=clean_sweep, device="cpu", **kw), port)
    lb_ref = ref_h.build_leaderboard(RefSearchConfig(out_dir=clean_sweep, **kw), ref)
    assert lb_port == lb_ref
    assert lb_port == json.load(open(os.path.join(clean_sweep, H.LEADERBOARD_NAME)))


def test_resume_refusals(clean_sweep):
    with pytest.raises(RuntimeError, match="DIFFERENT search config"):
        H.run_search(SearchConfig(out_dir=clean_sweep, resume=True, device="cpu",
                                  **{**SWEEP_KW, "lrs": (0.2,)}))
    with pytest.raises(RuntimeError, match="--resume"):
        H.run_search(SearchConfig(out_dir=clean_sweep, device="cpu", **SWEEP_KW))


@pytest.mark.parametrize("extra", [["-a", "not_an_arch", "--device", "cpu"], []],
                         ids=["failing trial", "no card"])
def test_a_failed_trial_exits_1(tmp_path, extra):
    """A trial whose CLI fails is ``failed`` and the sweep exits 1; a trial
    without ``--device`` on a host with no card is such a trial (no
    fallback to the CPU)."""
    argv = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "search", "--out-dir",
            str(tmp_path / "s"), "--synthetic", "--trial", "ste@0.1", "-a", "resnet8_tiny",
            "--synthetic-train-size", "16", "--synthetic-val-size", "16", "-b", "8", *extra]
    r = subprocess.run(argv, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    lb = json.loads(r.stdout)
    assert lb["failed"] == 1 and lb["completed"] == 0
    log = open(tmp_path / "s" / "trials" / "t000_ste_lr0.1" / "worker.1.log").read()
    assert ("no CUDA device" in log) if not extra else ("not_an_arch" in log)


def test_self_preempted_worker_is_relaunched_stubbed(tmp_path, monkeypatch):
    """The reference's stubbed twin: attempt 1 of t000 exits 75 after
    committing a checkpoint, attempt 2 carries --resume and completes."""
    attempts = {}

    def fake_popen(argv, stdout=None, stderr=None, env=None):
        log_path = argv[argv.index("--log_path") + 1]
        tid = os.path.basename(log_path)
        n = attempts[tid] = attempts.get(tid, 0) + 1
        run_dir = os.path.join(log_path, f"run{n}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "events.jsonl"), "w") as f:
            f.write(json.dumps({"t": 1000.0, "kind": "run_start"}) + "\n")
            if tid.startswith("t000") and n == 1:
                assert "--resume" not in argv
                os.makedirs(os.path.join(run_dir, "checkpoint"), exist_ok=True)
                rc = 75
            else:
                if tid.startswith("t000"):
                    assert "--resume" in argv
                f.write(json.dumps({"t": 1001.0, "kind": "eval", "epoch": 0,
                                    "acc1": 50.0}) + "\n")
                f.write(json.dumps({"t": 1002.0, "kind": "run_end", "best_acc1": 50.0,
                                    "wall_s": 2.0}) + "\n")
                rc = 0
        assert argv[argv.index("--device") + 1] == "cpu"

        class _P:
            returncode = rc

            def poll(self):
                return rc

            def wait(self, timeout=None):
                return rc

            def send_signal(self, s):
                pass

            def kill(self):
                pass

        return _P()

    monkeypatch.setattr(H.subprocess, "Popen", fake_popen)
    result = H.run_search(SearchConfig(out_dir=str(tmp_path / "sweep"), device="cpu",
                                       **SWEEP_KW))
    lb = result["leaderboard"]
    assert lb["completed"] == 2 and lb["failed"] == 0
    assert attempts == {"t000_ste_lr0.1": 2, "t001_ede_lr0.1": 1}
    assert lb["trials"]["t000_ste_lr0.1"]["resumed"] is True
    assert lb["trials"]["t001_ede_lr0.1"]["wall_s"] == 2.0


# -- fit on the card ---------------------------------------------------------


def test_fit_holds_cudnn_deterministic_on_the_card(monkeypatch, tmp_path):
    """On the cuda branch ``fit`` sets ``cudnn.deterministic`` and clears
    ``cudnn.benchmark`` while it runs, and restores both when it exits (a
    CPU run cannot show the drift itself: the device probe is stubbed and
    the run stops at its log dir)."""
    from bdbnn_tpu_torch.train import loop
    from bdbnn_tpu_torch.train.config import RunConfig

    seen = {}

    class Stop(Exception):
        pass

    def make_log_dir(*a, **kw):
        seen["flags"] = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        raise Stop

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    monkeypatch.setattr(loop, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(loop, "make_log_dir", make_log_dir)
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        cfg = RunConfig(dataset="cifar10", arch="resnet8_tiny", synthetic=True,
                        log_path=str(tmp_path), device="cuda")
        with pytest.raises(Stop):
            loop.fit(cfg)
        assert seen["flags"] == (True, False)
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False,
                                                                                         True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[2:4]
        torch.set_float32_matmul_precision(saved[4])


def test_two_workers_first_kernel_builds_do_not_race(tmp_path, monkeypatch):
    """Two trial workers that first load the kernels at once each run
    ``nvcc`` into a file of their own (named by pid) and publish it by an
    atomic rename to the digest-named library: in either order of their
    finishes the library is whole, and a later load builds nothing."""
    from bdbnn_tpu_torch.nn.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    outputs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            outputs.append(self.out)
            self.returncode = 0

        def communicate(self):
            with open(self.out, "wb") as f:
                f.write(b"library bytes")
            return "", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    pids = iter([1001, 1002])
    monkeypatch.setattr(_build.os, "getpid", lambda: next(pids))
    a = _build._start("kurtosis")
    b = _build._start("kurtosis")
    assert outputs[0] != outputs[1] and a[2] == b[2] == _build.library_path("kurtosis")
    _build._finish("kurtosis", b, 0.0)
    _build._finish("kurtosis", a, 0.0)
    with open(_build.library_path("kurtosis"), "rb") as f:
        assert f.read() == b"library bytes"
    assert os.listdir(tmp_path) == [os.path.basename(_build.library_path("kurtosis"))]
    assert _build._start("kurtosis") is None

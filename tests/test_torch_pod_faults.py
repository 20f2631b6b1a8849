"""The port's CLI as a two-rank data-parallel job on the CPU — the
counterpart of ``tests/test_pod_faults.py``. Each rank is started as
torchrun starts it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) running ``python -m bdbnn_tpu_torch.cli
... --device cpu --distributed-init`` over gloo:

- a job writes one run dir: rank 0's ``log.txt``, ``events.jsonl``,
  ``scalars.jsonl`` and ``manifest.json``, rank 1's ``log.p1.txt``,
  ``events.p1.jsonl`` and ``scalars.p1.jsonl`` beside them; the ``eval``
  event's ``count`` is the whole val split on both ranks; the health
  warning is rank 0's alone;
- SIGTERM to rank 1 alone: both ranks save the same step and exit 75, the
  ``preempt`` events ``coordinated``; the one checkpoint's ``resume.json``
  records ``{"processes": 2, "devices": 2, "mesh": {"data": 2, "model":
  1}}``;
- that checkpoint resumes on one process: the ``restore`` event has
  ``resharded: true``, its schedule fields (epoch, step, lr step, EDE t/k,
  kurtosis gate, family schedule) are bitwise the ``checkpoint`` event's,
  the restored model, optimizer state and step are bitwise the saved ones,
  and the run goes on to its end.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke
from bdbnn_tpu_torch.obs.events import read_events, read_jsonl
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED_KEYS = ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k", "kurt_gate", "sched",
              "binarizer")
BASE = dict(dataset="cifar10", arch="resnet8_tiny", synthetic=True, batch_size=8, epochs=1,
            seed=1, w_kurtosis=True, ede=True, print_freq=1, device="cpu")
TWO = {"processes": 2, "devices": 2, "mesh": {"data": 2, "model": 1}}
ONE = {"processes": 1, "devices": 1, "mesh": {"data": 1, "model": 1}}
# the preempted job's steps: far more than run before the signal lands
STEPS = 160


def _argv(root, train_size, val_size):
    kw = BASE
    return ["--dataset", kw["dataset"], "-a", kw["arch"], "--synthetic", "-b",
            str(kw["batch_size"]), "--epochs", str(kw["epochs"]), "--seed", str(kw["seed"]),
            "--synthetic-train-size", str(train_size), "--synthetic-val-size", str(val_size),
            "--w-kurtosis", "--ede", "-p", str(kw["print_freq"]), "--device", "cpu",
            "--log_path", str(root), "--distributed-init"]


def _launch(root, train_size, val_size):
    port = chip_smoke.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bdbnn_tpu_torch.cli", *_argv(root, train_size, val_size)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


def _run_dir(root):
    return chip_smoke.run_dir_of(str(root))


def test_a_job_writes_one_run_dir_and_evaluates_the_whole_split(tmp_path):
    outs = _wait(_launch(tmp_path, train_size=16, val_size=9))
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert set(json.loads(out.strip().splitlines()[-1])) == {"best_acc1", "best_epoch"}
    run_dir = _run_dir(tmp_path)
    names = set(os.listdir(run_dir))
    assert {"log.txt", "events.jsonl", "scalars.jsonl", "manifest.json", "log.p1.txt",
            "events.p1.jsonl", "scalars.p1.jsonl", "checkpoint"} <= names
    assert not {"manifest.p1.json", "log.p0.txt"} & names
    evals = [read_events(run_dir, "eval"),
             [e for e in read_jsonl(os.path.join(run_dir, "events.p1.jsonl")) if e["kind"] == "eval"]]
    assert [len(e) for e in evals] == [1, 1]
    assert evals[0][0]["count"] == evals[1][0]["count"] == 9
    assert evals[0][0]["acc1"] == evals[1][0]["acc1"]
    # the logged train metrics are the job's: the same on both ranks
    intervals = [[e["loss"] for e in evs if e["kind"] == "train_interval"]
                 for evs in (read_events(run_dir), read_jsonl(os.path.join(run_dir,
                                                                            "events.p1.jsonl")))]
    assert intervals[0] == intervals[1] and len(intervals[0]) == 2
    # each rank's monitor ran and wrote its run-end summary into its own
    # timeline, over the same drains
    healths = [[e for e in evs if e["kind"] == "health"]
               for evs in (read_events(run_dir), read_jsonl(os.path.join(run_dir,
                                                                          "events.p1.jsonl")))]
    assert [len(h) for h in healths] == [1, 1]
    assert healths[0][0]["intervals"] == healths[1][0]["intervals"] == 2
    side = ck.read_resume_state(os.path.join(run_dir, ck.CKPT_NAME))
    assert side["topology"] == TWO


def test_sigterm_to_one_rank_saves_one_aligned_checkpoint_and_resumes_on_one_process(tmp_path):
    root = tmp_path / "job"
    procs = _launch(root, train_size=8 * STEPS, val_size=8)
    try:
        # SIGTERM reaches rank 1 alone, once it has trained a step
        deadline = time.monotonic() + 90
        p1_events = None
        while time.monotonic() < deadline:
            dirs = [d for d, _, fs in os.walk(root) if "events.p1.jsonl" in fs]
            if dirs:
                p1_events = os.path.join(dirs[0], "events.p1.jsonl")
                if any(e["kind"] == "train_interval" for e in read_jsonl(p1_events)):
                    break
            assert all(p.poll() is None for p in procs), "a rank ended before its first step"
            time.sleep(0.05)
        else:
            pytest.fail("rank 1 trained no step within 90 s")
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = _wait(procs)
    for rc, _, err in outs:
        assert rc == 75, err[-3000:]
    run_dir = _run_dir(root)
    preempts = [read_events(run_dir, "preempt"),
                [e for e in read_jsonl(p1_events) if e["kind"] == "preempt"]]
    assert [len(p) for p in preempts] == [1, 1]
    (p0,), (p1,) = preempts
    assert p0["coordinated"] is True and p1["coordinated"] is True
    assert p0["signum"] == p1["signum"] == int(signal.SIGTERM)
    assert p0["step_in_epoch"] == p1["step_in_epoch"] > 0 and p0["epoch"] == p1["epoch"] == 0
    # one aligned checkpoint, written once, of that step
    (ck_ev,) = read_events(run_dir, "checkpoint")
    assert ck_ev["reason"] == "preempt" and ck_ev["coordinated"] is True
    assert ck_ev["step_in_epoch"] == p0["step_in_epoch"]
    ckpt = os.path.join(run_dir, ck.CKPT_NAME)
    side = ck.read_resume_state(ckpt)
    assert side["topology"] == TWO and side["step_in_epoch"] == p0["step_in_epoch"]
    assert not os.path.exists(ckpt + ".old") and ck.verify_integrity(ckpt) == "ok"
    saved = torch.load(os.path.join(ckpt, ck.PAYLOAD_NAME), map_location="cpu",
                       weights_only=True)["state"]

    # the elastic resume: one process, the job's global batch
    restored = {}
    real_load = tloop.load_checkpoint

    def load(path, state, **kw):
        res = real_load(path, state, **kw)
        restored.update(ck.state_payload(state))
        return res

    tloop.load_checkpoint = load
    try:
        cfg = RunConfig(**BASE, synthetic_train_size=8 * STEPS, synthetic_val_size=8,
                        log_path=str(tmp_path / "resumed"), resume=run_dir)
        res = tloop.fit(cfg)
    finally:
        tloop.load_checkpoint = real_load
    assert set(res) == {"best_acc1", "best_epoch"}
    assert not chip_smoke.state_diff(saved, restored)
    resumed = _run_dir(tmp_path / "resumed")
    (restore,) = read_events(resumed, "restore")
    assert restore["resharded"] is True
    assert restore["topology_from"] == TWO and restore["topology_to"] == ONE
    assert {k: restore[k] for k in SCHED_KEYS} == {k: ck_ev[k] for k in SCHED_KEYS}
    steps = [e for e in read_events(resumed, "train_interval")]
    assert steps[0]["step"] == p0["step_in_epoch"] and steps[-1]["step"] == STEPS - 1

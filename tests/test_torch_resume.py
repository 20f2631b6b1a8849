"""Preemption and resume of the port's ``fit`` on the CPU, at
``resnet8_tiny`` -b 8, 2 epochs × 4 steps, a checkpoint every 2 steps:

- SIGTERM (sent from a thread, right after the ``checkpoint`` event of
  epoch 1 step 2) makes ``cli.main`` return 75, with ``preempt`` and
  ``checkpoint`` events, and the committed state is bitwise the state
  the save was given;
- resuming it, and resuming a run SIGKILLed in a subprocess after its
  first mid-epoch checkpoint, is bitwise the uninterrupted run: each
  later loss, the final model, optimizer state and step;
- the ``restore`` event's schedule fields are bitwise those of the
  ``checkpoint`` event it resumes from, under ste, ``--ede`` and
  ``--binarizer stochastic``;
- a port run dir works as ``--resume_teacher``: the teacher is bitwise
  the float run's ``model_best``;
- on an image folder (``resnet18_step2`` at 224², -b 2, 1 epoch × 4
  steps, worker processes at ``-j 1``), a SIGTERM mid-epoch exits 75 with
  no input worker left alive, and the resumed run is bitwise the
  uninterrupted one: the folder pipeline's ``epoch(start_step)`` holds.
"""

import json
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import chip_smoke
from bdbnn_tpu_torch import cli
from bdbnn_tpu_torch.obs import events as tevents
from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.resilience import PREEMPT_EXIT_CODE
from bdbnn_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(dataset="cifar10", arch="resnet8_tiny", synthetic=True, batch_size=8, epochs=2,
            synthetic_train_size=32, synthetic_val_size=8, seed=1, save_every_steps=2,
            print_freq=2, w_kurtosis=True, device="cpu")
SCHED_KEYS = ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k", "kurt_gate", "sched",
              "binarizer")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: its models are tiny, and the
    suite's workers share the machine's cores (several threads a worker
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(root, **over):
    kw = {**BASE, **over}
    out = ["--dataset", kw["dataset"], "-a", kw["arch"], "--synthetic", "-b", str(kw["batch_size"]),
           "--epochs", str(kw["epochs"]), "--synthetic-train-size", str(kw["synthetic_train_size"]),
           "--synthetic-val-size", str(kw["synthetic_val_size"]), "--seed", str(kw["seed"]),
           "--save-every-steps", str(kw["save_every_steps"]), "-p", str(kw["print_freq"]),
           "--w-kurtosis", "--device", "cpu", "--log_path", str(root)]
    return out


def run_dir_of(root):
    (d,) = {os.path.dirname(os.path.join(r, f)) for r, _, fs in os.walk(root) for f in fs
            if f == tevents.EVENTS_NAME}
    return d


def _fit(root, base=BASE, **over):
    """fit with ``base`` + ``over`` under ``root``: (result, run dir,
    losses by (epoch, step))."""
    losses = {}
    res = tloop.fit(RunConfig(**{**base, "log_path": str(root), **over}),
                    on_step=lambda e, i, m: losses.__setitem__((e, i), m["loss"].clone()))
    return res, run_dir_of(root), losses


def _final(run_dir):
    """The payload of a run's final committed checkpoint."""
    return torch.load(os.path.join(run_dir, ck.CKPT_NAME, ck.PAYLOAD_NAME), weights_only=True)


def _assert_state_bitwise(a, b):
    sa, sb = a["state"], b["state"]
    assert sa["step"] == sb["step"] and sa["param_names"] == sb["param_names"]
    assert all(torch.equal(sa["model"][k], sb["model"][k]) for k in sa["model"])
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert oa.keys() == ob.keys()
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted run every interrupted one is held to."""
    res, run_dir, losses = _fit(tmp_path_factory.mktemp("baseline"))
    return {"res": res, "run_dir": run_dir, "losses": losses, "final": _final(run_dir)}


def _sigtermed(root, argv, at):
    """``cli.main(argv)`` SIGTERMed by a thread right after the checkpoint
    event of (epoch, step_in_epoch) ``at``; every state a save was given,
    snapshotted, and the worker processes it left alive."""
    mp = pytest.MonkeyPatch()
    real_emit, real_save = tevents.EventWriter.emit, tloop.save_checkpoint
    given = []

    def emit(self, kind, **fields):
        rec = real_emit(self, kind, **fields)
        if kind == "checkpoint" and (fields["epoch"], fields["step_in_epoch"]) == at:
            t = threading.Thread(target=os.kill, args=(os.getpid(), signal.SIGTERM))
            t.start()
            t.join()
        return rec

    def save(path, state, **kw):
        given.append((kw, ck.state_payload(state)))
        return real_save(path, state, **kw)

    mp.setattr(tevents.EventWriter, "emit", emit)
    mp.setattr(tloop, "save_checkpoint", save)
    before = multiprocessing.active_children()
    try:
        rc = cli.main(argv)
    finally:
        mp.undo()
    left = [c for c in multiprocessing.active_children() if c not in before]
    return {"rc": rc, "run_dir": run_dir_of(root), "given": given, "left": left}


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    """``cli.main`` SIGTERMed right after the checkpoint event of epoch 1
    step 2."""
    root = tmp_path_factory.mktemp("sigterm")
    return _sigtermed(root, _args(root), (1, 2))


def test_sigterm_exits_75_with_preempt_and_checkpoint_events(preempted):
    assert preempted["rc"] == PREEMPT_EXIT_CODE == 75
    run_dir = preempted["run_dir"]
    (p,) = read_events(run_dir, "preempt")
    assert p["signum"] == signal.SIGTERM and (p["epoch"], p["step_in_epoch"]) == (1, 3)
    last = read_events(run_dir, "checkpoint")[-1]
    assert (last["reason"], last["epoch"], last["step_in_epoch"], last["lr_step"]) \
        == ("preempt", 1, 3, 7)
    assert not read_events(run_dir, "run_end")
    # the committed state is bitwise what the preemption save was given
    kw, given = preempted["given"][-1]
    assert kw["step_in_epoch"] == 3
    _assert_state_bitwise(_final(run_dir), {"state": given})


def _assert_resumed_like_baseline(baseline, run_dir, losses, from_key):
    want = {k: v for k, v in baseline["losses"].items() if k >= from_key}
    assert sorted(losses) == sorted(want)
    for k in want:
        assert torch.equal(losses[k], want[k]), k
    _assert_state_bitwise(_final(run_dir), baseline["final"])


def test_resume_after_sigterm_is_bitwise_the_uninterrupted_run(preempted, baseline, tmp_path):
    res, run_dir, losses = _fit(tmp_path, resume=preempted["run_dir"])
    (restore,) = read_events(run_dir, "restore")
    saved = read_events(preempted["run_dir"], "checkpoint")[-1]
    assert {k: restore[k] for k in SCHED_KEYS} == {k: saved[k] for k in SCHED_KEYS}
    assert restore["integrity"] == "ok" and restore["fallback"] is False
    _assert_resumed_like_baseline(baseline, run_dir, losses, (1, 3))
    assert res == baseline["res"]
    with open(os.path.join(run_dir, "manifest.json")) as f:
        man = json.load(f)
    assert man["resumed_from"] == os.path.abspath(preempted["run_dir"])
    assert man["restart_lineage"] == [os.path.abspath(preempted["run_dir"])]


# the child stalls right after its first mid-epoch checkpoint event, so
# the SIGKILL lands at a known point whatever the machine's speed
CHILD = """
import sys, time
from bdbnn_tpu_torch import cli
from bdbnn_tpu_torch.obs import events
emit = events.EventWriter.emit
def stalling(self, kind, **fields):
    rec = emit(self, kind, **fields)
    if kind == "checkpoint" and fields["step_in_epoch"] > 0:
        time.sleep(300)
    return rec
events.EventWriter.emit = stalling
sys.exit(cli.main(sys.argv[1:]))
"""


def test_resume_after_sigkill_is_bitwise_the_uninterrupted_run(baseline, tmp_path):
    root = tmp_path / "victim"
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    err_path = tmp_path / "stderr.txt"
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", CHILD, *_args(root)], cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline, hit = time.time() + 120, None
        while hit is None and time.time() < deadline and proc.poll() is None:
            time.sleep(0.05)
            if os.path.isdir(root):
                evs = [e for r, _, fs in os.walk(root) for f in fs if f == tevents.EVENTS_NAME
                       for e in read_events(r, "checkpoint")]
                hit = next((e for e in evs if e["step_in_epoch"] > 0), None)
        assert hit is not None, err_path.read_text()[-3000:]
        proc.kill()
        assert proc.wait(timeout=60) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    victim = run_dir_of(root)
    assert (hit["epoch"], hit["step_in_epoch"]) == (0, 2) and not read_events(victim, "run_end")
    res, run_dir, losses = _fit(tmp_path / "resumed", resume=victim)
    (restore,) = read_events(run_dir, "restore")
    assert {k: restore[k] for k in SCHED_KEYS} == {k: hit[k] for k in SCHED_KEYS}
    _assert_resumed_like_baseline(baseline, run_dir, losses, (0, 2))
    assert res == baseline["res"]


@pytest.mark.parametrize("family", [{}, {"ede": True}, {"binarizer": "stochastic"}],
                         ids=["ste", "ede", "stochastic"])
def test_restore_schedule_fields_are_bitwise_the_checkpoints(family, tmp_path):
    """Resume from the run's ``checkpoint.old`` (epoch 1 step 2, the
    interval save before the final one): the restore event repeats that
    checkpoint event's schedule fields, and the two resumed steps end
    where the uninterrupted run ended."""
    _, run_dir, losses = _fit(tmp_path / "a", **family)
    old = os.path.join(run_dir, ck.CKPT_NAME + ".old")
    assert ck.read_resume_state(old)["step_in_epoch"] == 2
    saved = next(e for e in read_events(run_dir, "checkpoint")
                 if (e["epoch"], e["step_in_epoch"]) == (1, 2))
    _, run_b, losses_b = _fit(tmp_path / "b", resume=old, **family)
    (restore,) = read_events(run_b, "restore")
    assert {k: restore[k] for k in SCHED_KEYS} == {k: saved[k] for k in SCHED_KEYS}
    if family.get("ede"):
        assert restore["ede_t"] != 1.0 and restore["binarizer"] == "ede"
    assert sorted(losses_b) == [(1, 2), (1, 3)]
    assert all(torch.equal(losses_b[k], losses[k]) for k in losses_b)
    _assert_state_bitwise(_final(run_b), _final(run_dir))


def test_a_port_run_dir_is_a_teacher(tmp_path, monkeypatch):
    float_kw = dict(arch="resnet20_float", epochs=1, synthetic_train_size=16, w_kurtosis=False,
                    save_every_steps=0, synthetic_val_size=32)
    _, float_dir, _ = _fit(tmp_path / "float", **float_kw)
    assert os.path.isdir(os.path.join(float_dir, ck.BEST_NAME))  # its eval top-1 beat 0
    built = []
    real = tloop.build_teacher
    monkeypatch.setattr(tloop, "build_teacher",
                        lambda cfg, device: (built.append(real(cfg, device)), built[-1])[1])
    _, _, losses = _fit(tmp_path / "ts", arch="resnet20", epochs=1, synthetic_train_size=16,
                        imagenet_setting_step_2_ts=True, arch_teacher="resnet20_float",
                        resume_teacher=float_dir)
    assert len(losses) == 2 and all(torch.isfinite(v) for v in losses.values())
    (teacher,) = built
    want = ck.load_variables(float_dir)
    best = torch.load(os.path.join(float_dir, ck.BEST_NAME, ck.PAYLOAD_NAME), weights_only=True)
    assert want.keys() == best["state"]["model"].keys()
    got = teacher.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(want[k], best["state"]["model"][k]) for k in want)


# -- on an image folder ------------------------------------------------------------

FOLDER = dict(dataset="imagenet", arch="resnet18_step2", batch_size=2, epochs=1, seed=1,
              save_every_steps=2, print_freq=2, w_kurtosis=True, input_backend="mp", workers=1,
              device="cpu")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """9 train JPEGs (4 steps at -b 2, one file truncated) and 2 val."""
    root = str(tmp_path_factory.mktemp("folder"))
    chip_smoke.write_image_folder(root, classes=2, train=9, val=2, scale=0.16, threads=2)
    return root


@pytest.fixture(scope="module")
def folder_baseline(folder, tmp_path_factory):
    res, run_dir, losses = _fit(tmp_path_factory.mktemp("folder_a"), FOLDER, data=folder)
    return {"res": res, "run_dir": run_dir, "losses": losses, "final": _final(run_dir)}


@pytest.fixture(scope="module")
def folder_preempted(folder, tmp_path_factory):
    root = tmp_path_factory.mktemp("folder_sigterm")
    argv = [folder, "--dataset", "imagenet", "-a", FOLDER["arch"], "-b", "2", "--epochs", "1",
            "--seed", "1", "--save-every-steps", "2", "-p", "2", "--w-kurtosis",
            "--input-backend", "mp", "-j", "1", "--device", "cpu", "--log_path", str(root)]
    return _sigtermed(root, argv, (0, 2))


def test_folder_sigterm_exits_75_and_leaves_no_input_worker(folder_preempted):
    assert folder_preempted["rc"] == PREEMPT_EXIT_CODE
    assert folder_preempted["left"] == []
    run_dir = folder_preempted["run_dir"]
    (p,) = read_events(run_dir, "preempt")
    assert (p["epoch"], p["step_in_epoch"]) == (0, 3)
    assert len(read_events(run_dir, "data_error")) == 1


def test_folder_resume_after_sigterm_is_bitwise_the_uninterrupted_run(folder, folder_baseline,
                                                                       folder_preempted, tmp_path):
    res, run_dir, losses = _fit(tmp_path, FOLDER, data=folder,
                                resume=folder_preempted["run_dir"])
    assert sorted(folder_baseline["losses"]) == [(0, 0), (0, 1), (0, 2), (0, 3)]
    _assert_resumed_like_baseline(folder_baseline, run_dir, losses, (0, 3))
    assert res == folder_baseline["res"]

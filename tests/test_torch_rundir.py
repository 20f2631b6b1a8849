"""A port run dir against the JAX package's, on the CPU: the same config
(``resnet8_tiny`` -b 8, 2 epochs × 4 steps, ``--ede``, a checkpoint
every 2 steps) through both packages' ``fit``.

- The ``checkpoint`` events carry bitwise-equal schedule fields at the
  same (epoch, step_in_epoch), and the port's sidecar holds every key
  of the JAX package's.
- For each event kind the port emits, its field names are a superset of
  the reference's: in the two runs' timelines, and at every
  ``emit`` call of the reference's ``fit`` (``restore``, ``preempt`` and
  the forensics checkpoint included) and of its health monitor and
  memory poll.
- The reference's ``summarize --strict`` exits nonzero on a port run
  whose health monitor raised a critical alert, and 0 on a clean one.
- ``bdbnn_tpu.obs.summarize.summarize_run`` reads a resumed port run dir:
  its best top-1 and its checkpoint and restore lineage.
- The port's ``events.jsonl`` rotates past ``--events-max-mb`` into
  segments the JAX package's reader reads as one timeline; ``emit``
  refuses an unknown kind and writes no non-finite number.
- ``export_artifact`` from a port run dir writes an artifact that the
  port's engine and the JAX engine serve with the same logits (2e-5 of
  the largest |logit|, equal top-1, as the artifact tests hold them).
"""

import ast
import functools
import os

import jax
import numpy as np
import pytest
import torch

from bdbnn_tpu.configs.config import RunConfig as JRunConfig
from bdbnn_tpu.obs import events as jevents
from bdbnn_tpu.obs.summarize import summarize_run
from bdbnn_tpu.serve import engine as jengine
from bdbnn_tpu.serve import export as jexport
from bdbnn_tpu.train import loop as jloop
from bdbnn_tpu.utils import checkpoint as jck
from bdbnn_tpu_torch.obs.events import KNOWN_KINDS, EventWriter, read_events
from bdbnn_tpu_torch.serve import engine as tengine
from bdbnn_tpu_torch.serve import export as texport
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(dataset="cifar10", arch="resnet8_tiny", synthetic=True, batch_size=8, epochs=2,
           synthetic_train_size=32, synthetic_val_size=32, seed=1, save_every_steps=2,
           print_freq=2, ede=True, w_kurtosis=True)
SCHED_KEYS = ("reason", "epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k", "kurt_gate",
              "binarizer", "sched")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: its models are tiny, and the
    suite's workers share the machine's cores (several threads a worker
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_dir(root):
    (d,) = {r for r, _, fs in os.walk(root) for f in fs if f == "events.jsonl"}
    return d


class _JitInit:
    """A flax model whose ``init`` runs as one compiled program (the
    reference's ``fit`` calls it op by op: a hundred small compiles on the
    CPU). Everything else is the model's own."""

    def __init__(self, model):
        self._model = model
        self._init = jax.jit(functools.partial(model.init, train=True))

    def init(self, rng, x, train=True):
        assert train
        return self._init(rng, x)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    real = jloop.create_model
    mp.setattr(jloop, "create_model", lambda *a, **kw: _JitInit(real(*a, **kw)))
    try:
        jloop.fit(JRunConfig(log_path=str(root / "jax"), **CFG))
    finally:
        mp.undo()
    tloop.fit(RunConfig(log_path=str(root / "port"), device="cpu", **CFG))
    return {"jax": _run_dir(root / "jax"), "port": _run_dir(root / "port"), "root": root}


def test_checkpoint_schedule_fields_equal_the_jax_packages(runs):
    by_key = {}
    for pkg in ("jax", "port"):
        evs = read_events(runs[pkg], "checkpoint")
        by_key[pkg] = {(e["epoch"], e["step_in_epoch"]): {k: e[k] for k in SCHED_KEYS}
                       for e in evs}
    assert list(by_key["port"]) == list(by_key["jax"]) == [(0, 2), (1, 0), (1, 2), (2, 0)]
    assert by_key["port"] == by_key["jax"]
    assert by_key["port"][(1, 2)]["ede_t"] != 1.0
    jside = jck.read_resume_state(os.path.join(runs["jax"], jck.CKPT_NAME))
    tside = jck.read_resume_state(os.path.join(runs["port"], ck.CKPT_NAME))
    assert set(jside) <= set(tside), set(jside) - set(tside)
    assert {k: tside[k] for k in ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k",
                                  "kurt_gate", "binarizer", "sched")} \
        == {k: jside[k] for k in ("epoch", "step_in_epoch", "lr_step", "ede_t", "ede_k",
                                  "kurt_gate", "binarizer", "sched")}


def _emit_calls(path, skip_functions=()):
    """(kind, keyword names) of every ``.emit("kind", ...)`` call in
    ``path``, outside functions named in ``skip_functions``."""
    tree = ast.parse(open(path).read())
    skip = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in skip_functions:
            skip |= {id(n) for n in ast.walk(fn)}
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit" and node.args
                and isinstance(node.args[0], ast.Constant) and id(node) not in skip):
            out.append((node.args[0].value, {k.arg for k in node.keywords if k.arg}))
    return out


# the kinds a ``serve-bench`` run dir adds (serve/loadgen.py), those a
# ``serve-http`` run dir adds (serve/http.py, serve/pool.py) and the fleet
# router's (serve/fleet.py)
SERVE_KINDS = {"serve", "rtrace", "replica", "http", "admission", "capacity", "swap", "canary",
               "shadow", "fleet"}
TRAIN_KINDS = KNOWN_KINDS - SERVE_KINDS


def test_port_event_fields_are_a_superset_of_the_references(runs):
    for kind in TRAIN_KINDS:
        want = {k for e in read_events(runs["jax"], kind) for k in e}
        got = {k for e in read_events(runs["port"], kind) for k in e}
        assert want <= got, (kind, want - got)
    ref = _emit_calls(os.path.join(REPO, "bdbnn_tpu", "train", "loop.py"))
    port = _emit_calls(os.path.join(REPO, "bdbnn_tpu_torch", "train", "loop.py"))
    checked = set()
    for kind, fields in ref:
        assert kind in TRAIN_KINDS, kind
        assert any(k == kind and fields <= f for k, f in port), (kind, fields)
        checked.add(kind)
    assert {"restore", "preempt", "checkpoint", "eval", "run_start", "profile"} <= checked
    # the monitor's and the memory poll's own emits, module for module
    for mod in ("health", "memory"):
        ref = _emit_calls(os.path.join(REPO, "bdbnn_tpu", "obs", f"{mod}.py"))
        port = _emit_calls(os.path.join(REPO, "bdbnn_tpu_torch", "obs", f"{mod}.py"))
        assert ref and sorted((k, sorted(f)) for k, f in port) == \
            sorted((k, sorted(f)) for k, f in ref)


def test_summarize_reads_a_resumed_port_run(runs, tmp_path):
    old = os.path.join(runs["port"], ck.CKPT_NAME + ".old")
    tloop.fit(RunConfig(log_path=str(tmp_path), device="cpu", resume=old, **CFG))
    run_dir = _run_dir(tmp_path)
    _, summary = summarize_run(run_dir)
    evals = read_events(run_dir, "eval")
    assert summary["best"]["acc1"] == round(max(e["acc1"] for e in evals), 3)
    res = summary["resilience"]
    assert res["checkpoints"] == len(read_events(run_dir, "checkpoint")) == 1
    assert res["restart_lineage"] == [os.path.abspath(runs["port"])]
    assert res["resumed_from"] == os.path.abspath(old)
    (r,) = res["restores"]
    assert (r["source"], r["epoch"], r["step_in_epoch"], r["integrity"], r["fallback"]) \
        == (old, 1, 2, "ok", False)
    assert summary["provenance"]["backend"] == "cpu"


def test_summarize_strict_fails_on_a_port_run_with_a_critical_alert(runs, tmp_path, capsys):
    """The reference's ``summarize --strict`` passes the clean port run
    and exits nonzero on one whose monitor raised a critical alert (the
    probe drain patched to report zero flips, as the reference's own
    ``collapsed_run`` does); its report names the detector."""
    from bdbnn_tpu import cli as jcli

    assert jcli.main(["summarize", runs["port"], "--strict"]) == 0
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop, "drain_probe_report",
               lambda sums, sizes, steps: ({"layer": 0.0}, {"layer": 2.5}))
    try:
        tloop.fit(RunConfig(log_path=str(tmp_path), device="cpu", **{
            **CFG, "epochs": 1, "print_freq": 1,
            "health_thresholds": ("warmup_intervals=1", "debounce=1")}))
    finally:
        mp.undo()
    run_dir = _run_dir(tmp_path)
    capsys.readouterr()
    assert jcli.main(["summarize", run_dir, "--strict"]) != 0
    out = capsys.readouterr()
    assert "flip_collapse" in out.out + out.err
    _, summary = summarize_run(run_dir)
    assert summary["health"]["alerts_critical"] == 1
    assert summary["health"]["by_detector"] == {"flip_collapse": 1}


def test_export_from_a_port_run_serves_in_both_engines(runs, tmp_path):
    art = str(tmp_path / "art")
    a = texport.export_artifact(runs["port"], art)
    evals = read_events(runs["port"], "eval")
    assert os.path.isdir(os.path.join(runs["port"], ck.BEST_NAME))
    # the eval events round top-1 to 4 decimals, as the reference's do
    assert round(a["eval"]["checkpoint_acc1"], 4) == max(e["acc1"] for e in evals) > 0
    assert a["provenance"]["run_dir"] == os.path.abspath(runs["port"])
    assert a["checkpoint"]["integrity"] == "ok" and a["stats"]["binarized_convs"] == 5
    (ev,) = read_events(runs["port"], "export")
    assert ev["artifact"] == os.path.abspath(art)
    assert jexport.read_artifact(art)["provenance"]["config_hash"] == a["provenance"]["config_hash"]
    jax_engine = jengine.InferenceEngine(art, buckets=(4,))
    port_engine = tengine.InferenceEngine(art, buckets=(4,), device="cpu")
    x = np.random.default_rng(3).normal(size=(5, 32, 32, 3)).astype(np.float32)
    got, ref = port_engine.predict_logits(x), jax_engine.predict_logits(x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * float(np.max(np.abs(ref))))
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_events_rotate_into_one_timeline_both_readers_read(tmp_path):
    tloop.fit(RunConfig(log_path=str(tmp_path), device="cpu", events_max_mb=2e-3, **CFG))
    run_dir = _run_dir(tmp_path)
    segments = sorted(f for f in os.listdir(run_dir) if f.startswith("events."))
    assert len(segments) > 3 and "events.1.jsonl" in segments
    port = read_events(run_dir)
    assert port == jevents.read_events(run_dir)
    kinds = [e["kind"] for e in port]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end" and kinds.count("checkpoint") == 4
    assert [e["t"] for e in port] == sorted(e["t"] for e in port)
    w = EventWriter(str(tmp_path / "w"))
    try:
        with pytest.raises(ValueError, match="unknown event kind"):
            w.emit("no_such_kind", detector="x")
        rec = w.emit("eval", loss=float("nan"), acc1=float("inf"), count=np.int64(3))
    finally:
        w.close()
    assert rec["loss"] is None and rec["acc1"] is None and rec["count"] == 3
    assert read_events(str(tmp_path / "w")) == [rec]

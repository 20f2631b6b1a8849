"""The port's checkpoints (``bdbnn_tpu_torch/utils/checkpoint.py``) on
the CPU: integrity and the sidecar, the ``.old`` fallback, ``retry_io``,
a crash between every pair of commit operations, parity of the digest
and the sidecar with the JAX package's readers, the param-group guard,
``reset_resume``, a reference-format ``.pth`` resume and ``--pretrained``
— at ``resnet8_tiny`` / ``resnet20_react`` size, inputs from numpy
seeds."""

import json
import os

import numpy as np
import pytest
import torch

from bdbnn_tpu.utils import checkpoint as jck
from bdbnn_tpu_torch.models import convert_torch_state_dict, create_model, overlay_state_dict
from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.loop import build_training, epoch_schedule
from bdbnn_tpu_torch.train.resilience import CheckpointPolicy
from bdbnn_tpu_torch.nn.binarize import resolve_family, set_active_family
from bdbnn_tpu_torch.train.step import make_train_step
from bdbnn_tpu_torch.utils import checkpoint as ck
from chip_smoke import torchvision_state_dict, write_teacher_checkpoint

CPU = torch.device("cpu")
# what the JAX package's sidecar holds (bdbnn_tpu/utils/checkpoint.py
# save_checkpoint + bdbnn_tpu/train/loop.py _save_ckpt's resume_state)
REF_SIDECAR_KEYS = {"epoch", "step_in_epoch", "best_acc1", "saved_unix", "best_epoch",
                    "host_rng", "lr_step", "ede_t", "ede_k", "kurt_gate", "binarizer", "sched",
                    "topology"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread in this module: its models are tiny, and the
    suite's workers share the machine's cores (several threads a worker
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(dataset="cifar10", arch="resnet8_tiny", synthetic=True, batch_size=8, epochs=2,
                synthetic_train_size=32, synthetic_val_size=8, seed=1, device="cpu")
    return RunConfig(**{**base, **kw})


def _state(seed=0, steps=2, **kw):
    """A TrainState after ``steps`` train steps on numpy-seeded batches,
    so the optimizer holds moments."""
    cfg = _cfg(**kw).validate()
    family = set_active_family(resolve_family(cfg.binarizer, ede=cfg.ede))
    state, step_cfg = build_training(cfg, CPU, 4, 32)
    step = make_train_step(state.model, state.optimizer, step_cfg)
    rng = np.random.default_rng(seed)
    tk, gate = epoch_schedule(family, cfg, 0)
    for _ in range(steps):
        batch = (torch.from_numpy(rng.normal(size=(8, 32, 32, 3)).astype(np.float32)),
                 torch.from_numpy(rng.integers(0, 10, size=(8,))))
        state, _ = step(state, batch, tk, gate)
    return state


def _fresh(**kw):
    return build_training(_cfg(**kw).validate(), CPU, 4, 32)[0]


def _snapshot(state):
    return ck.state_payload(state)


def _assert_same(a, b):
    """Two ``state_payload`` dicts are bitwise equal."""
    assert a["step"] == b["step"] and a["param_names"] == b["param_names"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    ga = [{k: v for k, v in g.items()} for g in a["optimizer"]["param_groups"]]
    gb = [{k: v for k, v in g.items()} for g in b["optimizer"]["param_groups"]]
    assert ga == gb


def _save(run_dir, state, epoch=0, **kw):
    kw.setdefault("is_best", False)
    return ck.save_checkpoint(str(run_dir), state, epoch=epoch, arch="resnet8_tiny",
                              best_acc1=12.5, **kw)


def test_integrity_ok_and_sidecar_round_trip(tmp_path):
    state = _state()
    side = {"best_epoch": 3, "lr_step": 2, "sched": [0.5], "topology": {"processes": 1}}
    path = _save(tmp_path, state, epoch=1, step_in_epoch=2, resume_state=side)
    assert ck.verify_integrity(path) == "ok"
    got = ck.read_resume_state(path)
    assert got["epoch"] == 1 and got["step_in_epoch"] == 2 and got["best_acc1"] == 12.5
    assert {k: got[k] for k in side} == side
    fresh = _fresh()
    r = ck.load_checkpoint(str(tmp_path), fresh)
    assert (r["epoch"], r["step_in_epoch"], r["best_epoch"], r["integrity"], r["fallback"]) \
        == (1, 2, 3, "ok", False)
    _assert_same(_snapshot(fresh), _snapshot(state))


@pytest.mark.parametrize("damage", ["corrupt", "truncated"])
def test_a_damaged_payload_falls_back_to_old(tmp_path, damage):
    older, newer = _state(seed=1), _state(seed=2, steps=3)
    _save(tmp_path, older)
    _save(tmp_path, newer)
    payload = tmp_path / ck.CKPT_NAME / ck.PAYLOAD_NAME
    blob = bytearray(payload.read_bytes())
    if damage == "corrupt":
        blob[len(blob) // 2] ^= 0xFF  # the digest no longer holds
    else:
        os.remove(tmp_path / ck.CKPT_NAME / ck.INTEGRITY_NAME)
        blob = blob[: len(blob) // 2]  # no digest: the payload does not read
    payload.write_bytes(bytes(blob))
    fresh = _fresh()
    r = ck.load_checkpoint(str(tmp_path), fresh)
    assert r["fallback"] and r["source"].endswith(ck.CKPT_NAME + ".old")
    _assert_same(_snapshot(fresh), _snapshot(older))


def test_every_candidate_corrupt_raises_naming_each(tmp_path):
    _save(tmp_path, _state(seed=1))
    _save(tmp_path, _state(seed=2))
    for name in (ck.CKPT_NAME, ck.CKPT_NAME + ".old"):
        p = tmp_path / name / ck.PAYLOAD_NAME
        p.write_bytes(p.read_bytes()[:100])
    os.remove(tmp_path / ck.CKPT_NAME / ck.INTEGRITY_NAME)
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(str(tmp_path), _fresh())
    msg = str(e.value)
    assert f"{tmp_path / ck.CKPT_NAME}: " in msg and "integrity digest mismatch" in msg
    assert f"{tmp_path / ck.CKPT_NAME}.old: integrity digest mismatch" in msg


def test_a_missing_digest_is_trusted(tmp_path):
    state = _state()
    path = _save(tmp_path, state)
    os.remove(os.path.join(path, ck.INTEGRITY_NAME))
    assert ck.verify_integrity(path) == "missing"
    fresh = _fresh()
    r = ck.load_checkpoint(path, fresh)
    assert r["integrity"] == "missing" and not r["fallback"]
    _assert_same(_snapshot(fresh), _snapshot(state))


def test_a_stale_tmp_is_cleaned(tmp_path):
    for name in (ck.CKPT_NAME, ck.BEST_NAME):
        stale = tmp_path / (name + ".tmp")
        stale.mkdir(parents=True)
        (stale / "junk").write_text("torn")
    state = _state()
    _save(tmp_path, state, is_best=True)
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    assert ck.verify_integrity(str(tmp_path / ck.BEST_NAME)) == "ok"


@pytest.mark.parametrize("case", ["recovers", "other_error", "exhausted"])
def test_retry_io(case):
    calls, sleeps = [], []

    def fn():
        calls.append(1)
        if case == "other_error":
            raise ValueError("not transient")
        if case == "exhausted" or len(calls) < 3:
            raise OSError(f"blip {len(calls)}")
        return "done"

    if case == "recovers":
        assert ck.retry_io(fn, sleep=sleeps.append) == "done"
        assert len(calls) == 3 and sleeps == [0.05, 0.1]
    elif case == "other_error":
        with pytest.raises(ValueError):
            ck.retry_io(fn, sleep=sleeps.append)
        assert len(calls) == 1 and sleeps == []
    else:
        with pytest.raises(OSError, match="blip 4"):
            ck.retry_io(fn, sleep=sleeps.append)
        assert len(calls) == ck.RETRY_ATTEMPTS and sleeps == [0.05, 0.1, 0.2]


class _Crash(BaseException):
    """A process death: retry_io does not catch it."""


COMMIT_OPS = 6  # checkpoint: rmtree(old), rename(ckpt, old), rename(tmp, ckpt); model_best alike


@pytest.fixture(scope="module")
def four_states():
    """Four states after 1, 2, 3 and 4 steps (only read by the saves)."""
    return [_state(seed=s, steps=1 + s) for s in range(4)]


@pytest.mark.parametrize("crash_at", range(COMMIT_OPS))
def test_crash_between_commit_operations_leaves_a_restorable_checkpoint(tmp_path, monkeypatch,
                                                                        crash_at, four_states):
    states = four_states
    _save(tmp_path, states[0], is_best=True)
    _save(tmp_path, states[1], is_best=True)
    ops = []

    def op(real, name):
        def run(*a):
            if len(ops) == crash_at:
                raise _Crash(f"killed before {name}{a}")
            ops.append(name)
            return real(*a)
        return run

    monkeypatch.setattr(ck, "_rename", op(os.rename, "rename"))
    monkeypatch.setattr(ck, "_rmtree", op(ck.shutil.rmtree, "rmtree"))
    with pytest.raises(_Crash):
        _save(tmp_path, states[2], is_best=True)
    monkeypatch.undo()
    # one complete checkpoint survives: the new one or the one before
    fresh = _fresh()
    ck.load_checkpoint(str(tmp_path), fresh)
    got = _snapshot(fresh)
    assert got["step"] in (states[1].step, states[2].step)
    _assert_same(got, _snapshot(states[1] if got["step"] == states[1].step else states[2]))
    best = ck.load_variables(str(tmp_path))
    assert all(torch.equal(best[k], v) for k, v in
               (states[1] if torch.equal(best["fc.weight"], states[1].model.fc.weight.detach())
                else states[2]).model.state_dict().items())
    # and the next save succeeds
    _save(tmp_path, states[3], is_best=True)
    fresh = _fresh()
    ck.load_checkpoint(str(tmp_path), fresh)
    _assert_same(_snapshot(fresh), _snapshot(states[3]))


def test_an_uninjected_save_runs_the_counted_commit_operations(tmp_path, monkeypatch):
    _save(tmp_path, _state(), is_best=True)
    _save(tmp_path, _state(), is_best=True)
    ops = []
    monkeypatch.setattr(ck, "_rename", lambda *a: (ops.append("rename"), os.rename(*a)))
    monkeypatch.setattr(ck, "_rmtree", lambda *a: (ops.append("rmtree"), ck.shutil.rmtree(*a)))
    _save(tmp_path, _state(), is_best=True)
    assert ops == ["rmtree", "rename", "rename"] * 2 and len(ops) == COMMIT_OPS


def test_reference_digest_and_sidecar_readers_agree_on_a_port_checkpoint(tmp_path):
    """The JAX package's ``dir_digest`` / ``verify_integrity`` over a port
    checkpoint dir agree with the port's, and its ``read_resume_state``
    reads every key it writes from a port run's sidecar."""
    tloop.fit(_cfg(log_path=str(tmp_path), save_every_steps=2, ede=True))
    (run_dir,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path) for d in ds
                  if d == ck.CKPT_NAME]
    assert jck.dir_digest(run_dir) == ck.dir_digest(run_dir)
    assert jck.verify_integrity(run_dir) == ck.verify_integrity(run_dir) == "ok"
    side = jck.read_resume_state(run_dir)
    assert REF_SIDECAR_KEYS <= set(side), REF_SIDECAR_KEYS - set(side)
    assert side == ck.read_resume_state(run_dir)
    assert side["topology"] == {"processes": 1, "devices": 1} and side["binarizer"] == "ede"


@pytest.mark.parametrize("how", ["other policy", "groups swapped"])
def test_a_param_group_mismatch_raises(tmp_path, how):
    state = _state(opt_policy="adam-linear")
    assert len(state.optimizer.param_groups) == 2
    _save(tmp_path, state)
    fresh = _fresh(opt_policy="adam-linear")
    if how == "other policy":
        fresh = _fresh(opt_policy="sgd-cosine")
    else:
        g = fresh.optimizer.param_groups
        fresh.optimizer = torch.optim.Adam([dict(g[1]), dict(g[0])])
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    with pytest.raises(ValueError, match="param groups differ"):
        ck.load_checkpoint(str(tmp_path), fresh)
    # nothing was loaded
    assert all(torch.equal(before[k], v) for k, v in fresh.model.state_dict().items())


def test_reset_resume_takes_weights_only(tmp_path):
    state = _state(opt_policy="adam-linear")
    _save(tmp_path, state, epoch=1, step_in_epoch=3)
    fresh = _fresh(opt_policy="adam-linear")
    r = ck.load_checkpoint(str(tmp_path), fresh, reset_resume=True)
    assert (r["epoch"], r["step_in_epoch"], r["best_acc1"], r["best_epoch"]) == (0, 0, 0.0, -1)
    assert fresh.step == 0 and not fresh.optimizer.state
    want = state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in fresh.model.state_dict().items())


def _reference_pth(model, path, **extra):
    """A student file as the original torch repo writes it: binary conv
    weights under ``weight`` in OIHW, torchvision key layout."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("float_weight"):
            k, v = k[: -len("float_weight")] + "weight", v.permute(3, 2, 0, 1)
        sd[k] = v
    torch.save({"state_dict": torchvision_state_dict(sd), **extra}, path)


def test_pth_resume_fast_forwards_the_lr_step(tmp_path):
    src = _state(seed=5, opt_policy="adam-linear")
    path = str(tmp_path / "student.pth.tar")
    _reference_pth(src.model, path, epoch=1, best_acc1=11.0)
    seen = []
    tloop.fit(_cfg(log_path=str(tmp_path / "log"), resume=path, opt_policy="adam-linear"),
              on_step=lambda e, i, m: seen.append((e, i)))
    (run_dir,) = {os.path.dirname(os.path.dirname(p)) for p in
                  [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "log") for f in fs]
                  if p.endswith(os.path.join(ck.CKPT_NAME, ck.PAYLOAD_NAME))}
    (restore,) = read_events(run_dir, "restore")
    assert (restore["format"], restore["epoch"], restore["lr_step"]) == ("torch", 1, 4)
    assert "opt_moments" in restore["not_restored"] and "lr_step" in restore["restored"]
    assert seen == [(1, i) for i in range(4)]
    (last,) = read_events(run_dir, "checkpoint")
    assert last["lr_step"] == 8 and last["epoch"] == 2
    assert read_events(run_dir, "run_end")[0]["best_acc1"] >= 11.0
    # Adam's bias correction continued from the fast-forwarded count
    opt = torch.load(os.path.join(run_dir, ck.CKPT_NAME, ck.PAYLOAD_NAME),
                     weights_only=True)["state"]["optimizer"]["state"]
    assert opt and all(float(s["step"]) == 8.0 for s in opt.values())


def test_checkpoint_policy_steps_and_minutes():
    now = [0.0]
    policy = CheckpointPolicy(every_steps=3, every_mins=0.5, clock=lambda: now[0])
    assert policy.active and not CheckpointPolicy().active
    assert [policy.step() for _ in range(3)] == [False, False, True]
    policy.note_saved()
    assert not policy.step()
    now[0] = 30.0
    assert policy.step() and not policy.due(clock_leader=False)
    policy.note_saved()
    assert not policy.due()


def test_pretrained_puts_oihw_weights_on_float_weight_and_is_strict(tmp_path, monkeypatch):
    path = str(tmp_path / "resnet20_float.pth")
    teacher = write_teacher_checkpoint(path, "resnet20_float", "cifar10", seed=6)
    seen = []
    real = tloop.make_eval_step
    monkeypatch.setattr(tloop, "make_eval_step",
                        lambda model, **kw: (seen.append(model), real(model, **kw))[1])
    tloop.fit(_cfg(arch="resnet20_react", log_path=str(tmp_path / "log"), pretrained=True,
                   pretrained_path=path, evaluate=True))
    (student,) = seen
    init = create_model("resnet20_react", "cifar10", generator=torch.Generator().manual_seed(1))
    got, want, fresh = student.state_dict(), teacher.state_dict(), init.state_dict()
    for k, v in got.items():
        if k.endswith("float_weight"):
            assert torch.equal(v, want[k[: -len("float_weight")] + "weight"].permute(2, 3, 1, 0))
        elif k in want:
            assert torch.equal(v, want[k]), k
        else:  # a binary extra keeps its initial value
            assert torch.equal(v, fresh[k]), k
    sd = convert_torch_state_dict(torch.load(path, weights_only=True)["state_dict"])
    bad = dict(sd)
    bad["layer1_0.conv1.weight"] = bad["layer1_0.conv1.weight"][:, :, :1]
    with pytest.raises(ValueError, match="shape mismatch at layer1_0.conv1.float_weight"):
        overlay_state_dict(init, bad, scope="pretrained student", allow_missing=True,
                           alias_float_weight=True)
    extra = {**sd, "head.weight": torch.zeros(3)}
    with pytest.raises(ValueError, match="not consumed.*head.weight"):
        overlay_state_dict(init, extra, scope="pretrained student", allow_missing=True,
                           alias_float_weight=True)

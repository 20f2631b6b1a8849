"""The port's training health stack against the JAX package's, on the CPU.

- ``HealthConfig``'s fields and defaults, ``apply_overrides``' results and
  errors, and ``RunConfig.validate``'s refusals of a bad
  ``--health-threshold`` / ``--profile-at`` are the reference's.
- Fed the same drain streams as the reference's ``tests/test_health.py``
  (flip collapse, explosion, a hovering signal, kurtosis with and without
  a target, loss spike, plateau, throughput cliff, memory creep, a healthy
  run), both ``HealthMonitor`` s emit equal ``alert`` and ``health``
  records.
- ``parse_profile_at`` and ``TraceCapture``'s window logic (schedule,
  ``<=``, trimming, unfired static windows only, one stop after a raise)
  match the reference's; a real window writes a gzipped Chrome trace where
  the reference's ``find_trace_file`` finds it.
- ``fit`` end to end: the reference's ``collapsed_run`` (the probe drain
  patched to report zero flips) raises the same alert sequence in both
  packages' ``fit``; the port's forensics checkpoint resumes bitwise; an
  alert at the final drain writes a checkpoint and no empty trace;
  ``--no-health`` builds no monitor; two gloo ranks save one aligned
  forensics checkpoint with ``coordinated: true``.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from bdbnn_tpu.configs.config import RunConfig as JRunConfig
from bdbnn_tpu.obs import events as jevents
from bdbnn_tpu.obs import health as jhealth
from bdbnn_tpu.obs import memory as jmemory
from bdbnn_tpu.obs import trace as jtrace
from bdbnn_tpu.train import loop as jloop
from bdbnn_tpu_torch.obs import health as thealth
from bdbnn_tpu_torch.obs import memory as tmemory
from bdbnn_tpu_torch.obs import trace as ttrace
from bdbnn_tpu_torch.obs.events import EventWriter, read_events, read_jsonl
from bdbnn_tpu_torch.train import config as tconfig
from bdbnn_tpu_torch.train import loop as tloop
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.utils import checkpoint as ck


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_dir(root):
    (d,) = {r for r, _, fs in os.walk(root) for f in fs if f == "events.jsonl"}
    return d


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


# ---------------------------------------------------------------------------
# config and overrides


def test_health_config_fields_and_defaults_are_the_references():
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(thealth.HealthConfig)]
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jhealth.HealthConfig)]
    assert tf == jf
    assert thealth.SEVERITIES == jhealth.SEVERITIES
    assert thealth.DETECTORS == jhealth.DETECTORS
    assert thealth.RUN_ENDING_SEVERITY == jhealth.RUN_ENDING_SEVERITY


def _outcome(fn, *a, **kw):
    try:
        return "ok", fn(*a, **kw)
    except Exception as e:  # the refusal's type and message
        return type(e).__name__, str(e)


@pytest.mark.parametrize("specs", [
    (), ("loss_spike_factor=5",), ("warmup_intervals=2", "debounce=1"),
    ("throughput_window=999", "hbm_creep_frac=0.5"), ("grad_norm=1",), ("loss_window",),
    ("debounce=two",), ("warmup_intervals=1.5",), (" kurt_divergence_abs =3",),
])
def test_apply_overrides_results_and_errors_are_the_references(specs):
    got = _outcome(thealth.apply_overrides, thealth.HealthConfig(), specs)
    want = _outcome(jhealth.apply_overrides, jhealth.HealthConfig(), specs)
    if want[0] == "ok":
        assert got[0] == "ok" and dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    else:
        assert got == want


@pytest.mark.parametrize("kw", [
    dict(health_thresholds=("grad_norm=1",)), dict(health_thresholds=("debounce=x",)),
    dict(profile_at=("5",)), dict(profile_at=("1:-2",)), dict(profile_at=("0:1:0",)),
    dict(health_forensics_steps=0), dict(health_max_forensics=-1),
])
def test_validate_refuses_bad_obs_options_as_the_reference(kw):
    got = _outcome(RunConfig(**kw).validate)
    want = _outcome(JRunConfig(**kw).validate)
    assert want[0] == "ValueError" and got == want


def test_the_obs_options_validate_and_only_tensor_parallelism_is_unsupported():
    # tensor parallelism is ported too: no training option is left
    # unsupported (the list of them is gone), and --model-parallel validates
    assert not hasattr(tconfig, "UNSUPPORTED")
    assert RunConfig(model_parallel=4).validate().model_parallel == 4
    cfg = RunConfig(profile_dir="p", profile_at=("1:2:3", "0:4"), health_forensics_steps=3,
                    health_max_forensics=0, health_thresholds=("loss_spike_factor=4",))
    assert cfg.validate().profile_at == ("1:2:3", "0:4")


# ---------------------------------------------------------------------------
# the detector streams of the reference's tests/test_health.py


def _decay(i):
    return 2.3 - 0.05 * i


def _jitter(i):
    return 2.0 + (0.1 if i % 2 else -0.1)


# name -> (signals, epochs, kurt_target, memory records)
STREAMS = {
    "flip_collapse": ([{"flip_rate": {"a": 0.0}}] * 8, 10, None, ()),
    "flip_collapse_near_end": ([{"flip_rate": {"a": 0.0}, "epoch": 95}] * 8, 100, None, ()),
    "flip_explosion": ([{"flip_rate": {"a": 0.4}}] * 8, 10, None, ()),
    "hovering": ([{"flip_rate": {"a": 0.0}}] * 10 + [{"flip_rate": {"a": 1e-3}}] * 2
                 + [{"flip_rate": {"a": 0.0}}] * 3, 10, None, ()),
    "kurtosis_no_target": ([{"kurtosis": {"a": 50.0}}] * 8, 10, None, ()),
    "kurtosis_target": ([{"kurtosis": {"a": 50.0}}] * 8, 10, 1.8, ()),
    "loss_spike": ([{"loss": _jitter(i)} for i in range(6)] + [{"loss": 9.0}]
                   + [{"loss": _jitter(i)} for i in range(3)], 10, None, ()),
    "plateau_high": ([{"loss": 2.3}] * 8, 10, None, ()),
    "plateau_low": ([{"loss": 0.01}] * 8, 10, None, ()),
    "throughput_cliff": ([{"img_per_s": 1000.0}] * 9 + [{"img_per_s": 200.0}] * 2, 10, None, ()),
    "hbm_creep": ([], 10, None, ({"peak_bytes": 10 * 2**30}, {"peak_bytes": 10 * 2**30},
                                 {"peak_bytes": 12 * 2**30, "epoch": 3},
                                 {"peak_bytes": 14 * 2**30},
                                 {"available": False, "peak_bytes": None})),
    "healthy": ([{"loss": 2.3 * (0.97 ** i), "img_per_s": 1000.0 + (-30.0 if i % 3 else 40.0),
                  "flip_rate": {"a": 1e-2 / (1 + i), "b": 5e-3},
                  "kurtosis": {"a": 2.8 - 0.05 * i, "b": 2.2}, "epoch": i // 4}
                 for i in range(24)], 10, 1.8,
                ({"peak_bytes": 8 * 2**30}, {"peak_bytes": 8 * 2**30 + 2**20})),
}


def _drive(pkg, tmp_path, name):
    signals, epochs, kurt_target, mems = STREAMS[name]
    writer = (EventWriter if pkg is thealth else jevents.EventWriter)(str(tmp_path))
    mon = pkg.HealthMonitor(pkg.HealthConfig(warmup_intervals=3, debounce=2), writer,
                            epochs=epochs, kurt_target=kurt_target)
    fired = []
    for i, sig in enumerate(signals):
        alerts = mon.observe_interval(
            epoch=sig.get("epoch", 0), step=i, loss=sig.get("loss", _decay(i)),
            img_per_s=sig.get("img_per_s", 100.0), flip_rate=sig.get("flip_rate", {"a": 1e-3}),
            kurtosis=sig.get("kurtosis", {"a": 2.5}))
        fired += [(i, a["detector"]) for a in alerts]
    for m in mems:
        fired += [("memory", a["detector"]) for a in mon.observe_memory(m)]
    mon.emit_summary()
    writer.close()
    return fired, mon.counts(), _strip(read_jsonl(writer.path))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_monitor_emits_the_references_records_on_each_stream(name, tmp_path):
    got = _drive(thealth, tmp_path / "port", name)
    want = _drive(jhealth, tmp_path / "jax", name)
    assert got == want
    # the streams' own verdicts, as the reference's tests pin them
    expected = {"flip_collapse": [(4, "flip_collapse")], "flip_collapse_near_end": [],
                "flip_explosion": [(4, "flip_explosion")],
                "hovering": [(4, "flip_collapse"), (13, "flip_collapse")],
                "kurtosis_no_target": [], "kurtosis_target": [(4, "kurt_divergence")],
                "loss_spike": [(6, "loss_spike")], "plateau_high": [(5, "loss_plateau")],
                "plateau_low": [], "throughput_cliff": [(10, "throughput_regression")],
                "hbm_creep": [("memory", "hbm_creep")], "healthy": []}[name]
    assert got[0] == expected
    assert [r["kind"] for r in got[2]][-1] == "health"


def test_detector_state_is_the_references_over_a_random_stream():
    rng = np.random.default_rng(0)
    breach, recovered = rng.random(400) < 0.6, rng.random(400) < 0.3
    for warmup, debounce in ((0, 1), (3, 2), (5, 3)):
        a, b = thealth.DetectorState(warmup, debounce), jhealth.DetectorState(warmup, debounce)
        got = [a.update(bool(x), bool(y)) for x, y in zip(breach, recovered)]
        assert got == [b.update(bool(x), bool(y)) for x, y in zip(breach, recovered)]
        assert a.fired == b.fired > 0


def test_cpu_memory_event_and_watermark_are_the_references(tmp_path):
    tw, jw = EventWriter(str(tmp_path / "t")), jevents.EventWriter(str(tmp_path / "j"))
    got = tmemory.emit_memory_event(tw, "post_compile", [torch.device("cpu")], epoch=0)
    want = jmemory.emit_memory_event(jw, "post_compile", jax.local_devices(), epoch=0)
    assert _strip([got]) == _strip([want])
    assert got["available"] is False and got["peak_bytes"] is None
    evs = [{"peak_bytes": 3 * 2**30, "limit_bytes": 80 * 2**30}, {"peak_bytes": 5 * 2**30},
           {"peak_bytes": None}]
    assert tmemory.hbm_watermark(evs) == jmemory.hbm_watermark(evs)
    assert tmemory.hbm_watermark([]) is None


# ---------------------------------------------------------------------------
# capture windows


@pytest.mark.parametrize("spec", ["12:40:8", "0:5", "5", "1:2:3:4", "a:b", "1:-2", "1:2:0",
                                  "-1:0", "3:0:1"])
def test_parse_profile_at_is_the_references(spec):
    assert _outcome(ttrace.parse_profile_at, spec, 7) == _outcome(jtrace.parse_profile_at,
                                                                  spec, 7)


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: counts starts and stops."""

    calls = {"start": 0, "stop": 0}

    def __init__(self, **kw):
        pass

    def prepare_trace(self):
        pass

    def start_trace(self):
        self.calls["start"] += 1

    def stop(self):
        self.calls["stop"] += 1

    def export_chrome_trace(self, path):
        open(path, "w").close()


@pytest.fixture
def spies(monkeypatch):
    import jax.profiler

    jcalls = {"start": 0, "stop": 0}
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: jcalls.__setitem__("start", jcalls["start"] + 1))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: jcalls.__setitem__("stop", jcalls["stop"] + 1))
    monkeypatch.setattr(_FakeProfile, "calls", {"start": 0, "stop": 0})
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return {jtrace: jcalls, ttrace: _FakeProfile.calls}


def _bad_fence():
    raise RuntimeError("device died")


def _window_script(mod, d, name):
    """One of the reference's TraceCapture scenarios, as a list of what
    each call returned."""
    out = []
    if name == "normal":
        cap = mod.TraceCapture(d, [(1, 2, 3)])
        out += [cap.maybe_start(0, 2), cap.maybe_start(1, 1), cap.maybe_start(1, 2),
                cap.maybe_stop(1, 3), cap.maybe_stop(1, 4), cap.stop_if_active()]
    elif name == "raise_between":
        cap = mod.TraceCapture(d, [(0, 0, 5)])
        out += [cap.maybe_start(0, 0), cap.stop_if_active(last_step=1), cap.stop_if_active()]
    elif name == "fence_failure":
        cap = mod.TraceCapture(d, [(0, 0, 5)])
        out.append(cap.maybe_start(0, 0))
        out.append(_outcome(cap.maybe_stop, 0, 4, fence=_bad_fence))
        out += [cap.active, cap.stop_if_active()]
    elif name == "late_start":
        cap = mod.TraceCapture(d, [(0, 100, 2)])
        out += [cap.maybe_start(0, 99), cap.maybe_start(0, 100), cap.stop_if_active(last_step=100)]
    elif name == "unfired":
        cap = mod.TraceCapture(d, [(3, 0, 5), (0, 500, 5)])
        out += [cap.maybe_start(0, s) for s in range(10)] + [sorted(cap.unfired())]
    elif name == "scheduled":
        # a forensics window: scheduled mid-run, never reported unfired
        cap = mod.TraceCapture(d, [(0, 8, 2)])
        cap.schedule(0, 3, 2)
        cap.schedule(1, 0, 0)  # n_steps clamps to 1
        out += [cap.maybe_start(0, 3), cap.maybe_stop(0, 4), cap.maybe_start(0, 6),
                cap.maybe_start(0, 8), cap.stop_if_active(last_step=8), sorted(cap.unfired())]
    return out


@pytest.mark.parametrize("name", ["normal", "raise_between", "fence_failure", "late_start",
                                  "unfired", "scheduled"])
def test_trace_capture_windows_are_the_references(name, tmp_path, spies):
    d = str(tmp_path / "tr")
    got, want = _window_script(ttrace, d, name), _window_script(jtrace, d, name)
    assert got == want
    assert spies[ttrace] == spies[jtrace]
    assert spies[ttrace]["start"] == spies[ttrace]["stop"]


@pytest.mark.parametrize("device,burst", [("cuda", True), ("cpu", False), (None, False)])
def test_a_card_window_absorbs_before_its_capture_starts(device, burst, tmp_path, monkeypatch):
    order = []

    class Recorder(_FakeProfile):
        def prepare_trace(self):
            order.append("prepare")

        def start_trace(self):
            order.append("start")

    monkeypatch.setattr(torch.profiler, "profile", Recorder)
    monkeypatch.setattr(ttrace, "_absorb_lost_prefix", lambda _t, dev: order.append(dev.type))
    dev = torch.device(device) if device else None
    cap = ttrace.TraceCapture(str(tmp_path / "tr"), [(0, 0, 1)], device=dev)
    assert cap.maybe_start(0, 0)
    assert order == (["prepare", "cuda", "start"] if burst else ["prepare", "start"])
    # close the window: an open one keeps the process's spans recording for
    # every later test in it
    assert cap.stop_if_active() is not None and not ttrace.spans_recording()


def test_a_real_window_writes_a_trace_the_reference_finds(tmp_path):
    d = str(tmp_path / "tr")
    cap = ttrace.TraceCapture(d, [(0, 0, 1)])
    assert cap.maybe_start(0, 0)
    with cap.annotate("dispatch"):
        torch.ones(8) @ torch.ones(8)
    info = cap.maybe_stop(0, 0)
    assert info == {"epoch": 0, "start_step": 0, "steps": 1, "trace_dir": d}
    path = jtrace.find_trace_file(d)
    assert path and path.endswith(".trace.json.gz")
    assert os.path.relpath(path, d).split(os.sep)[:2] == ["plugins", "profile"]
    names = {e.get("name") for e in jtrace.load_trace_events(path)}
    assert "dispatch" in names
    assert isinstance(cap.annotate("x"), type(ttrace.nullcontext()))


# ---------------------------------------------------------------------------
# fit end to end


class _JitInit:
    """A flax model whose ``init`` runs as one compiled program."""

    def __init__(self, model):
        self._model = model
        self._init = jax.jit(functools.partial(model.init, train=True))

    def init(self, rng, x, train=True):
        return self._init(rng, x)

    def __getattr__(self, name):
        return getattr(self._model, name)


# the reference's collapsed_run at a smaller size: 8 steps of -b 8, the
# flip-rate drain patched to report zero flips, warmup 2 + debounce 1, so
# flip_collapse fires at the third drain (step 2)
COLLAPSED = dict(dataset="cifar10", synthetic=True, synthetic_train_size=64,
                 synthetic_val_size=16, arch="resnet8_tiny", epochs=1, batch_size=8, lr=0.05,
                 print_freq=1, seed=0, health_forensics_steps=3,
                 health_thresholds=("throughput_window=999", "warmup_intervals=2", "debounce=1"))


def _zero_flips(sums, sizes, steps):
    return {"layer": 0.0}, {"layer": 2.5}


@pytest.fixture(scope="module")
def collapsed(tmp_path_factory):
    root = tmp_path_factory.mktemp("collapsed")
    mp = pytest.MonkeyPatch()
    real = jloop.create_model
    mp.setattr(jloop, "create_model", lambda *a, **kw: _JitInit(real(*a, **kw)))
    mp.setattr(jloop, "drain_probe_report", _zero_flips)
    mp.setattr(tloop, "drain_probe_report", _zero_flips)
    # the reference's window runs with jax.profiler spied out: its process
    # wide trace session is not this test's subject, and a session left
    # in this worker would be every later test's
    import jax.profiler

    mp.setattr(jax.profiler, "start_trace", lambda d: None)
    mp.setattr(jax.profiler, "stop_trace", lambda: None)
    losses = []
    try:
        jloop.fit(JRunConfig(log_path=str(root / "jax"), **COLLAPSED))
        tloop.fit(RunConfig(log_path=str(root / "port"), device="cpu", **COLLAPSED),
                  on_step=lambda e, s, m: losses.append(float(m["loss"])))
    finally:
        mp.undo()
    return {"jax": _run_dir(root / "jax"), "port": _run_dir(root / "port"), "losses": losses}


def _alerts(run_dir):
    return [(a["detector"], a["epoch"], a["step"], a["severity"])
            for a in read_events(run_dir, "alert")]


def test_fit_raises_the_references_alerts(collapsed):
    got, want = _alerts(collapsed["port"]), _alerts(collapsed["jax"])
    assert got == want == [("flip_collapse", 0, 2, "critical")]
    for kind in ("health", "profile"):
        t = _strip(read_events(collapsed["port"], kind))
        j = _strip(read_events(collapsed["jax"], kind))
        drop = {"trace_dir"}
        assert [{k: v for k, v in r.items() if k not in drop} for r in t] == \
            [{k: v for k, v in r.items() if k not in drop} for r in j]
    (tp,) = [e for e in read_events(collapsed["port"], "checkpoint") if e["reason"] == "forensics"]
    (jp,) = [e for e in read_events(collapsed["jax"], "checkpoint") if e["reason"] == "forensics"]
    assert set(jp) <= set(tp)
    keys = ("detector", "coordinated", "epoch", "step_in_epoch", "lr_step")
    assert {k: tp[k] for k in keys} == {k: jp[k] for k in keys}
    assert tp["path"] == os.path.join(collapsed["port"], "forensics", "flip_collapse_e0_s3",
                                      ck.CKPT_NAME)
    assert ck.verify_integrity(tp["path"]) == "ok"
    phases = [m["phase"] for m in read_events(collapsed["port"], "memory")]
    assert phases == [m["phase"] for m in read_events(collapsed["jax"], "memory")]
    assert phases == ["post_compile", "epoch"]


def test_the_forensics_trace_lands_where_the_reference_looks(collapsed):
    (prof,) = read_events(collapsed["port"], "profile")
    assert (prof["epoch"], prof["start_step"], prof["steps"]) == (0, 3, 3)
    path = jtrace.find_trace_file(collapsed["port"])
    assert path and path.startswith(os.path.join(collapsed["port"], "profile", "plugins"))
    names = {e.get("name") for e in jtrace.load_trace_events(path)}
    assert {"data_wait", "dispatch"} <= names


def test_the_forensics_checkpoint_resumes_bitwise(collapsed, tmp_path):
    (fp,) = [e["path"] for e in read_events(collapsed["port"], "checkpoint")
             if e["reason"] == "forensics"]
    losses = []
    tloop.fit(RunConfig(log_path=str(tmp_path), device="cpu", resume=fp,
                        **{**COLLAPSED, "health": False}),
              on_step=lambda e, s, m: losses.append(float(m["loss"])))
    assert losses == collapsed["losses"][3:]
    assert not chip_smoke.state_diff(chip_smoke.final_payload(_run_dir(tmp_path)),
                                     chip_smoke.final_payload(collapsed["port"]))


def test_an_alert_at_the_final_drain_saves_and_traces_nothing(tmp_path, monkeypatch):
    """warmup 6 + debounce 2 over 8 drains: the alert fires at the
    epoch's (and the run's) last drain; the checkpoint lands and no
    window opens that the loop could not feed."""
    monkeypatch.setattr(tloop, "drain_probe_report", _zero_flips)
    tloop.fit(RunConfig(log_path=str(tmp_path), device="cpu", **{
        **COLLAPSED, "health_thresholds": ("throughput_window=999", "warmup_intervals=6")}))
    run_dir = _run_dir(tmp_path)
    assert _alerts(run_dir) == [("flip_collapse", 0, 7, "critical")]
    (cp,) = [e for e in read_events(run_dir, "checkpoint") if e["reason"] == "forensics"]
    assert cp["step_in_epoch"] == 8 and os.path.isdir(cp["path"])
    assert read_events(run_dir, "profile") == []
    assert jtrace.find_trace_file(run_dir) is None


def test_the_monitor_runs_only_when_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "drain_probe_report", _zero_flips)
    built = []
    real = tloop.HealthMonitor
    monkeypatch.setattr(tloop, "HealthMonitor", lambda *a, **k: built.append(1) or real(*a, **k))
    for health in (True, False):
        root = tmp_path / str(health)
        tloop.fit(RunConfig(log_path=str(root), device="cpu", health=health, **COLLAPSED))
        run_dir = _run_dir(root)
        assert len(read_events(run_dir, "health")) == (1 if health else 0)
        assert len(read_events(run_dir, "alert")) == (1 if health else 0)
        assert os.path.isdir(os.path.join(run_dir, "forensics")) == health
    assert built == [1]


def test_two_ranks_save_one_aligned_forensics_checkpoint(tmp_path):
    """A real (unpatched) kurtosis divergence on a job of two gloo ranks:
    both ranks see the same drained floats and alert at the same drain;
    the checkpoint waits for the next step boundary's agreement and is
    saved once, at the same step, with ``coordinated: true``."""
    ranks = chip_smoke.spawn_ranks(
        "fit", 2, "cpu", "gloo",
        dict(log_path=str(tmp_path), arch="resnet8_tiny", dataset="cifar10", diffkurt=False,
             batch=8, steps=5, device="cpu", print_freq=1,
             health_thresholds=("kurt_divergence_abs=0", "warmup_intervals=2", "debounce=1",
                                "flip_collapse_rate=0", "throughput_window=999",
                                "loss_spike_factor=1e9")),
        timeout_s=240)
    run_dir = ranks[0]["run_dir"]
    rank1 = [e for e in read_jsonl(os.path.join(run_dir, "events.p1.jsonl"))]
    per_rank = [read_events(run_dir), rank1]
    for evs in per_rank:
        assert [(a["detector"], a["step"]) for a in evs if a["kind"] == "alert"] == \
            [("kurt_divergence", 2)]
        (cp,) = [e for e in evs if e["kind"] == "checkpoint" and e["reason"] == "forensics"]
        # the alert's drain is at step 2; the agreement at that step's
        # boundary (cursor 3) saves it on both ranks
        assert (cp["coordinated"], cp["epoch"], cp["step_in_epoch"]) == (True, 0, 3)
        assert cp["path"] == os.path.join(run_dir, "forensics", "kurt_divergence_e0_s3",
                                          ck.CKPT_NAME)
        (h,) = [e for e in evs if e["kind"] == "health"]
        assert h["by_detector"] == {"kurt_divergence": 1}
    assert os.listdir(os.path.join(run_dir, "forensics")) == ["kurt_divergence_e0_s3"]
    assert ck.verify_integrity(cp["path"]) == "ok"

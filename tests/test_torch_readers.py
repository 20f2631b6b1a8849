"""The port's run-dir readers (``bdbnn_tpu_torch/obs/summarize.py``,
``watch.py``, ``compare.py``) and its ``summarize``, ``watch``, ``compare``
and ``perf`` commands against the JAX package's, on the CPU.

On port run dirs and verdicts — a CPU train run with a profiler window, a
serve-bench run, a serve-http bench run and its verdict, a fleet verdict and
a perf run and its verdict — the port's ``summarize_run``,
``render_status`` and ``compare_runs`` equal the reference's on the same
inputs, apart from the attribution section (the port reads its
``torch.profiler`` traces, the reference finds no XLA op in them) and the
trace-derived step ms and MFU. Each of the four commands gives the
reference's exit code: ``summarize --strict`` 3 on a critical alert,
``compare`` 0 on a pass, 3 on a regression of one layer's ms and 2 on a
recipe mismatch, ``perf`` 0 (and on the port, without ``--device cpu`` and
without a card, a ``RuntimeError``). The readers load neither torch nor
numpy (``tests/test_torch_imports.py``).
"""

import copy
import json
import os
import shutil

import pytest
import torch

from bdbnn_tpu.cli import main as jcli
from bdbnn_tpu.obs import compare as jcompare
from bdbnn_tpu.obs import summarize as jsummarize
from bdbnn_tpu.obs import watch as jwatch
from bdbnn_tpu_torch.cli import main as tcli
from bdbnn_tpu_torch.obs import compare as tcompare
from bdbnn_tpu_torch.obs import summarize as tsummarize
from bdbnn_tpu_torch.obs import watch as twatch
from bdbnn_tpu_torch.obs.events import read_events
from bdbnn_tpu_torch.obs.manifest import read_manifest
from test_torch_fleet import _accounting, _fleet_block
from test_torch_serve import port_artifact  # noqa: F401  (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIT = dict(dataset="cifar10", synthetic=True, synthetic_train_size=24, synthetic_val_size=8,
           arch="resnet8_tiny", epochs=1, batch_size=8, lr=0.05, print_freq=1, seed=0,
           w_kurtosis=True, profile_at=("0:1:2",))


def _run_dir(root):
    (d,) = {r for r, _, fs in os.walk(str(root)) for f in fs if f == "events.jsonl"}
    return d


@pytest.fixture(scope="module")
def runs(port_artifact, tmp_path_factory):  # noqa: F811
    from bdbnn_tpu_torch.obs.roofline import run_perf
    from bdbnn_tpu_torch.serve import fleet as tfleet
    from bdbnn_tpu_torch.serve.config import PerfConfig, ServeBenchConfig, ServeHttpConfig
    from bdbnn_tpu_torch.serve.http import run_serve_http
    from bdbnn_tpu_torch.serve.loadgen import run_serve_bench
    from bdbnn_tpu_torch.train import loop as tloop
    from bdbnn_tpu_torch.train.config import RunConfig

    d = tmp_path_factory.mktemp("readers")
    tloop.fit(RunConfig(log_path=str(d / "train"), device="cpu", **FIT))
    run_serve_bench(ServeBenchConfig(artifact=port_artifact, log_path=str(d / "bench"),
                                     mode="closed", requests=16, concurrency=4, buckets=(1, 4),
                                     queue_depth=16, max_delay_ms=2.0, seed=0, device="cpu"))
    run_serve_http(ServeHttpConfig(artifact=port_artifact, log_path=str(d / "http"),
                                   buckets=(1, 4), priorities=3, queue_depth=8, max_delay_ms=2.0,
                                   scenario="poisson", rate=150.0, requests=40, concurrency=8,
                                   seed=0, default_quota="1000:1000", stats_interval_s=0.2,
                                   device="cpu"))
    perf = run_perf(PerfConfig(artifact=port_artifact, log_path=str(d / "perf"), buckets=(1, 2),
                               impls=("dense", "popcount"), iters=1, device="cpu"))
    client = {"submitted": 82, "responses": 82, "dropped": 0,
              "by_status": {"200": 77, "429": 1, "503": 4}, "wall_s": 1.8}
    fleet = tfleet.fleet_slo_verdict(
        _accounting(), _fleet_block(), scenario="flash_crowd", rate=50.0, seed=3, client=client,
        slo_p99_ms=10.0, provenance={"hosts": ["a:1", "b:2"], "artifact": port_artifact,
                                     "config_hash": None, "recipe": {}, "serve_config_hash": "a"},
        drained_clean=True)
    out = {"train": _run_dir(d / "train"), "bench": _run_dir(d / "bench"),
           "http": _run_dir(d / "http"), "perf": perf["run_dir"]}
    out["http_verdict"] = os.path.join(out["http"], "verdict.json")
    out["perf_verdict"] = os.path.join(out["perf"], "perf_verdict.json")
    out["fleet_verdict"] = str(d / "fleet.json")
    with open(out["fleet_verdict"], "w") as f:
        json.dump(fleet, f)
    out["root"] = d
    return out


def _without_attribution(report):
    """The report's lines outside the attribution section (its header,
    its category rows, the step total, MFU and host-phase lines)."""
    out, inside = [], False
    for line in report.splitlines():
        if line.startswith("device attribution"):
            inside = True
            continue
        if line.startswith("host phases in window") or (inside and line.startswith("  ")):
            continue
        inside = False
        out.append(line)
    return out


@pytest.mark.parametrize("name", ["train", "bench", "http", "perf"])
def test_summarize_is_the_references(runs, name):
    got_report, got = tsummarize.summarize_run(runs[name])
    want_report, want = jsummarize.summarize_run(runs[name])
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "attribution"} == {
        k: v for k, v in want.items() if k != "attribution"}
    assert _without_attribution(got_report) == _without_attribution(want_report)
    if name == "train":
        cats = got["attribution"]["categories_ms_per_step"]
        assert {"binarize", "binary_conv", "bn_act", "kurtosis_loss", "optimizer"} <= set(cats)
        assert got["attribution"]["mfu"] is None  # no peak for this CPU
        assert "device attribution" in got_report and "binary_conv" in got_report


@pytest.mark.parametrize("name", ["train", "bench", "http", "perf"])
def test_render_status_is_the_references(runs, name):
    events, manifest = read_events(runs[name]), read_manifest(runs[name])
    assert twatch.render_status(events, manifest) == jwatch.render_status(events, manifest)


_TRACE_METRICS = ("jit_step_ms", "mfu")


def _compare(mod, paths, **kw):
    """compare_runs without the trace-derived metrics."""
    out = copy.deepcopy(mod.compare_runs(paths, **kw))
    for k in _TRACE_METRICS:
        out["baseline"]["metrics"].pop(k, None)
    for c in out["comparisons"]:
        c["metrics"] = [m for m in c["metrics"] if m.get("metric") not in _TRACE_METRICS]
    return out


@pytest.fixture(scope="module")
def doctored(runs):
    """The perf verdict with one layer's ms doubled, and with another arch."""
    v = json.load(open(runs["perf_verdict"]))
    slow = copy.deepcopy(v)
    key = sorted(slow["perf_layers"])[0]
    slow["perf_layers"][key] *= 2.0
    other = copy.deepcopy(v)
    other["arch"] = other["provenance"]["recipe"]["arch"] = "resnet20"
    paths = {"slow": str(runs["root"] / "slow.json"), "other": str(runs["root"] / "other.json")}
    for k, doc in (("slow", slow), ("other", other)):
        with open(paths[k], "w") as f:
            json.dump(doc, f)
    return paths


@pytest.mark.parametrize("pair", ["train", "bench", "http_verdict", "fleet_verdict",
                                  "perf_verdict", "perf_slow", "perf_other"])
def test_compare_is_the_references(runs, doctored, pair):
    if pair.startswith("perf_") and pair != "perf_verdict":
        paths = [runs["perf_verdict"], doctored[pair[5:]]]
    else:
        paths = [runs[pair], runs[pair]]
    got, want = _compare(tcompare, paths), _compare(jcompare, paths)
    assert got == want
    assert tcompare.render_comparison(tcompare.compare_runs(paths)).splitlines()[0] == \
        jcompare.render_comparison(jcompare.compare_runs(paths)).splitlines()[0]
    assert got["verdict"] == {"perf_slow": "regression", "perf_other": "incomparable"}.get(
        pair, "pass")


def test_a_train_run_compares_on_its_trace_step_ms(runs):
    rec = tcompare.extract_run(runs["train"])
    att = tsummarize.summarize_run(runs["train"])[1]["attribution"]
    assert rec["metrics"]["jit_step_ms"] == att["step_total_ms"] > 0
    assert jcompare.extract_run(runs["train"])["metrics"]["jit_step_ms"] is None


def _codes(argv_t, argv_j, capsys):
    got, want = tcli(argv_t), jcli(argv_j)
    capsys.readouterr()
    return got, want


def test_cli_exit_codes_are_the_references(runs, doctored, tmp_path, capsys,
                                           port_artifact):  # noqa: F811
    # a copy of the train run with a run-ending alert
    crit = str(tmp_path / "crit")
    shutil.copytree(runs["train"], crit)
    with open(os.path.join(crit, "events.jsonl"), "a") as f:
        f.write(json.dumps({"t": 1.0, "kind": "alert", "detector": "nonfinite_loss",
                            "severity": "critical", "epoch": 0, "step": 1, "value": None,
                            "threshold": None, "message": "loss went non-finite"}) + "\n")
    cases = [
        ["summarize", runs["train"]],
        ["summarize", runs["train"], "--json", "--strict"],
        ["summarize", crit, "--strict"],
        ["watch", runs["train"], "--once"],
        ["watch", runs["perf"], "--once"],
        ["compare", runs["perf_verdict"], runs["perf_verdict"]],
        ["compare", runs["perf_verdict"], doctored["slow"], "--json"],
        ["compare", runs["perf_verdict"], doctored["other"]],
        ["compare", runs["perf_verdict"], doctored["other"], "--allow-mismatch"],
        ["compare", runs["fleet_verdict"], runs["fleet_verdict"]],
    ]
    expected = [0, 0, 3, 0, 0, 0, 3, 2, 0, 0]
    codes = [_codes(argv, argv, capsys) for argv in cases]
    assert [g for g, _ in codes] == [w for _, w in codes] == expected
    perf = ["perf", port_artifact, "--static-only", "--buckets", "1", "4"]
    got, want = _codes(perf + ["--device", "cpu", "--log-path", str(tmp_path / "p")],
                       perf + ["--log-path", str(tmp_path / "j")], capsys)
    assert got == want == 0
    with pytest.raises(SystemExit) as e:
        tcli(["compare", runs["perf_verdict"]])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli(perf + ["--log-path", str(tmp_path / "nocard")])

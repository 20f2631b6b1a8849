"""The port's bench scripts (``bdbnn_tpu_torch/scripts/``) and the trace
helpers they read, against the reference's root scripts, on the CPU:

- ``step_device_ms`` and ``kernel_breakdown`` (``obs/trace.py``) on a
  hand-built kineto trace give exact values (ops joined to the step whose
  range was open at their launch, a backward launched from the autograd
  thread included, launches outside every step left out); on the same
  durations in each package's trace format they agree with the
  reference's ``jit_step_ms`` and ``hlo_breakdown`` to 1e-9 ms;
- the bench's ``StepConfig``, optimizer arguments, inputs and schedule
  scalars are the ones ``bench.py`` ``_build_step`` builds, field by
  field (the reference's builder run with its model's init traced
  abstractly);
- one step of the bench's builder on ``resnet8_tiny`` in f32 against the
  JAX ``make_train_step`` with that config on bridged weights: the loss
  and the kurtosis term to rtol 1e-5, every gradient to 1e-3 of its
  tensor's largest |entry| (ROADMAP C, "Whole-step gradients");
- the flagship's train FLOPs, 10.648 GFLOP/image on the ``meta`` device,
  within 10% of the reference's XLA count of 10.02;
- the worker's line has the reference's keys plus ``flops_source`` and
  ``device_extent_ms_per_step``, lands as ``bench_result`` events, and the
  port's ``compare`` reads it; without a card the CLI prints the failure
  keys and exits non-zero;
- the kernel bench's rows carry the reference's keys at batch 1 on its
  seven shapes (the reference's ``SHAPES``), and the pipeline
  bench writes the reference's JPEG bytes and its result keys with the
  ``TFDATA_UNPORTED`` row.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import write_synthetic_trace
from test_torch_models import _seeded_tree

import bench as ref_bench
import bench_kernels as ref_bench_kernels
import bench_pipeline as ref_bench_pipeline
import bdbnn_tpu.models as jmodels
import bdbnn_tpu.train as jtrain
from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.obs import trace as jtrace
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train import make_train_step as jax_make_train_step
from bdbnn_tpu.train.step import _regularization_terms
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.models import conv_weight_paths
from bdbnn_tpu_torch.nn.layers import _BinaryConvBase
from bdbnn_tpu_torch.obs import trace as ttrace
from bdbnn_tpu_torch.obs.compare import extract_run
from bdbnn_tpu_torch.scripts import bench as tbench
from bdbnn_tpu_torch.scripts import bench_kernels as tbench_kernels
from bdbnn_tpu_torch.scripts import bench_pipeline as tbench_pipeline
from bdbnn_tpu_torch.train import optim as toptim
from bdbnn_tpu_torch.train.config import TFDATA_UNPORTED
from bdbnn_tpu_torch.train.loop import shape_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a gradient's tolerance, of its tensor's largest |entry| (ROADMAP C)
GRAD_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# trace helpers on hand-built kineto traces
# ---------------------------------------------------------------------------

HOST, MAIN, BWD = 100, 1, 2  # host pid, the python thread, the autograd thread


class Trace:
    """A kineto-shaped event list: host ranges, launches and device ops
    with their own start times."""

    def __init__(self):
        self.events = [
            {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0, "args": {"name": "python"}},
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        ]
        self.corr = 0

    def span(self, name, ts, dur, tid=MAIN):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": HOST,
                            "tid": tid, "ts": ts, "dur": dur, "args": {}})

    def kernel(self, name, launch_ts, start, dur, tid=MAIN, stream=7, cat="kernel",
               launched=True):
        self.corr += 1
        if launched:
            self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                                "pid": HOST, "tid": tid, "ts": launch_ts, "dur": 2.0,
                                "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
                            "ts": start, "dur": dur,
                            "args": {"correlation": self.corr, "stream": stream}})


def test_step_device_ms_joins_ops_to_the_step_open_at_their_launch():
    tr = Trace()
    tr.kernel("absorb", -50, 900, 5)  # launched before any step
    for t0 in (0, 200, 400):
        tr.span("train_step", t0, 100)
    tr.span("data_wait", 100, 100)
    # step 0: two kernels, and a backward launched from the autograd thread
    tr.kernel("fwd.1", 10, 1000, 100)
    tr.kernel("fwd.2", 20, 1100, 50)
    tr.kernel("bwd", 60, 1200, 30, tid=BWD)
    tr.kernel("between", 150, 1290, 5)  # launched between two steps
    # step 1: two kernels on two streams overlapping
    tr.kernel("gemm", 210, 1300, 200)
    tr.kernel("gemm", 250, 1350, 100, stream=13)
    # step 2: a kernel and a copy; a device op whose launch the trace lacks
    tr.kernel("adam", 410, 1600, 40)
    tr.kernel("copy", 420, 1700, 60, cat="gpu_memcpy")
    tr.kernel("orphan", 430, 1800, 70, launched=False)
    got = ttrace.step_device_ms(tr.events)
    assert got["n_steps"] == 3
    assert got["extent_ms"] == pytest.approx([0.23, 0.2, 0.16], abs=1e-12)
    assert got["busy_ms"] == pytest.approx([0.18, 0.3, 0.1], abs=1e-12)
    assert got["ms"] == pytest.approx(0.2, abs=1e-12)  # the middle of three
    assert got["busy_median_ms"] == pytest.approx(0.18, abs=1e-12)
    assert ttrace.step_device_ms(tr.events, prefix="jit_train_step") is None
    assert ttrace.step_device_ms(Trace().events) is None


def test_kernel_breakdown_groups_by_name_with_a_top_and_other():
    tr = Trace()
    tr.kernel("fusion.1", 0, 0, 300)
    tr.kernel("fusion.22", 1, 400, 100)
    tr.kernel("gemm", 2, 600, 200)
    tr.kernel("copy", 3, 900, 50, cat="gpu_memcpy")
    tr.kernel("set", 4, 1000, 10, cat="gpu_memset")
    groups, total = ttrace.kernel_breakdown(tr.events, 2)
    assert groups == {"fusion": 0.2, "gemm": 0.1, "copy": 0.025, "set": 0.005}
    assert total == pytest.approx(0.33, abs=1e-12)
    groups, _ = ttrace.kernel_breakdown(tr.events, 2, top=1)
    assert groups == {"fusion": 0.2, "other": 0.13}
    assert ttrace.kernel_breakdown(Trace().events, 5) == ({}, None)


def _kineto_twin_of_the_synthetic_trace(n_steps=5):
    """The durations of conftest's ``write_synthetic_trace`` (ms/step:
    fusion 4.0, convolution 4.0, reduce 2.0; a 10 ms step) as a kineto
    trace: each step a ``train_step`` range, its six ops launched inside
    it and run back to back on the card."""
    tr = Trace()
    t = 0
    for _ in range(n_steps):
        tr.span("train_step", t, 10_000)
        start = t
        for i, (dur, name) in enumerate(((1_000, "fusion.1"), (4_000, "convolution.2"),
                                         (1_500, "fusion.3"), (2_000, "reduce.4"),
                                         (500, "fusion.5"), (1_000, "fusion.77"))):
            tr.kernel(name, t + 1 + i, start, dur)
            start += dur
        t += 12_000
    return tr.events


def test_the_helpers_agree_with_the_references_on_the_same_durations(tmp_path):
    ref = write_synthetic_trace(str(tmp_path / "t.trace.json.gz"), n_steps=5)
    ours = _kineto_twin_of_the_synthetic_trace(5)
    assert jtrace.jit_step_ms(ref) == pytest.approx(10.0)
    got = ttrace.step_device_ms(ours)
    assert got["ms"] == pytest.approx(jtrace.jit_step_ms(ref), abs=1e-9)
    assert got["busy_ms"] == pytest.approx([10.0] * 5, abs=1e-9)
    ref_groups, ref_total = jtrace.hlo_breakdown(ref, 5)
    groups, total = ttrace.kernel_breakdown(ours, 5)
    assert groups == ref_groups == {"convolution": 4.0, "fusion": 4.0, "reduce": 2.0}
    assert total == pytest.approx(ref_total, abs=1e-9)


# ---------------------------------------------------------------------------
# the bench's step against bench.py's
# ---------------------------------------------------------------------------


def _reference_build(monkeypatch):
    """``bench._build_step("float32", 1)`` with what it passes to
    ``StepConfig``, ``make_optimizer`` and ``create_model`` recorded; the
    model's init is traced abstractly (its shapes are what the config
    reads) and no train state is made."""
    rec = {}
    real_cfg, real_opt, real_create = jtrain.StepConfig, jtrain.make_optimizer, jmodels.create_model

    class Abstract:
        def __init__(self, model):
            self.model = model

        def init(self, *a, **kw):
            return jax.eval_shape(lambda: self.model.init(*a, **kw))

    def create(*a, **kw):
        rec["model"] = (a, kw)
        return Abstract(real_create(*a, **kw))

    def cfg(**kw):
        rec["cfg"] = real_cfg(**kw)
        return rec["cfg"]

    def opt(params, **kw):
        rec["opt"] = kw
        return real_opt(params, **kw)

    monkeypatch.setattr(jtrain, "StepConfig", cfg)
    monkeypatch.setattr(jtrain, "make_optimizer", opt)
    monkeypatch.setattr(jmodels, "create_model", create)
    monkeypatch.setattr(jtrain.TrainState, "create", classmethod(lambda cls, v, tx: None))
    _, _, (x, y), tk, gate = ref_bench._build_step("float32", 1)
    return rec, np.asarray(x), np.asarray(y), tuple(float(v) for v in tk), float(gate)


def test_step_config_optimizer_and_inputs_are_bench_pys(monkeypatch):
    rec, x_ref, y_ref, tk_ref, gate_ref = _reference_build(monkeypatch)
    seen = {}
    real_opt = toptim.make_optimizer

    def opt(model, **kw):
        seen["opt"] = kw
        return real_opt(model, **kw)

    monkeypatch.setattr(toptim, "make_optimizer", opt)
    step, state, (x, y), tk, gate = tbench.build_step("float32", 1, device="cpu")
    ours = tbench.bench_step_config(conv_weight_paths(shape_tree(state.model))[1:])
    assert rec["model"] == (("resnet18", "imagenet"), {"dtype": "float32"})
    ref_cfg = rec["cfg"]
    for f in dataclasses.fields(ref_cfg):
        assert getattr(ours, f.name) == getattr(ref_cfg, f.name), f.name
    assert len(ours.kurt_paths) == 19 and ours.kurt_paths[0] == ("layer1_0", "conv1",
                                                                 "float_weight")
    assert seen["opt"] == rec["opt"] == {"dataset": "imagenet", "lr": 1e-3, "epochs": 90,
                                         "steps_per_epoch": 1000}
    assert state.optimizer.policy == "adam-linear"
    assert np.array_equal(x.numpy(), x_ref) and x.dtype == torch.float32
    assert np.array_equal(y.numpy(), y_ref)
    assert tuple(tk) == tk_ref and gate == gate_ref


def _min_presign_margin(model, x):
    """Smallest non-zero |x - shift| a binary conv of one train-mode
    forward sees (the model's state restored after)."""
    margins = []

    def hook(mod, args):
        v = args[0] - mod.act_shift if getattr(mod, "has_shift", False) else args[0]
        a = v.detach().abs()
        margins.append(float(a[a > 0].min()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, _BinaryConvBase)]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        model.train()(x)
    finally:
        for h in handles:
            h.remove()
        model.load_state_dict(saved)
    return min(margins)


def test_one_step_of_the_builder_matches_make_train_step():
    step, state, (x, y), tk, gate = tbench.build_step(
        "float32", 8, arch="resnet8_tiny", dataset="cifar10", image_size=16, device="cpu")
    port = state.model
    jmodel = jreg.create_model("resnet8_tiny", "cifar10")
    # the models' seeded weights (non-trivial BN statistics and shifts,
    # tests/test_torch_models.py) into the step's model, in place, so its
    # optimizer holds them; no pre-sign value then lies within 1e-5 of its
    # threshold, so an ulp between the frameworks' float parts flips none
    tree = _seeded_tree(jmodel, (16, 16, 3), 0)
    port.from_flax(tree)
    assert _min_presign_margin(port, x) > 1e-5
    hooked = tuple(jres.conv_weight_paths(tree["params"])[1:])
    jcfg = JStepConfig(w_kurtosis=True, kurt_paths=hooked, kurt_targets=(1.8,) * len(hooked),
                       kurtosis_mode="avg", w_lambda_kurtosis=1.0)
    tx = jax_make_optimizer(tree["params"], dataset="imagenet", lr=1e-3, epochs=90,
                            steps_per_epoch=1000)
    xn, yn = x.numpy(), y.numpy().astype(np.int32)
    one = jnp.float32(1.0)
    _, jm = jax.jit(jax_make_train_step(jmodel, tx, jcfg))(
        JTrainState.create(tree, tx), (jnp.asarray(xn), jnp.asarray(yn)), (one, one), one)
    state, tm = step(state, (x, y), tk, gate)
    jm = jax.device_get(jm)
    np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss_kurt"]), jm["loss_kurt"], rtol=1e-5)

    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                 jnp.asarray(xn), train=True, mutable=["batch_stats"])
        reg, _ = _regularization_terms(params, jcfg, one)
        return jax_ce(logits, jnp.asarray(yn)) + reg

    jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(tree["params"]))
    ref_g = flax_to_state_dict({"params": jgrads, "batch_stats": tree["batch_stats"]})
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert grads and set(grads) <= set(ref_g)
    for name, g in grads.items():
        want = ref_g[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


def test_the_flagship_train_flops_per_image():
    per_image = tbench.train_flops_per_step("resnet18", "imagenet", 128) / 128 / 1e9
    assert per_image == pytest.approx(10.648, abs=5e-4)
    with open(os.path.join(REPO, "profiles", "r04", "PROFILE_r04.json")) as f:
        xla = json.load(f)["gflops_per_image"]
    assert xla == 10.02
    assert abs(per_image - xla) / xla < 0.10


# the keys of bench.py's line (its worker's ``emit`` with every stage)
REFERENCE_LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "dtype", "conv_impl", "impl_rates", "batch",
    "n_chips", "platform", "device_kind", "bf16_peak_tflops", "fencing", "flops_per_step",
    "gflops_per_image", "achieved_tflops", "mfu", "timing_suspect", "device_ms_per_step",
    "device_images_per_sec", "device_mfu", "profile_trace", "f32_images_per_sec_per_chip",
    "bf16_speedup_vs_f32",
}


def test_reference_line_keys_are_bench_pys():
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    assert all(f'"{k}"' in src for k in REFERENCE_LINE_KEYS)


def test_the_worker_line_events_and_compare(tmp_path, monkeypatch):
    # a peak for the CPU so the MFU keys appear, as they do on a card
    monkeypatch.setitem(tbench.BF16_PEAK_TFLOPS, "cpu", 1.0)
    prof = tmp_path / "prof"
    args = tbench.parse_args(["--worker", "--batch", "4", "--iters", "1", "--device", "cpu",
                              "--profile-dir", str(prof)])
    out = io.StringIO()
    with redirect_stdout(out):
        tbench.worker_main(args, arch="resnet8_tiny", dataset="cifar10", image_size=16)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    line, launches = lines[-1], lines[-2]["launches"]
    assert set(line) == REFERENCE_LINE_KEYS | {"flops_source", "device_extent_ms_per_step"}
    assert line["value"] > 0 and line["n_chips"] == 1 and line["conv_impl"] == "kernels"
    assert set(line["impl_rates"]) == {"kernels"} and line["timing_suspect"] is False
    assert line["device_ms_per_step"] > 0 and line["platform"] == "cpu"
    assert line["flops_per_step"] == tbench.train_flops_per_step("resnet8_tiny", "cifar10", 4, 16)
    # 3 warm steps, 5 windows of 1, the 5 traced; then 3 + 5 in f32; the
    # CPU runs the plain versions, which launch nothing
    assert launches["bf16"]["steps"] == 13 and launches["f32"]["steps"] == 8
    assert all(v == 0 for stage in launches.values() for k, v in stage.items() if k != "steps")
    events = [json.loads(ln) for ln in open(prof / "events.jsonl")]
    assert [e["kind"] for e in events] == ["bench_result"] * 3  # after each stage
    assert {k: v for k, v in events[-1].items() if k not in ("t", "kind")} == line
    path = tmp_path / "BENCH.json"
    path.write_text(json.dumps({"parsed": line}))
    run = extract_run(str(path))
    assert run["format"] == "bench_artifact"
    assert run["metrics"]["img_per_s"] == line["value"]
    assert run["metrics"]["jit_step_ms"] == line["device_ms_per_step"]
    assert run["metrics"]["mfu"] == line["device_mfu"]


def test_without_a_card_the_cli_fails_and_falls_back_to_nothing():
    if torch.cuda.is_available():
        pytest.skip("checks the failure on a machine without a CUDA card")
    r = subprocess.run([sys.executable, "-m", "bdbnn_tpu_torch.scripts.bench", "--attempts", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0 and "error" in line
    assert not [k for k in line if k.startswith("prior_")]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}


# ---------------------------------------------------------------------------
# the kernel and pipeline benches
# ---------------------------------------------------------------------------


def test_kernel_bench_shapes_and_rows_are_the_references():
    assert tbench_kernels.SHAPES == ref_bench_kernels.SHAPES
    out = io.StringIO()
    with redirect_stdout(out):
        summary = tbench_kernels.main(batch=1, iters=1, device="cpu")
    rows = summary["results"]
    assert [(r["shape"], r["impl"]) for r in rows] == [
        (s[0], impl) for s in tbench_kernels.SHAPES for impl in ("dot_f32", "dot_bf16")]
    for r in rows:
        assert {"shape", "impl", "images_per_sec", "ms_per_call"} <= set(r) and "error" not in r
        assert r["k1_graph_ms"] is None and r["conv2d_ms"] is None  # no card
    assert {"summary", "totals_ms", "winner", "platform", "batch", "fencing",
            "results"} <= set(summary)
    assert summary["platform"] == "cpu" and set(summary["totals_ms"]) == {"dot_f32", "dot_bf16"}


def test_make_jpeg_folder_writes_the_references_bytes(tmp_path):
    a = ref_bench_pipeline.make_jpeg_folder(str(tmp_path / "ref"), n_images=6, hw=32)
    b = tbench_pipeline.make_jpeg_folder(str(tmp_path / "port"), n_images=6, hw=32)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 6
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_pipeline_bench_keys_and_the_tfdata_row():
    out = io.StringIO()
    with redirect_stdout(out):
        res = tbench_pipeline.main(["--images", "32", "--batch", "8", "--batches", "1"])
    assert set(res) == {"what", "host_cpu_count", "batch_size", "threads_img_per_sec",
                        "processes_img_per_sec", "device_img_per_sec_target",
                        "per_worker_img_per_sec", "workers_to_saturate_device", "note",
                        "tfdata_error"}
    assert res["tfdata_error"] == TFDATA_UNPORTED
    assert set(res["threads_img_per_sec"]) == {"1", "2", "4"}
    assert set(res["processes_img_per_sec"]) == {"1", "2", "4", "8"}
    assert all(v > 0 for v in [*res["threads_img_per_sec"].values(),
                               *res["processes_img_per_sec"].values()])
    assert res["device_img_per_sec_target"] is None and res["workers_to_saturate_device"] is None
    assert tbench_pipeline.parse_args([]).out == ""  # no file unless asked


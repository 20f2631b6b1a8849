"""The port's trace attribution (``bdbnn_tpu_torch/obs/trace.py``) against
the JAX package's, on the CPU.

- The tables (``DEVICE_SPANS``, ``HOST_PHASES``) are the reference's; the
  peak table holds the H100's dense bf16 rows and no TPU row.
- On hand-built kineto event lists, ``attribute_trace`` and
  ``attribute_trace_layers`` give exact categories and layers: kernels on
  two streams joined to their launches by correlation id, nested spans
  (the innermost category wins, the longest layer scope wins), a backward
  launched on the autograd thread joined to its forward by ``Sequence
  number``, a host phase enclosing a span, a kernel in no span, a CPU
  trace counted by self time; ``lost_device_records`` counts the launches
  whose device record a trace lacks.
- Real CPU traces of ``fit --profile-at`` on ``resnet8_tiny``, both
  packages on one config and window: the categories with nonzero time are
  the same set (the reference's CPU ops joined to their scopes through the
  compiled step's HLO, as its ``run_perf`` joins them).
- A span is a free nullcontext outside a window and a
  ``record_function`` range inside one; ``InferenceEngine.trace_step``
  opens the window, writes the trace where ``find_trace_file`` looks and
  charges every conv's ops to its own layer.
"""

import gzip
import json
import os
import re

import pytest
import torch

from bdbnn_tpu.obs import trace as jtrace
from bdbnn_tpu_torch.obs import trace as ttrace


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tables_are_the_references():
    assert ttrace.DEVICE_SPANS == jtrace.DEVICE_SPANS
    assert ttrace.HOST_PHASES == jtrace.HOST_PHASES
    assert ttrace.BF16_PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.4, "NVIDIA H100 PCIe": 756.0}
    assert not any("TPU" in k for k in ttrace.BF16_PEAK_TFLOPS)


# ---------------------------------------------------------------------------
# hand-built kineto traces
# ---------------------------------------------------------------------------

HOST, MAIN, BWD = 100, 1, 2  # host pid, the python thread, the autograd thread


class Trace:
    """A kineto-shaped event list under construction."""

    def __init__(self):
        self.events = [
            {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0, "args": {"name": "python"}},
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        ]
        self.corr = 0

    def span(self, name, ts, dur, tid=MAIN):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": HOST,
                            "tid": tid, "ts": ts, "dur": dur, "args": {}})

    def cpu_op(self, name, ts, dur, tid=MAIN, **args):
        self.events.append({"ph": "X", "cat": "cpu_op", "name": name, "pid": HOST, "tid": tid,
                            "ts": ts, "dur": dur, "args": dict(args)})

    def kernel(self, name, launch_ts, dur, tid=MAIN, stream=7, cat="kernel", launched=True):
        self.corr += 1
        if launched:
            self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                                "pid": HOST, "tid": tid, "ts": launch_ts, "dur": 2.0,
                                "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
                            "ts": launch_ts + 50.0, "dur": dur,
                            "args": {"correlation": self.corr, "stream": stream}})


LAYERS = {"conv1": "conv1", "layer1_0.conv1": "layer1_0/conv1", "fc": "fc"}


def _attr(tr, steps=1):
    return (ttrace.attribute_trace(tr.events, steps),
            ttrace.attribute_trace_layers(tr.events, steps, layers=LAYERS))


def test_kernels_on_two_streams_join_their_launches():
    tr = Trace()
    tr.span("layer1_0/conv1", 0, 100)
    tr.span("binary_conv", 10, 80)
    tr.kernel("binary_conv_fwd_kernel", 20, 300.0, stream=7)
    tr.kernel("fwd_sign_prep_kernel", 30, 100.0, stream=13)
    tr.kernel("gemm", 200, 50.0, stream=13)  # launched after the spans closed
    cats, layers = _attr(tr)
    assert cats["categories_ms_per_step"] == {"binary_conv": 0.4, "unattributed": 0.05}
    assert cats["step_total_ms"] == 0.45
    assert layers == {"n_steps": 1, "layers": {"layer1_0.conv1": 0.4}, "unattributed": 0.05,
                      "total_ms": 0.45}


def test_nested_spans_innermost_category_longest_layer():
    tr = Trace()
    tr.span("layer1_0/conv1", 0, 100)
    tr.span("binarize", 5, 50)
    tr.span("unpack", 6, 20)
    tr.kernel("unpack_sign_kernel", 7, 10.0)
    tr.kernel("weight_sign_kernel", 30, 20.0)
    tr.span("binary_conv", 60, 30)
    tr.kernel("binary_conv_fwd_kernel", 61, 40.0)
    tr.span("conv1", 200, 20)  # the stem: its own layer, no category
    tr.kernel("cudnn_conv", 201, 60.0)
    tr.span("fc", 300, 20)
    tr.kernel("gemv", 301, 6.0, cat="gpu_memcpy")
    cats, layers = _attr(tr)
    assert cats["categories_ms_per_step"] == {"unattributed": 0.066, "binary_conv": 0.04,
                                              "binarize": 0.03}
    assert layers["layers"] == {"layer1_0.conv1": 0.07, "conv1": 0.06, "fc": 0.006}
    assert layers["unattributed"] == 0.0


def test_a_backward_joins_its_forward_by_sequence_number():
    tr = Trace()
    tr.span("dispatch", 0, 1000)
    tr.span("bn_act", 10, 20)
    tr.cpu_op("aten::add", 11, 5, **{"Sequence number": 41, "Fwd thread id": 0})
    tr.span("layer1_0/conv1", 40, 20)
    tr.span("binary_conv", 41, 10)
    tr.cpu_op("BinaryConvFn", 42, 5, **{"Sequence number": 42, "Fwd thread id": 0})
    # the autograd thread: AddBackward0 launches outside every span;
    # BinaryConvFnBackward opens its own binary_conv span
    tr.cpu_op("autograd::engine::evaluate_function: AddBackward0", 500, 20, tid=BWD,
              **{"Sequence number": 41, "Fwd thread id": 1})
    tr.kernel("add_bwd", 505, 8.0, tid=BWD)
    tr.cpu_op("autograd::engine::evaluate_function: BinaryConvFnBackward", 600, 50, tid=BWD,
              **{"Sequence number": 42, "Fwd thread id": 1})
    tr.span("binary_conv", 601, 40, tid=BWD)
    tr.kernel("binary_conv_dgrad_kernel", 602, 30.0, tid=BWD)
    tr.kernel("binary_conv_wgrad_kernel", 610, 20.0, tid=BWD)
    tr.kernel("copy", 700, 4.0, tid=BWD, cat="gpu_memset")  # no evaluate_function around it
    ops = {o["name"]: o["path"] for o in ttrace.scoped_device_ops(tr.events)}
    assert ops == {"add_bwd": "dispatch/bn_act",
                   "binary_conv_dgrad_kernel": "dispatch/layer1_0/conv1/binary_conv/binary_conv",
                   "binary_conv_wgrad_kernel": "dispatch/layer1_0/conv1/binary_conv/binary_conv",
                   "copy": ""}
    cats, layers = _attr(tr)
    assert cats["categories_ms_per_step"] == {"binary_conv": 0.05, "bn_act": 0.008,
                                              "unattributed": 0.004}
    assert layers["layers"] == {"layer1_0.conv1": 0.05}


def test_a_host_phase_encloses_spans_but_is_never_one():
    tr = Trace()
    tr.span("data_wait", 0, 40)
    tr.span("dispatch", 50, 1000)
    tr.span("bn_act", 60, 10)
    tr.kernel("bn_kernel", 61, 12.0)
    tr.kernel("loose_kernel", 200, 30.0)
    tr.span("data_wait", 1100, 60)
    tr.span("dispatch", 1200, 1000)
    tr.span("optimizer", 1300, 10)
    tr.kernel("adam", 1301, 8.0)
    cats, _ = _attr(tr, steps=2)
    assert cats["categories_ms_per_step"] == {"unattributed": 0.015, "bn_act": 0.006,
                                              "optimizer": 0.004}
    assert cats["host_phases_ms_per_step"] == {"data_wait": 0.05, "dispatch": 1.0}
    assert cats["step_total_ms"] == 0.025


def test_lost_device_records_count_launches_without_a_device_record():
    tr = Trace()
    tr.kernel("k", 0, 5.0)
    tr.kernel("copy", 10, 5.0, cat="gpu_memcpy")
    assert ttrace.lost_device_records(tr.events) == 0
    for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernel", "cudaStreamSynchronize"):
        tr.events.append({"ph": "X", "cat": "cuda_runtime" if name[:4] == "cuda" else "cuda_driver",
                          "name": name, "pid": HOST, "tid": MAIN, "ts": 100.0, "dur": 1.0,
                          "args": {"correlation": 1000 + len(tr.events)}})
    assert ttrace.lost_device_records(tr.events) == 3  # a synchronize has no device record
    cpu = Trace()
    cpu.cpu_op("aten::mm", 0, 10)
    assert ttrace.lost_device_records(cpu.events) == 0


def test_a_kernel_in_no_span_and_a_lost_launch_are_unattributed():
    tr = Trace()
    tr.kernel("memcpy_htod", 0, 20.0, cat="gpu_memcpy")
    tr.span("layer1_0/conv1", 100, 50)
    tr.kernel("orphan", 110, 10.0, launched=False)
    cats, layers = _attr(tr)
    assert cats["categories_ms_per_step"] == {"unattributed": 0.03}
    assert layers == {"n_steps": 1, "layers": {}, "unattributed": 0.03, "total_ms": 0.03}


def test_a_cpu_trace_counts_each_op_by_its_self_time():
    """No GPU activity: every cpu_op is a device op by its duration less its
    children's, so conv2d > convolution > mkldnn count once, and an mm that
    calls a small op keeps its own time."""
    tr = Trace()
    tr.span("layer1_0/conv1", 0, 500)
    tr.span("binary_conv", 1, 400)
    tr.cpu_op("aten::conv2d", 10, 100)
    tr.cpu_op("aten::convolution", 12, 90)
    tr.cpu_op("aten::mkldnn_convolution", 15, 80)
    tr.cpu_op("aten::mm", 200, 100)
    tr.cpu_op("aten::empty", 201, 1)
    cats, layers = _attr(tr)
    assert cats["categories_ms_per_step"] == {"binary_conv": 0.2}
    assert layers["layers"] == {"layer1_0.conv1": 0.2}


def test_flops_give_mfu_against_the_peak():
    tr = Trace()
    tr.span("binary_conv", 0, 100)
    tr.kernel("k", 1, 1000.0)
    out = ttrace.attribute_trace(tr.events, 1, flops_per_step=989.4e9,
                                 peak_tflops=ttrace.BF16_PEAK_TFLOPS["NVIDIA H100 80GB HBM3"])
    assert out["mfu"] == 1.0 and out["step_total_ms"] == 1.0
    assert set(out) == set(jtrace.attribute_trace([], 1))


def test_load_and_find_are_the_references(tmp_path):
    tr = Trace()
    tr.kernel("k", 0, 5.0)
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "h.1.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": tr.events}, f)
    assert ttrace.find_trace_file(str(tmp_path)) == jtrace.find_trace_file(str(tmp_path))
    path = ttrace.find_trace_file(str(tmp_path))
    assert ttrace.load_trace_events(path) == jtrace.load_trace_events(path) == tr.events


# ---------------------------------------------------------------------------
# spans and the engine's trace window
# ---------------------------------------------------------------------------


def test_spans_are_free_outside_a_window(tmp_path):
    assert not ttrace.spans_recording()
    assert ttrace.span("binarize") is ttrace.span("bn_act")
    cap = ttrace.TraceCapture(str(tmp_path), [(0, 0, 1)])
    assert cap.maybe_start(0, 0) and ttrace.spans_recording()
    with ttrace.span("binarize"):
        torch.ones(4).add_(1)
    cap.stop_if_active()
    assert not ttrace.spans_recording()
    evs = ttrace.load_trace_events(ttrace.find_trace_file(str(tmp_path)))
    assert {"binarize"} <= {e["name"] for e in evs if e.get("cat") == "user_annotation"}


@pytest.fixture(scope="module")
def tiny_artifact(tmp_path_factory):
    from bdbnn_tpu_torch.models.registry import create_model
    from bdbnn_tpu_torch.serve.export import write_artifact

    d = str(tmp_path_factory.mktemp("art") / "a")
    model = create_model("resnet8_tiny", "cifar10", generator=torch.Generator().manual_seed(0))
    write_artifact(model.to_flax(), d, arch="resnet8_tiny", dataset="cifar10")
    return d


@pytest.mark.parametrize("packed,impl", [(False, "unpack"), (True, "unpack"), (True, "popcount")])
def test_engine_trace_step_charges_every_layer(tiny_artifact, tmp_path, packed, impl):
    from bdbnn_tpu_torch.obs.roofline import model_layer_table
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(tiny_artifact, buckets=(2,), device="cpu", packed=packed,
                          packed_impl=impl)
    before = eng.forwards
    t = eng.trace_step(str(tmp_path), bucket=2, iters=2)
    assert t["bucket"] == 2 and t["iters"] == 2 and t["wall_ms"] > 0
    assert eng.forwards == before + 3  # one unmeasured, two traced
    path = ttrace.find_trace_file(str(tmp_path))
    assert os.path.relpath(path, str(tmp_path)).split(os.sep)[:2] == ["plugins", "profile"]
    rows = model_layer_table("resnet8_tiny", "cifar10", 2)
    att = ttrace.attribute_trace_layers(path, 2, layers={r["name"]: r["scope"] for r in rows})
    assert set(att["layers"]) == {r["name"] for r in rows}
    assert all(ms > 0 for ms in att["layers"].values())
    assert abs(sum(att["layers"].values()) + att["unattributed"] - att["total_ms"]) < 1e-3
    cats = ttrace.attribute_trace(path, 2)["categories_ms_per_step"]
    assert {"binarize", "binary_conv", "bn_act"} <= set(cats)
    assert not ttrace.spans_recording()


# ---------------------------------------------------------------------------
# real fit windows, both packages
# ---------------------------------------------------------------------------

FIT = dict(dataset="cifar10", synthetic=True, synthetic_train_size=16, synthetic_val_size=8,
           arch="resnet8_tiny", epochs=1, batch_size=8, lr=0.05, print_freq=1, seed=0,
           w_kurtosis=True, profile_at=("0:1:1",))


# autodiff wraps a scope segment (``jvp(kurtosis_loss)``), which the
# reference's segment match does not see through: unwrapped here, so the
# comparison is of where each package scoped its math
_WRAPPED = re.compile(r"\b(?:jvp|transpose|vmap|remat|checkpoint)\(([^()]*)\)")


def _unwrap(path):
    while _WRAPPED.search(path):
        path = _WRAPPED.sub(r"\1", path)
    return path


def _jax_categories(run_dir, hlo_text):
    """The reference's categories of its CPU window, each op joined to its
    scope through the compiled step's HLO (its run_perf's join)."""
    evs = jtrace.load_trace_events(jtrace.find_trace_file(run_dir))
    ops, _, _ = jtrace._split_events(evs, "jit_")
    scopes = jtrace.hlo_op_scopes(hlo_text)
    module = jtrace.hlo_module_name(hlo_text)
    cats = {}
    for e in ops:
        a = e.get("args") or {}
        if a.get("hlo_module") != module:
            continue
        path = scopes.get(str(a.get("hlo_op")))
        cat = jtrace._span_of({"name": _unwrap(path)}, jtrace.DEVICE_SPANS) if path else None
        cats[cat or "unattributed"] = cats.get(cat or "unattributed", 0.0) + float(e["dur"])
    return {k for k, v in cats.items() if v > 0}


def test_fit_windows_attribute_the_same_categories(tmp_path):
    from bdbnn_tpu.configs.config import RunConfig as JRunConfig
    from bdbnn_tpu.train import loop as jloop
    from bdbnn_tpu_torch.train import loop as tloop
    from bdbnn_tpu_torch.train.config import RunConfig

    texts = []
    real = jloop.jit_train_step

    def capture(step_fn):
        jitted = real(step_fn)

        def call(*args):
            if not texts:
                texts.append(jitted.lower(*args).compile().as_text())
            return jitted(*args)

        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "jit_train_step", capture)
    try:
        jloop.fit(JRunConfig(log_path=str(tmp_path / "jax"), **FIT))
    finally:
        mp.undo()
    tloop.fit(RunConfig(log_path=str(tmp_path / "port"), device="cpu", **FIT))

    def run_dir(root):
        (d,) = {r for r, _, fs in os.walk(root) for f in fs if f == "events.jsonl"}
        return d

    want = _jax_categories(run_dir(tmp_path / "jax"), texts[0])
    port = run_dir(tmp_path / "port")
    got = ttrace.attribute_trace(ttrace.find_trace_file(port), 1)["categories_ms_per_step"]
    assert {"binarize", "binary_conv", "bn_act", "kurtosis_loss", "optimizer"} <= want
    assert set(got) == want

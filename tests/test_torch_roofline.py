"""The port's roofline (``bdbnn_tpu_torch/obs/roofline.py``) against the
JAX package's, on the CPU.

- The roofline math and ``resolve_ceilings``: the reference's rows for the
  ``cpu`` row, for a ``--ceilings`` override file (one row, and a table
  merged over the built-in one) and for unknown kinds; the H100 rows are
  the datasheet's and there is no TPU row.
- ``model_layer_table`` is the reference's, row by row and exactly, for
  every CIFAR arch both registries share, at batch 1 and 8, in f32 and
  bf16, and with ``twoblock`` (the ImageNet archs in
  ``test_torch_roofline_imagenet.py``); it builds nothing on a device and
  runs no plain version. ``static_table`` is the reference's on the same
  ceilings row.
- ``PerfConfig`` refuses what the reference refuses.
- ``run_perf`` on a CPU ``resnet8_tiny`` artifact at one bucket and all
  three impls: the ``static`` half equal to the JAX ``run_perf``'s on the
  same artifact and ceilings; the measured half has every layer
  attributed, the reconciliation's arithmetic holds, a window that
  writes no trace fails the command, and one whose trace lost device
  records is taken again (up to three windows, counted in the cell).
"""

import dataclasses
import json
import os

import pytest
import torch

from bdbnn_tpu.configs.config import PerfConfig as JPerfConfig
from bdbnn_tpu.models.registry import list_models as jlist
from bdbnn_tpu.obs import roofline as jroof
from bdbnn_tpu_torch.models.registry import list_models as tlist
from bdbnn_tpu_torch.obs import roofline as troof
from bdbnn_tpu_torch.serve.config import PerfConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ceilings_rows():
    assert troof.CEILINGS["cpu"] == jroof.CEILINGS["cpu"]
    sxm = troof.CEILINGS["NVIDIA H100 80GB HBM3"]
    pcie = troof.CEILINGS["NVIDIA H100 PCIe"]
    assert (sxm["peak_flops"], sxm["hbm_gbs"]) == (989.4e12, 3350.0)
    assert (pcie["peak_flops"], pcie["hbm_gbs"]) == (756e12, 2000.0)
    assert "NVIDIA" in sxm["source"] and "datasheet" in sxm["source"]
    assert not any("TPU" in k for k in troof.CEILINGS)
    assert troof.IMPL_REGIME == jroof.IMPL_REGIME
    row = troof.resolve_ceilings("NVIDIA H100 80GB HBM3")
    assert row["matched"] == "NVIDIA H100 80GB HBM3"
    assert row["ridge_intensity"] == round(989.4e12 / 3350e9, 3)


@pytest.mark.parametrize("kind", ["cpu", "x86_64", "some accelerator"])
def test_unknown_kinds_take_the_cpu_row_as_the_reference(kind):
    assert troof.resolve_ceilings(kind) == jroof.resolve_ceilings(kind)
    assert troof.resolve_ceilings(kind)["matched"] == "cpu"


def test_a_tpu_kind_has_no_row_here():
    assert troof.resolve_ceilings("TPU v5 lite")["matched"] == "cpu"


@pytest.mark.parametrize("override", [
    {"peak_flops": 1e12, "hbm_gbs": 100.0},
    {"hbm_gbs": 25.0},
    {"cpu": {"peak_flops": 3e11, "hbm_gbs": 60.0, "source": "measured"}},
    {"my box": {"peak_flops": 5e11, "hbm_gbs": 70.0}},
])
def test_ceilings_override_file_is_the_references(tmp_path, override):
    path = tmp_path / "ceil.json"
    path.write_text(json.dumps(override))
    for kind in ("cpu", "my box"):
        assert troof.resolve_ceilings(kind, str(path)) == jroof.resolve_ceilings(kind, str(path))
        assert troof.resolve_ceilings(kind, override) == jroof.resolve_ceilings(kind, override)


@pytest.mark.parametrize("flops,nbytes", [(0, 0), (1e9, 1e6), (3.3e12, 1e9), (7, 1e12)])
def test_roofline_math_is_the_references(flops, nbytes):
    for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
        c = troof.resolve_ceilings(kind)
        ai = troof.arithmetic_intensity(flops, nbytes)
        assert ai == jroof.arithmetic_intensity(flops, nbytes)
        assert troof.ridge_intensity(c) == jroof.ridge_intensity(c)
        assert troof.classify_bound(ai, c) == jroof.classify_bound(ai, c)
        assert troof.roof_ms(flops, nbytes, c) == jroof.roof_ms(flops, nbytes, c)


def test_both_registries_share_every_arch():
    for ds in ("cifar10", "imagenet"):
        assert set(jlist(ds)) == set(tlist(ds))


def layer_table_cases(dataset):
    """Every arch both registries share: batch 1 in f32, batch 8 in bf16 and
    (the binary archs) twoblock at batch 8 in f32; for the flagship and
    ``resnet8_tiny`` each of batch 1 and 8 in f32 and bf16, and twoblock at
    batch 1 in bf16 (the reference's tracing costs about a second a
    table)."""
    out = []
    for arch in sorted(set(jlist(dataset)) & set(tlist(dataset))):
        blocks = "float" not in arch and "vgg" not in arch
        if arch in ("resnet18", "resnet8_tiny") and dataset == {"resnet18": "imagenet",
                                                                "resnet8_tiny": "cifar10"}[arch]:
            combos = [(b, dt, False) for b in (1, 8) for dt in ("float32", "bfloat16")]
            combos += [(1, "bfloat16", True)]
        else:
            combos = [(1, "float32", False), (8, "bfloat16", False)]
            combos += [(8, "float32", True)] if blocks else []
        out += [(dataset, arch, *c) for c in combos]
    return out


def check_layer_table(dataset, arch, batch, dtype, twoblock):
    got = troof.model_layer_table(arch, dataset, batch, dtype=dtype, twoblock=twoblock)
    want = jroof.model_layer_table(arch, dataset, batch, dtype=dtype, twoblock=twoblock)
    assert got == want
    if arch == "resnet18" and dataset == "imagenet":
        c = troof.resolve_ceilings("NVIDIA H100 80GB HBM3")
        assert troof.static_table(got, c) == jroof.static_table(want, c)
        assert [r["kind"] for r in got].count("binary") == 19 and len(got) == 21


@pytest.mark.parametrize("dataset,arch,batch,dtype,twoblock", layer_table_cases("cifar10"))
def test_model_layer_table_is_the_references(dataset, arch, batch, dtype, twoblock):
    check_layer_table(dataset, arch, batch, dtype, twoblock)


def test_model_layer_table_twoblock_refusal_is_the_references():
    with pytest.raises(ValueError, match="vgg_small has no blocks"):
        troof.model_layer_table("vgg_small", "cifar10", 1, twoblock=True)


def test_model_layer_table_runs_nothing(monkeypatch):
    """No kernel wrapper and no plain version is called: the binary convs'
    forwards are shape-only on the meta device."""
    from bdbnn_tpu_torch.nn import layers

    def boom(*a, **k):
        raise AssertionError("a kernel ran")

    monkeypatch.setattr(layers, "weight_binarize", boom)
    monkeypatch.setattr(layers, "binary_conv2d", boom)
    rows = troof.model_layer_table("resnet18", "imagenet", 256, image_size=224)
    assert rows[1]["name"] == "layer1_0.conv1" and rows[1]["in_shape"] == [256, 56, 56, 64]


@pytest.mark.parametrize("kw", [
    {"artifact": ""}, {"buckets": ()}, {"buckets": (0, 4)}, {"impls": ("dense", "fast")},
    {"impls": ()}, {"impls": ("dense", "dense")}, {"iters": 0}, {"tol_reconcile": 0.0},
    {"events_max_mb": -1.0}, {},
])
def test_perf_config_refusals_are_the_references(kw):
    kw = {"artifact": "a", **kw}

    def outcome(cls):
        try:
            cls(**kw).validate()
            return None
        except ValueError as e:
            return str(e)

    assert outcome(PerfConfig) == outcome(JPerfConfig)
    ref = {f.name: f.default for f in dataclasses.fields(JPerfConfig) if f.name != "artifact"}
    port = {f.name: f.default for f in dataclasses.fields(PerfConfig) if f.name != "artifact"}
    assert port == {**ref, "device": None}


# ---------------------------------------------------------------------------
# run_perf on a CPU artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def perf_runs(tmp_path_factory):
    from bdbnn_tpu_torch.models.registry import create_model
    from bdbnn_tpu_torch.serve.export import write_artifact

    root = tmp_path_factory.mktemp("perf")
    art = str(root / "art")
    model = create_model("resnet8_tiny", "cifar10", generator=torch.Generator().manual_seed(0))
    write_artifact(model.to_flax(), art, arch="resnet8_tiny", dataset="cifar10")
    ceil = str(root / "ceil.json")
    with open(ceil, "w") as f:
        json.dump({"peak_flops": 2.5e11, "hbm_gbs": 40.0}, f)
    port = troof.run_perf(PerfConfig(artifact=art, log_path=str(root / "port"), buckets=(2,),
                                     iters=2, ceilings=ceil, device="cpu").validate())
    ref = jroof.run_perf(JPerfConfig(artifact=art, log_path=str(root / "jax"), buckets=(2,),
                                     iters=2, ceilings=ceil, static_only=True).validate())
    return {"port": port, "jax": ref, "art": art, "root": root, "ceil": ceil}


def test_run_perf_static_half_is_the_references(perf_runs):
    got, want = perf_runs["port"]["verdict"], perf_runs["jax"]["verdict"]
    assert got["static"] == want["static"]
    assert set(got) == set(want)
    assert got["perf_verdict"] == want["perf_verdict"] == 1
    for k in ("arch", "dataset", "dtype", "buckets", "impls", "iters", "skipped"):
        assert got[k] == want[k], k
    # one --ceilings row: matched is the device kind, which differs
    kinds = ("device_kind", "matched")
    assert {k: v for k, v in got["ceilings"].items() if k not in kinds} == {
        k: v for k, v in want["ceilings"].items() if k not in kinds}
    assert got["provenance"]["recipe"] == want["provenance"]["recipe"]
    assert got["backend"] == "cpu"


def test_run_perf_measures_every_layer(perf_runs):
    v = perf_runs["port"]["verdict"]
    names = {r["name"] for r in v["static"]["2"]}
    assert len(names) == 7
    for impl in ("dense", "unpack", "popcount"):
        cell = v["measured"][impl]["2"]
        assert cell["traced"] is True
        assert set(cell["layers"]) == names
        regime = troof.IMPL_REGIME[impl]
        stat = {r["name"]: r for r in v["static"]["2"]}
        for name, lay in cell["layers"].items():
            assert lay["ms"] > 0
            assert lay["roof_ms"] == stat[name]["regimes"][regime]["roof_ms"]
            assert lay["bound"] == stat[name]["regimes"][regime]["bound"]
            assert v["perf_layers"][f"{name}|b2|{impl}"] == lay["ms"]
        # the reconciliation's arithmetic (its ok is timing-dependent)
        r = cell["reconciliation"]
        assert r["wall_ms"] == cell["wall_ms"] > 0
        assert abs(r["attributed_ms"] - round(sum(x["ms"] for x in cell["layers"].values()), 4)) \
            < 1e-9
        # the 7 layers, unattributed and the total are each rounded to 4 places
        assert abs(r["attributed_ms"] + r["unattributed_ms"] - r["device_total_ms"]) <= 9 * 5e-5 + 1e-9
        err = abs(r["device_total_ms"] - r["wall_ms"]) / r["wall_ms"]
        assert r["abs_err_pct"] == round(err * 100.0, 2)
        assert r["ok"] == (err <= 0.5)
    assert len(v["perf_layers"]) == 21
    s = v["summary"]
    assert s["bucket"] == 2 and s["step_ms_dense"] == v["measured"]["dense"]["2"]["wall_ms"]


def test_run_perf_writes_the_references_files(perf_runs):
    from bdbnn_tpu_torch.obs.events import read_events

    run_dir = perf_runs["port"]["run_dir"]
    for name in (troof.PERF_VERDICT_NAME, troof.BENCH_ARTIFACT_NAME, "manifest.json"):
        assert os.path.isfile(os.path.join(run_dir, name))
    phases = [e["phase"] for e in read_events(run_dir, "perf")]
    assert phases == ["start", "bucket", "bucket", "bucket", "verdict"]
    (line,) = open(os.path.join(perf_runs["root"], "port", troof.PERF_LEDGER_NAME)).readlines()
    assert set(json.loads(line)) == set(json.loads(open(os.path.join(
        perf_runs["root"], "jax", jroof.PERF_LEDGER_NAME)).readline()))
    bench = json.load(open(os.path.join(run_dir, troof.BENCH_ARTIFACT_NAME)))
    assert bench == troof._bench_artifact(perf_runs["port"]["verdict"])
    assert troof.render_perf(perf_runs["port"]["verdict"]).startswith(
        "== Perf roofline: resnet8_tiny/cifar10 on ")


def test_render_perf_is_the_references(perf_runs):
    v = perf_runs["port"]["verdict"]
    assert troof.render_perf(v) == jroof.render_perf(v)
    assert troof._summarize_measured(v["measured"], (2,), v["static"], v["ceilings"]) == \
        jroof._summarize_measured(v["measured"], (2,), v["static"], v["ceilings"])
    assert troof._bench_artifact(v) == jroof._bench_artifact(v)


def test_a_window_without_a_trace_fails_the_command(perf_runs, tmp_path, monkeypatch):
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(InferenceEngine, "trace_step", lambda self, d, bucket=None, iters=10: {
        "bucket": bucket, "iters": iters, "wall_ms": 1.0, "trace_dir": d})
    with pytest.raises(RuntimeError, match="wrote no trace"):
        troof.run_perf(PerfConfig(artifact=perf_runs["art"], log_path=str(tmp_path),
                                  buckets=(1,), impls=("dense",), iters=1, device="cpu"))


@pytest.mark.parametrize("losses,windows,lost", [((4, 0), 2, 0), ((4, 3, 2), 3, 2)])
def test_a_window_that_lost_records_is_taken_again(perf_runs, tmp_path, monkeypatch, losses,
                                                   windows, lost):
    from bdbnn_tpu_torch.obs import trace
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    seen = iter(losses)
    monkeypatch.setattr(trace, "lost_device_records", lambda path: next(seen))
    calls = []
    real = InferenceEngine.trace_step
    monkeypatch.setattr(InferenceEngine, "trace_step",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    v = troof.run_perf(PerfConfig(artifact=perf_runs["art"], log_path=str(tmp_path),
                                  buckets=(1,), impls=("dense",), iters=1,
                                  device="cpu"))["verdict"]
    cell = v["measured"]["dense"]["1"]
    assert (cell["windows"], cell["lost_records"], len(calls)) == (windows, lost, windows)
    assert len(cell["layers"]) == 7


def test_static_only_builds_no_engine(perf_runs, tmp_path, monkeypatch):
    from bdbnn_tpu_torch.serve import engine

    monkeypatch.setattr(engine, "InferenceEngine", None)
    out = troof.run_perf(PerfConfig(artifact=perf_runs["art"], log_path=str(tmp_path),
                                    buckets=(1, 4), static_only=True, ceilings=perf_runs["ceil"],
                                    device="cpu"))
    v = out["verdict"]
    assert v["measured"] == {} and v["perf_layers"] == {} and set(v["static"]) == {"1", "4"}

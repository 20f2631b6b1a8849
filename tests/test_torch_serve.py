"""Serving parity: export artifacts cross between the two packages, and
the port's engine and CLI.

- A ``resnet8_tiny`` artifact written by the port's ``write_artifact``
  passes the JAX loader's sha256 gate, and the JAX ``InferenceEngine``
  and the port's (``device="cpu"``) serve it to within 2e-5 of the
  largest |logit| (the float parts sum in other orders; every binary
  conv is exact) with equal top-1 — across padding and chunk seams.
- The reverse: an artifact the JAX exporter writes serves in the port.
- In the port, dense, packed/unpack and packed/popcount logits are
  bitwise equal.
- ``InferenceEngine(art)`` with no device raises where no CUDA device
  exists (no silent CPU fallback); bf16 artifacts raise.
- ``python -m bdbnn_tpu_torch.cli predict --synthetic --device cpu``
  exits 0.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.serve import engine as jengine
from bdbnn_tpu.serve import export as jexport
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.serve import engine as tengine
from bdbnn_tpu_torch.serve import export as texport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 3, 4, 5, 9)


def _port_tiny(seed=0):
    """resnet8_tiny in the port with seeded weights and BN statistics."""
    g = torch.Generator().manual_seed(seed)
    model = treg.create_model("resnet8_tiny", "cifar10", generator=g)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith(("running_mean", "bias")):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith("weight") and t.dim() == 1:
                t.copy_(1.0 + 0.5 * torch.rand(t.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_art") / "art")
    texport.write_artifact(_port_tiny().to_flax(), out, arch="resnet8_tiny", dataset="cifar10")
    return out


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _assert_close_logits(got, ref):
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_port_artifact_passes_jax_gate_and_serves_in_both_engines(port_artifact):
    art = jexport.read_artifact(port_artifact)
    assert art["stats"]["binarized_convs"] == 5
    assert not any("float_weight" in t["path"] for t in art["tensors"])
    jexport.load_artifact_variables(port_artifact)  # sha256 gate
    jexport.load_artifact_packed(port_artifact)
    jax_engine = jengine.InferenceEngine(port_artifact, buckets=(1, 4))
    port_engine = tengine.InferenceEngine(port_artifact, buckets=(1, 4), device="cpu")
    assert port_engine.warmed
    for n in SIZES:
        x = _images(n, n)
        _assert_close_logits(port_engine.predict_logits(x), jax_engine.predict_logits(x))


def test_torn_weights_fail_the_port_gate(port_artifact, tmp_path):
    import shutil

    torn = str(tmp_path / "torn")
    shutil.copytree(port_artifact, torn)
    with open(os.path.join(torn, texport.WEIGHTS_NAME), "ab") as f:
        f.write(b"\0")
    for load in (texport.load_artifact_variables, texport.load_artifact_packed):
        with pytest.raises(RuntimeError, match="sha256"):
            load(torn)


def test_jax_exported_artifact_serves_in_port(tmp_path, monkeypatch):
    """The JAX exporter (fold, pack, manifest) over a seeded flax tree;
    only its checkpoint read is replaced by the tree itself."""
    from bdbnn_tpu.utils import checkpoint as jckpt

    flax_model = jreg.create_model("resnet8_tiny", "cifar10")
    variables = flax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"]
    )
    src = str(tmp_path / "ckpt")
    os.makedirs(src)
    monkeypatch.setattr(jckpt, "load_export_payload", lambda path: {
        "params": variables["params"], "batch_stats": stats, "arch": "resnet8_tiny",
        "epoch": 0, "best_acc1": 0.0, "source": src, "integrity": "ok",
        "fallback": False, "resume_state": {},
    })
    out = str(tmp_path / "jax_art")
    jexport.export_artifact(src, out, arch="resnet8_tiny", dataset="cifar10")
    jax_engine = jengine.InferenceEngine(out, buckets=(4,))
    for packed, impl in ((False, "unpack"), (True, "popcount")):
        port_engine = tengine.InferenceEngine(
            out, buckets=(4,), device="cpu", packed=packed, packed_impl=impl
        )
        x = _images(5, 7)
        _assert_close_logits(port_engine.predict_logits(x), jax_engine.predict_logits(x))


def test_dense_unpack_popcount_bitwise_and_chunking(port_artifact):
    engines = [
        tengine.InferenceEngine(port_artifact, buckets=(1, 4), device="cpu", **kw)
        for kw in ({}, {"packed": True}, {"packed": True, "packed_impl": "popcount"})
    ]
    x = _images(11, 0)
    ref = engines[0].predict_logits(x)
    for e in engines[1:]:
        np.testing.assert_array_equal(e.predict_logits(x).view(np.uint32), ref.view(np.uint32))
    # chunk seam: 11 rows = chunks of 4, 4 and 3 (padded to bucket 4),
    # each the same computation as serving that chunk alone
    parts = [engines[0].predict_logits(x[i : i + 4]) for i in (0, 4, 8)]
    np.testing.assert_array_equal(np.concatenate(parts), ref)
    # a row served alone runs bucket 1; the CPU's float kernels may
    # block a batch of 1 differently, a few ulps
    _assert_close_logits(engines[0].predict_logits(x[10]), ref[10:])
    np.testing.assert_array_equal(engines[0].predict(x), ref.argmax(-1))
    assert engines[0].predict_logits(x[:0]).shape == (0, 10)
    stats = engines[0].step_stats()
    assert stats["calls"] >= 6 and stats["p50_ms"] > 0
    assert engines[1].time_step(bucket=4, iters=2) > 0.0
    assert tengine.max_abs_logit_drift(ref, ref) == 0.0
    assert tengine.max_abs_logit_drift(ref, ref[:3]) is None


def test_engine_has_no_cpu_fallback_and_validates(port_artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("asserts behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.InferenceEngine(port_artifact)
    with pytest.raises(ValueError, match="packed_impl"):
        tengine.InferenceEngine(port_artifact, device="cpu", packed_impl="int8")
    with pytest.raises(ValueError, match="buckets"):
        tengine.InferenceEngine(port_artifact, device="cpu", buckets=(0,))
    import shutil

    bf16 = str(tmp_path / "bf16")
    shutil.copytree(port_artifact, bf16)
    path = os.path.join(bf16, texport.ARTIFACT_NAME)
    with open(path) as f:
        art = json.load(f)
    art["model"]["dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(art, f)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tengine.InferenceEngine(bf16, device="cpu")


def test_cli_predict_synthetic_on_cpu(port_artifact):
    cmd = [sys.executable, "-m", "bdbnn_tpu_torch.cli", "predict", port_artifact,
           "--synthetic", "--synthetic-val-size", "20", "-b", "8", "--device", "cpu"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    assert out["count"] == 20 and out["device"] == "cpu" and out["match"] is None
    r = subprocess.run(cmd + ["--check"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2  # the artifact records no checkpoint accuracy


def test_cli_val_split_matches_reference_recipe():
    """Synthetic split: seed 2 images, ImageNet normalization for
    imagenet — the reference's build_datasets recipe."""
    from bdbnn_tpu.data import IMAGENET_MEAN, IMAGENET_STD, normalize, synthetic_dataset
    from bdbnn_tpu_torch.cli import build_val_pipeline

    art = {"dataset": "imagenet", "image_size": 16, "num_classes": 1000,
           "provenance": {"config": {"batch_size": 4}}}
    pipe = build_val_pipeline(art, data="", synthetic=True, synthetic_val_size=6)
    batches = list(pipe.epoch(0))
    ref = synthetic_dataset(6, 16, 1000, seed=2)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(x, normalize(ref.images, IMAGENET_MEAN, IMAGENET_STD))
    np.testing.assert_array_equal(y, ref.labels)
    assert [len(b[1]) for b in batches] == [4, 2]

"""A bf16 artifact from the JAX exporter (its run manifest records
``dtype=bfloat16``), served by the port's CPU engine in dense and
packed/unpack against the JAX engine; packed/popcount refused in both, as
the reference refuses it (bf16 conv accumulation rounds past 256 terms,
the popcount dot is exact integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.serve import engine as jengine
from bdbnn_tpu.serve import export as jexport
from bdbnn_tpu_torch.serve import engine as tengine


def test_bf16_artifact_from_the_jax_exporter_serves_in_the_port(tmp_path, monkeypatch):
    """The JAX exporter writes a bf16 artifact (its run manifest records
    dtype=bfloat16); the port's CPU engine serves it in dense and
    packed/unpack bitwise alike, within two bf16 ulps of the largest
    |logit| of the JAX engine (its stem conv and pool sum in another
    order) with the same top-1 on every image; packed/popcount raises the
    reference's ValueError in both engines."""
    from bdbnn_tpu.obs import manifest as jmanifest
    from bdbnn_tpu.utils import checkpoint as jckpt

    flax_model = jreg.create_model("resnet8_tiny", "cifar10")
    variables = jax.tree_util.tree_map(np.asarray, flax_model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"]
    )
    src = str(tmp_path / "ckpt")
    monkeypatch.setattr(jckpt, "load_export_payload", lambda path: {
        "params": variables["params"], "batch_stats": stats, "arch": "resnet8_tiny",
        "epoch": 0, "best_acc1": 0.0, "source": src, "integrity": "ok",
        "fallback": False, "resume_state": {},
    })
    monkeypatch.setattr(jmanifest, "read_manifest", lambda path: {"config": {
        "arch": "resnet8_tiny", "dataset": "cifar10", "dtype": "bfloat16"}})
    (tmp_path / "ckpt").mkdir()
    out = str(tmp_path / "art")
    jexport.export_artifact(src, out)
    assert jexport.read_artifact(out)["model"]["dtype"] == "bfloat16"
    jax_engine = jengine.InferenceEngine(out, buckets=(4,))
    x = np.random.default_rng(7).normal(size=(5, 32, 32, 3)).astype(np.float32)
    ref = jax_engine.predict_logits(x)
    dense = tengine.InferenceEngine(out, buckets=(4,), device="cpu")
    unpack = tengine.InferenceEngine(out, buckets=(4,), device="cpu", packed=True)
    assert dense._model.dtype == torch.bfloat16
    got = dense.predict_logits(x)
    np.testing.assert_array_equal(unpack.predict_logits(x).view(np.uint32), got.view(np.uint32))
    assert np.abs(got - ref).max() <= 2 * 2.0**-8 * np.abs(ref).max()
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    for engine in (jengine.InferenceEngine, tengine.InferenceEngine):
        kw = {"device": "cpu"} if engine is tengine.InferenceEngine else {}
        with pytest.raises(ValueError, match="popcount"):
            engine(out, buckets=(4,), packed=True, packed_impl="popcount", **kw)

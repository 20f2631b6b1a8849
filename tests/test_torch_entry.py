"""The port's ``entry()`` (``bdbnn_tpu_torch/entry.py``) against the
reference's ``__graft_entry__.entry()``, on the CPU:

- at the flagship's shapes, the model's weights bridge leaf for leaf, by
  flax path and shape, to ``jax.eval_shape`` of the reference's init (its
  ``params`` and ``batch_stats``), and the example input has the
  reference's shape and dtype (zeros);
- ``forward`` is held to the flax forward on bridged weights at the
  ``react-imagenet-64`` case of ``tests/test_torch_models.py`` with that
  test's tolerance, 2e-5 of the largest |logit|, after its check that
  every pre-sign value lies more than 1e-4 from its threshold;
- without a card ``entry()`` raises instead of falling back to the CPU.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_models import LOGIT_CASES, _min_presign_margin, _seeded_tree

import __graft_entry__
from bdbnn_tpu_torch.entry import EXAMPLE_SHAPE, entry, forward


def _shapes(tree, prefix=()):
    """``{flax path: shape}`` of every leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def test_the_flagship_bridges_to_the_references_init_and_example():
    fn, (model, x) = entry(device="cpu")
    assert fn is forward and not model.training
    ref_vars, ref_x = jax.eval_shape(lambda: __graft_entry__.entry()[1])
    ref = _shapes(dict(jax.tree_util.tree_map(lambda a: a, ref_vars)))
    ours = _shapes(model.to_flax())
    assert set(ref) == {p for p in ref if p[0] in ("params", "batch_stats")}
    assert ours == ref
    assert sum(1 for p in ours if p[-1] == "float_weight") == 19  # the binary convs
    assert tuple(x.shape) == ref_x.shape == EXAMPLE_SHAPE
    assert x.dtype == torch.float32 and str(ref_x.dtype) == "float32"
    assert not x.any()


def test_forward_matches_flax_at_the_react_imagenet_64_case():
    (_, make_flax, make_port, image_shape, seed), = [
        c for c in LOGIT_CASES if c[0] == "react-imagenet-64"]
    flax_model, port = make_flax(), make_port().eval()
    tree = _seeded_tree(flax_model, image_shape, seed)
    port.from_flax(tree)
    x = np.random.default_rng(seed + 100).normal(size=(1, *image_shape)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert _min_presign_margin(port, xt) > 1e-4
    ref = np.asarray(flax_model.apply(tree, x, train=False))
    got = forward(port, xt).numpy()
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_entry_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()

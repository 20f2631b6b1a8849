"""The weight bridge (``bdbnn_tpu_torch/bridge.py``) over every ported
registry arch: the port's ``to_flax()`` tree has exactly the flax
model's variable paths and shapes, and flax tree → port → flax tree is
exact (the bridge only permutes values), dense and packed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from bdbnn_tpu_torch.models import registry as treg

PORTED = [
    (ds, arch)
    for ds in ("cifar10", "imagenet")
    for arch in jreg.list_models(ds)
    if arch not in ("resnet50_float", "resnet101_float")
]


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("dataset,arch", PORTED, ids=[f"{d}-{a}" for d, a in PORTED])
def test_bridge_tree_matches_flax_and_round_trips_exactly(dataset, arch):
    port = treg.create_model(arch, dataset, generator=torch.Generator().manual_seed(0))
    flax_model = jreg.create_model(arch, dataset)
    ref = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0),
    )
    tree = port.to_flax()
    assert _shapes(tree) == _shapes(dict(ref))
    again = state_dict_to_flax(flax_to_state_dict(tree))
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        for v in port.state_dict().values():
            v.zero_()
    port.from_flax(tree)
    after = port.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_packed_model_round_trips_through_packed_collection():
    model = treg.create_model("resnet8_tiny", "cifar10", packed=True)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".sign"):
                buf.copy_(torch.from_numpy(rng.integers(0, 256, buf.shape).astype(np.uint8)))
    tree = model.to_flax()
    assert "packed" in tree and "float_weight" not in str(_shapes(tree["params"]))
    assert set(tree["packed"]["layer1_0"]["conv1"]) == {"sign", "alpha"}
    fresh = treg.create_model("resnet8_tiny", "cifar10", packed=True).from_flax(tree)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  fresh.state_dict().values()))

"""The port's models and registry against the flax reference (the
weight bridge over every registry arch is tests/test_torch_bridge.py).

- Eval logits of tiny BiResNets (react / imagenet stem at 64², step2,
  cifar, twoblock) and of vgg_small, from the same seeded flax-layout
  weights with non-trivial BN statistics, act_shifts and RPReLU vectors,
  agree with ``model.apply(..., train=False)`` to a relative 2e-5 of the
  largest |logit|. The float parts (stem conv, BN, pooling, classifier)
  sum in other orders than XLA's, a few f32 ulps; every binary conv is
  exact. Each case first asserts that every pre-sign value of the port's
  forward lies more than 1e-4 from its threshold, so an ulp-level
  difference can neither flip a sign and pass for a bug nor hide one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn.layers import _BinaryConvBase

def _seeded_tree(flax_model, image_shape, seed):
    """Flax-layout weights from a numpy seed: the flax init's shapes,
    random params, BN stats away from identity, non-zero shifts."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros((1, *image_shape)), train=False),
        jax.random.PRNGKey(0),
    )

    def draw(path, sd):
        name = path[-1].key
        shape = sd.shape
        if name in ("float_weight", "weight", "kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "slope":
            return rng.uniform(0.1, 0.4, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _min_presign_margin(model, x):
    """Smallest non-zero |x - shift| any binary conv of the port's
    forward sees. Exact zeros are the ReLU outputs the imagenet stem
    feeds the first block (never negative in either framework, so +1 in
    both)."""
    margins = []

    def hook(mod, args):
        v = args[0]
        if getattr(mod, "has_shift", False):
            v = v - mod.act_shift
        a = v.abs()
        margins.append(float(a[a > 0].min()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, _BinaryConvBase)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    assert margins, "model has no binary conv"
    return min(margins)


LOGIT_CASES = [
    # id, flax model, port model, image shape, seed
    ("react-imagenet-64",
     lambda: jres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="react", act="rprelu"),
     lambda: tres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="react", act="rprelu"),
     (64, 64, 3), 0),
    ("step2-imagenet-64",
     lambda: jres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="step2", act="hardtanh"),
     lambda: tres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="step2", act="hardtanh"),
     (64, 64, 3), 0),
    ("cifar-16",
     lambda: jres.BiResNet((1, 1), 10, width=8, stem="cifar", variant="cifar", act="hardtanh"),
     lambda: tres.BiResNet((1, 1), 10, width=8, stem="cifar", variant="cifar", act="hardtanh"),
     (16, 16, 3), 0),
    ("twoblock-react-16",
     lambda: jres.BiResNet((2, 1), 10, width=8, stem="cifar", variant="react", act="rprelu",
                           twoblock=True),
     lambda: tres.BiResNet((2, 1), 10, width=8, stem="cifar", variant="react", act="rprelu",
                           twoblock=True),
     (16, 16, 3), 0),
    ("vgg_small-8",
     lambda: jres.VGGSmallBinary(10),
     lambda: tres.VGGSmallBinary(10, image_size=8),
     (8, 8, 3), 0),
]


@pytest.mark.parametrize("case", LOGIT_CASES, ids=[c[0] for c in LOGIT_CASES])
def test_eval_logits_match_flax(case):
    _, make_flax, make_port, image_shape, seed = case
    flax_model, port = make_flax(), make_port().eval()
    tree = _seeded_tree(flax_model, image_shape, seed)
    port.from_flax(tree)
    x = np.random.default_rng(seed + 100).normal(size=(1, *image_shape)).astype(np.float32)
    xt = torch.from_numpy(x)
    assert _min_presign_margin(port, xt) > 1e-4
    ref = np.asarray(flax_model.apply(tree, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(xt).numpy()
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))


def test_fold_batch_norm_and_conv_paths_match_reference():
    flax_model = jreg.create_model("resnet8_tiny", "cifar10")
    tree = _seeded_tree(flax_model, (16, 16, 3), 3)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    ours, theirs = tres.fold_batch_norm(tree), jres.fold_batch_norm(tree)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tres.conv_weight_paths(tree) == jres.conv_weight_paths(tree)
    p = tres.conv_weight_paths(tree)[1]
    assert tres.module_path_str(p) == jres.module_path_str(p)
    assert np.array_equal(tres.get_by_path(tree, p), jres.get_by_path(tree, p))


def test_registry_names_and_unported_options():
    for ds in ("cifar10", "imagenet"):
        assert treg.list_models(ds) == jreg.list_models(ds)
    # the bottleneck float teachers build (torchvision's parameter
    # counts); bottleneck blocks are float only
    for arch, n_params in (("resnet50_float", 25_557_032), ("resnet101_float", 44_549_160)):
        model = treg.create_model(arch, "imagenet")
        assert isinstance(model.layer1_0, tres.FloatBottleneck)
        assert sum(p.numel() for p in model.parameters()) == n_params
    with pytest.raises(ValueError, match="bottleneck"):
        tres.BiResNet((1, 1), 10, width=8, variant="react", block="bottleneck")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        treg.create_model("resnet8_tiny", "cifar10", dtype="bfloat16")
    with pytest.raises(ValueError, match="unknown arch"):
        treg.create_model("nope", "cifar10")


def test_training_mode_raises_until_training_slice():
    """Training mode runs since the training slice, under the stochastic
    family too (sampled signs from a step's draws: the same (seed, step)
    gives the same output bitwise, another step another one); what it does
    not run yet raises: remat, and a packed model (no latent weight)."""
    from bdbnn_tpu_torch.nn.binarize import StepDraws, active_family

    model = treg.create_model("resnet8_tiny", "cifar10").train()
    assert model(torch.zeros(2, 16, 16, 3)).shape == (2, 10)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32))
    outs = []
    with active_family("stochastic"), torch.no_grad():
        for step in (0, 0, 1):
            outs.append(model(x, None, StepDraws(5, step)))
    assert outs[0].shape == (2, 10) and bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(NotImplementedError, match="remat"):
        treg.create_model("resnet8_tiny", "cifar10", remat=True)
    packed = treg.create_model("resnet8_tiny", "cifar10", packed=True).train()
    with pytest.raises(ValueError, match="packed"):
        packed(torch.zeros(1, 16, 16, 3))

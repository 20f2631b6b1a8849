"""bf16 models of the port against the JAX package's bf16 models, on the
CPU:

- ``resnet20_float`` (the continuous twin: in a binary net any value
  within rounding of a sign threshold flips between two computations,
  ``tests/test_models.py`` ``test_bf16_close_to_f32_on_float_twin``)
  tracks the JAX bf16 forward far closer than the JAX f32 forward does;
- a react binary net's bf16 train step, with every input of a binary
  conv and of an RPReLU (the values a threshold decides on) replayed from
  the port into the JAX model (``flax.linen.intercept_methods``; the
  gradient passes straight through): the loss bitwise, the gradients of
  the f32 paths within a stated tolerance, the parameters f32 after the
  port's step;
- one train step of the port (Adam, kurtosis) on a bf16 model keeps its
  parameters, optimizer state and running statistics f32.

The served bf16 artifact is held in ``tests/test_torch_bf16_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.nn import layers as jlayers
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.losses.kd import softmax_cross_entropy
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn.layers import RPReLU, _BinaryConvBase
from test_torch_bf16 import _seeded_tree

JBF = jnp.bfloat16


def test_resnet20_float_bf16_tracks_the_jax_bf16_model():
    """Eval forward, same weights: the port's bf16 logits lie within two
    bf16 ulps of the largest |logit| of the JAX bf16 logits (the convs and
    the pool sum in another order, and a sum that lands on the other side
    of a bf16 rounding boundary moves a value by one ulp), and on average
    at most a quarter as far from them as the JAX f32 logits are."""
    j32 = jreg.create_model("resnet20_float", "cifar10")
    j16 = jreg.create_model("resnet20_float", "cifar10", dtype="bfloat16")
    tree = _seeded_tree(j32, (32, 32, 3), 21)
    x = np.random.default_rng(22).normal(size=(4, 32, 32, 3)).astype(np.float32)
    o32 = np.asarray(j32.apply(tree, jnp.asarray(x), train=False))
    o16 = np.asarray(j16.apply(tree, jnp.asarray(x), train=False))
    port = treg.create_model("resnet20_float", "cifar10", dtype="bfloat16").from_flax(tree).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - o16).max() <= 2 * 2.0**-8 * np.abs(o16).max()
    assert np.abs(got - o16).mean() <= 0.25 * np.abs(o16 - o32).mean()


@jax.custom_vjp
def _replay(x, card):
    """``card`` in the forward; the cotangent passes to ``x``."""
    return card


_replay.defvjp(lambda x, card: (card, None), lambda _, g: (g, None))


# per-channel parameters that enter the model cast to bf16: their
# gradient is a bf16 reduction over N·H·W, which the reference's XLA:CPU
# adds in bf16 one term at a time (each add rounds by up to 2⁻⁹ of a
# partial sum, past the gradient's own size at these counts), so the
# reference cannot hold them here; the module tests hold act_shift's and
# RPReLU's to that reduction's bound (tests/test_torch_bf16.py)
BF16_CAST_PARAMS = ("act_shift", "gamma", "zeta", "slope")
# bf16 gradients through a net: each binary conv's dx and each BN and
# RPReLU backward round to bf16 (2⁻⁹ relative), and a one-ulp difference
# in a cotangent passes on to every layer before it; 5e-2 of a tensor's
# largest entry is about thirteen bf16 ulps
BF16_GRAD_TOL = 5e-2


def test_binary_bf16_step_with_input_replay_matches_jax():
    jmodel = jres.BiResNet(stage_sizes=(1, 1), num_classes=10, width=8, stem="cifar",
                           variant="react", act="rprelu", dtype=JBF)
    tree = _seeded_tree(jmodel, (16, 16, 3), 23)
    rng = np.random.default_rng(24)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    port = tres.BiResNet((1, 1), 10, width=8, stem="cifar", variant="react", act="rprelu",
                         dtype="bfloat16").from_flax(tree).train()
    recorded = []
    hooks = [m.register_forward_pre_hook(lambda m, a: recorded.append(a[0].detach().clone()))
             for m in port.modules() if isinstance(m, (_BinaryConvBase, RPReLU))]
    logits = port(torch.from_numpy(x))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    for h in hooks:
        h.remove()
    assert len(recorded) == 5 + 4  # binary convs, RPReLUs

    def jax_loss(params):
        cards = iter(recorded)

        def intercept(next_fun, args, kwargs, ctx):
            if ctx.method_name == "__call__" and isinstance(
                ctx.module, (jlayers._BinaryConvBase, jlayers.RPReLU)
            ):
                card = jnp.asarray(next(cards).float().numpy()).astype(args[0].dtype)
                args = (_replay(args[0], card),) + tuple(args[1:])
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(intercept):
            out, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                  jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(out, jnp.asarray(y))

    jloss, jgrads = jax.value_and_grad(jax_loss)(tree["params"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    ref = flax_to_state_dict({"params": jgrads, "batch_stats": tree["batch_stats"]})
    held = 0
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
        if name.endswith(BF16_CAST_PARAMS):
            continue
        want = ref[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=BF16_GRAD_TOL * scale,
                                   err_msg=name)
        held += 1
    assert held == 5 + 2 * 6 + 3  # latent weights, BN pairs, stem and fc


def test_one_bf16_train_step_keeps_f32_params():
    """The port's train step (Adam, kurtosis on the f32 latent weights) on
    a bf16 model: finite f32 loss terms, f32 parameters and Adam state
    after the update, f32 running statistics."""
    from bdbnn_tpu_torch.train.config import RunConfig
    from bdbnn_tpu_torch.train.loop import select_hooked_paths, shape_tree
    from bdbnn_tpu_torch.train.optim import make_optimizer
    from bdbnn_tpu_torch.train.state import StepConfig, TrainState
    from bdbnn_tpu_torch.train.step import make_train_step

    model = treg.create_model("resnet8_tiny", "cifar10", dtype="bfloat16",
                              generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, dataset="imagenet", lr=1e-3, epochs=1, steps_per_epoch=1)
    hooked = select_hooked_paths(shape_tree(model), RunConfig(w_kurtosis=True))
    cfg = StepConfig(w_kurtosis=True, kurt_paths=hooked, kurt_targets=(1.8,) * len(hooked),
                     w_lambda_kurtosis=1.0)
    step = make_train_step(model, opt, cfg)
    x = torch.from_numpy(np.random.default_rng(25).normal(size=(4, 16, 16, 3)).astype(np.float32))
    state, metrics = step(TrainState(model=model, optimizer=opt, step=0),
                          (x, torch.tensor([1, 2, 3, 4])), (), 1.0)
    assert state.step == 1
    for k in ("loss", "loss_ce", "loss_kurt"):
        assert metrics[k].dtype == torch.float32 and bool(torch.isfinite(metrics[k])), k
    assert {t.dtype for t in model.state_dict().values()} == {torch.float32}
    for s in opt.state.values():
        assert all(v.dtype == torch.float32 for v in s.values() if torch.is_tensor(v))

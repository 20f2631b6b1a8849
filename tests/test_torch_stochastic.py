"""The stochastic binarizer family in training: the port against the JAX
package on the CPU, both fed the same uniform draws ``u`` (made with
numpy: the port's ``torch.rand`` cannot give ``jax.random``'s values, and
does not try to).

- Plain K1 with ``u`` (and the plain versions of K1's and K6's sign
  passes) against ``stoch_sign`` then ``binary_conv2d_mxu``: bitwise
  (every ±1 dot is an exact integer and alpha the same f32 array).
- Plain K6 with ``u`` against ``jax.vjp``'s dW of the same forward, within
  the summation bound of ``tests/test_torch_train_kernels.py``:
  ``8·2⁻²⁴·Σ|terms| + 2⁻²⁴·|ref|`` (exact products, sums in other
  orders). dW with ``u`` differs from dW without it by far more than that
  bound, so a K6 that took the hard sign would fail.
- The draws: the same ``(seed, step)`` gives the same masks bitwise and
  another step others; the mean sampled sign per bin of ``x`` is
  ``clip(x, -1, 1)`` within 5σ.
- One whole train step of ``resnet8_tiny`` (CIFAR, SGD-cosine) and of a
  narrow ``step2`` ResNet (ImageNet stem, hardtanh, Adam-linear,
  ``--w-kurtosis``) against ``make_train_step``: the port's step draws
  through an injected source, and the JAX step gets the same draws in
  module order from a monkeypatched ``jax.random.uniform`` (the function
  ``bdbnn_tpu/nn/binarize.py`` samples with; nothing in ``bdbnn_tpu/``
  changes). A draw within 1e-4 of its threshold ``hard_sigmoid(x)`` is
  moved 1e-4 away from it (``chip_smoke.MarginDraws``), so the last-ulp
  differences of the two packages' activations cannot flip a sample.
  Held as ROADMAP C holds a step: the loss terms to rtol 1e-5, every gradient to 1e-3 of its
  tensor's largest |entry|, the batch statistics to rtol 1e-5 with 1e-4
  of the tensor's largest |entry|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.losses.kd import softmax_cross_entropy as jax_ce
from bdbnn_tpu.models import registry as jreg
from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn.kernels import binary_conv2d_mxu as jax_binary_conv2d_mxu
from bdbnn_tpu.train import StepConfig as JStepConfig
from bdbnn_tpu.train import TrainState as JTrainState
from bdbnn_tpu.train import make_optimizer as jax_make_optimizer
from bdbnn_tpu.train import make_train_step as jax_make_train_step
from bdbnn_tpu.train.step import _regularization_terms
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.models import registry as treg
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn import binarize as tb
from bdbnn_tpu_torch.nn.kernels import (
    binary_conv2d,
    binary_conv2d_wgrad,
    binary_conv2d_wgrad_plain,
    weight_binarize,
)
from bdbnn_tpu_torch.nn.kernels.binary_conv import act_sign_int8, binarize_input, wgrad_sign_bf16
from bdbnn_tpu_torch.train import optim as toptim
from bdbnn_tpu_torch.train.config import RunConfig
from bdbnn_tpu_torch.train.loop import select_hooked_paths, shape_tree
from bdbnn_tpu_torch.train.state import StepConfig, TrainState
from bdbnn_tpu_torch.train.step import make_train_step
from chip_smoke import MarginDraws

U = 2.0**-24
GRAD_TOL = 1e-3

# (N, H, W, C, O, k, stride)
CONV_CASES = [(2, 8, 8, 5, 6, 3, 1), (2, 9, 7, 4, 5, 3, 2), (2, 5, 5, 7, 3, 1, 1)]
IDS = ["3x3s1", "3x3s2-odd", "1x1"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(case, seed):
    n, h, w, c, o, k, s = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.8, size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0
    u = rng.uniform(size=x.shape).astype(np.float32)
    wt = rng.normal(0, 0.5, (k, k, c, o)).astype(np.float32)
    wt.reshape(-1)[::9] *= 4.0  # some latent weights beyond the STE clip
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    g = rng.normal(size=(n, ho, wo, o)).astype(np.float32)
    return x, u, wt, g


def _jax_forward(stride):
    fam = jb.make_family("stochastic")

    def f(x, u, w):
        alpha = jax.lax.stop_gradient(fam.weight_alpha(w))
        return jax_binary_conv2d_mxu(jb.stoch_sign(x, u), fam.weight_sign(w), alpha,
                                     strides=(stride, stride))

    return f


@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_k1_plain_with_u_bitwise_vs_stoch_sign_then_mxu(case):
    x, u, wt, _ = _operands(case, seed=CONV_CASES.index(case))
    stride, c = case[6], case[3]
    y_ref = np.asarray(_jax_forward(stride)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(wt)))
    jalpha = np.asarray(jb.make_family("stochastic").weight_alpha(jnp.asarray(wt)))
    xt, ut = _t(x), _t(u)
    wsign, _ = weight_binarize(_t(wt))
    y = binary_conv2d(xt, wsign, _t(jalpha), strides=(stride, stride), u=ut)
    assert np.array_equal(y.numpy().view(np.uint32), y_ref.view(np.uint32))
    # the prep passes' plain versions: the sampled sign, zero beyond C
    signs = np.asarray(jb.stoch_sign(jnp.asarray(x), jnp.asarray(u)))
    s8 = act_sign_int8(xt, None, 32, ut).numpy()
    sb = wgrad_sign_bf16(xt, None, 8, ut).float().numpy()
    assert np.array_equal(s8[..., :c], signs.astype(np.int8)) and not s8[..., c:].any()
    assert np.array_equal(sb[..., :c], signs) and not sb[..., c:].any()
    # the sampled sign is not the hard sign here
    assert not np.array_equal(signs, np.where(x >= 0, 1.0, -1.0))


@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_k6_plain_with_u_vs_jax_vjp(case):
    x, u, wt, g = _operands(case, seed=10 + CONV_CASES.index(case))
    stride = case[6]
    _, vjp = jax.vjp(_jax_forward(stride), jnp.asarray(x), jnp.asarray(u), jnp.asarray(wt))
    rdw = np.asarray(vjp(jnp.asarray(g))[2])
    jalpha = _t(np.asarray(jb.make_family("stochastic").weight_alpha(jnp.asarray(wt))))
    xt, ut, wtt, gt = _t(x), _t(u), _t(wt), _t(g)
    st = (stride, stride)
    dw = binary_conv2d_wgrad(gt, xt, wtt, jalpha, strides=st, u=ut).numpy()
    # x = 1 gives |sign| = 1 at every real tap and 0 in the padding; w = 0
    # opens every STE mask
    terms = binary_conv2d_wgrad_plain(gt.abs(), torch.ones_like(xt), torch.zeros_like(wtt),
                                      jalpha.abs(), strides=st).numpy()
    bound = 8 * U * terms + U * np.abs(rdw) + 1e-30
    assert dw.shape == rdw.shape
    assert np.all(np.abs(dw - rdw) <= bound), np.max(np.abs(dw - rdw) - bound)
    assert np.any(rdw == 0) and np.any(rdw != 0)  # the STE mask is exercised
    # K6's trap: dW against the hard sign is another function, far beyond
    # the bound, so a K6 that ignored u could not pass the check above
    hard = binary_conv2d_wgrad(gt, xt, wtt, jalpha, strides=st).numpy()
    assert np.any(np.abs(hard - rdw) > 100 * bound)


def test_a_draw_never_comes_with_a_shift():
    x = torch.zeros(1, 3, 3, 4)
    wsign, alpha = weight_binarize(torch.ones(3, 3, 4, 2))
    with pytest.raises(ValueError, match="shift"):
        binary_conv2d(x, wsign, alpha, shift=torch.zeros(4), u=torch.zeros_like(x))
    with pytest.raises(ValueError, match="u must be"):
        binary_conv2d(x, wsign, alpha, u=torch.zeros(1, 3, 3, 3))


def test_same_seed_and_step_give_the_same_masks():
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (4, 6, 6, 8)).astype(np.float32))
    masks = {}
    for seed, step in [(7, 3), (7, 3), (7, 4), (8, 3)]:
        draws = tb.StepDraws(seed, step)
        masks.setdefault((seed, step), []).append(
            torch.cat([binarize_input(x, None, draws(x)).reshape(-1) for _ in range(2)]))
    a, b = masks[(7, 3)]
    assert torch.equal(a, b)
    assert not torch.equal(a, masks[(7, 4)][0]) and not torch.equal(a, masks[(8, 3)][0])
    # the two convs of one step draw differently
    half = a.numel() // 2
    assert not torch.equal(a[:half], a[half:])
    lo, hi = np.random.SeedSequence([7, 3]).generate_state(2, np.uint32)
    assert tb.step_seed(7, 3) == int(lo) | (int(hi) << 32)


def test_mean_sampled_sign_is_clipped_identity():
    """E[stoch_sign(x)] = 2·hard_sigmoid(x) − 1 = clip(x, −1, 1): per bin
    of x the mean of N samples lies within 5σ, σ = sqrt((1 − m²)/N)."""
    centers = np.linspace(-1.5, 1.5, 31).astype(np.float32)
    n = 20000
    x = torch.from_numpy(np.repeat(centers, n).reshape(1, 31, n, 1))
    s = binarize_input(x, None, tb.StepDraws(11, 0)(x)).reshape(31, n).double()
    m = np.clip(centers.astype(np.float64), -1.0, 1.0)
    sigma = np.sqrt((1.0 - m * m) / n)
    mean = s.mean(dim=1).numpy()
    assert np.all(np.abs(mean - m) <= 5 * sigma + 1e-12), np.max(np.abs(mean - m) / (sigma + 1e-30))


# -- one whole train step --------------------------------------------------------


def _seeded_tree(flax_model, image_shape, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros((1, *image_shape)), train=False),
        jax.random.PRNGKey(0),
    )

    def draw(path, sd):
        name, shape = path[-1].key, sd.shape
        if name in ("float_weight", "weight", "kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(1.0, 3.0, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(draw, dict(shapes)))


def _replay(monkeypatch, drawn):
    """Patch the jax.random.uniform the reference samples with: it returns
    the recorded draws in module order; returns the queue."""
    queue = list(drawn)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = queue.pop(0)
        assert tuple(shape) == u.shape
        return jnp.asarray(u, dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    return queue


STEP_CASES = {
    # id: (flax model, port model, image shape, dataset, opt policy, lr, kurtosis)
    "cifar-sgd": (
        lambda: jreg.create_model("resnet8_tiny", "cifar10"),
        lambda: treg.create_model("resnet8_tiny", "cifar10"),
        (16, 16, 3), "cifar10", "sgd-cosine", 0.02, False),
    "step2-adam-kurt": (
        lambda: jres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="step2", act="hardtanh"),
        lambda: tres.BiResNet((1, 1), 10, width=8, stem="imagenet", variant="step2", act="hardtanh"),
        (32, 32, 3), "imagenet", "adam-linear", 1e-3, True),
}


@pytest.mark.parametrize("case_id", list(STEP_CASES))
def test_one_stochastic_train_step_matches_make_train_step(case_id, monkeypatch):
    make_j, make_t, shape, dataset, policy, lr, kurt = STEP_CASES[case_id]
    jmodel, port = make_j(), make_t()
    tree = _seeded_tree(jmodel, shape, seed=3)
    port.from_flax(tree)
    hooked = select_hooked_paths(shape_tree(port), RunConfig(w_kurtosis=True)) if kurt else ()
    common = dict(
        w_kurtosis=kurt, kurt_paths=hooked, kurt_targets=tuple(1.2 + 0.1 * i for i in range(len(hooked))),
        w_lambda_kurtosis=0.5, binarizer="stochastic", binarizer_stochastic=True, rng_seed=5,
    )
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, *shape)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)

    prev_j, prev_t = jb.get_active_family(), tb.get_active_family()
    jb.set_active_family("stochastic")
    tb.set_active_family("stochastic")
    try:
        # the port's step, its draws recorded
        draws = MarginDraws(seed=17)
        opt = toptim.make_optimizer(port, dataset=dataset, lr=lr, epochs=2, steps_per_epoch=4,
                                    policy=policy)
        tstep = make_train_step(port, opt, StepConfig(**common), draws=lambda step: draws)
        _, tm = tstep(TrainState(port, opt), (_t(x), _t(y).long()), (1.0, 1.0), 1.0)
        tgrads = {n: p.grad.clone() for n, p in port.named_parameters()}
        tbuf = {k: v.clone() for k, v in port.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        n_convs = len(draws.drawn)
        assert n_convs >= 5

        # the JAX step, fed the same draws
        tx = jax_make_optimizer(tree["params"], dataset=dataset, lr=lr, epochs=2,
                                steps_per_epoch=4, policy=policy)
        jcfg = JStepConfig(**common)
        queue = _replay(monkeypatch, draws.drawn)
        jstep = jax.jit(jax_make_train_step(jmodel, tx, jcfg))
        jstate, jm = jstep(JTrainState.create(tree, tx), (jnp.asarray(x), jnp.asarray(y)),
                           (jnp.float32(1), jnp.float32(1)), jnp.float32(1.0))
        jm, jvars = jax.device_get(jm), jax.device_get(jstate.variables)
        assert not queue, f"{len(queue)} draws left: the reference sampled {n_convs - len(queue)}"

        # the reference's gradients, from its own loss with the same draws
        queue = _replay(monkeypatch, draws.drawn)
        jcfg_r = jcfg.resolved()

        def loss_fn(params):
            logits, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                     jnp.asarray(x), train=True, mutable=["batch_stats"],
                                     rngs={"binarize": jax.random.PRNGKey(0)})
            reg, _ = _regularization_terms(params, jcfg_r, jnp.float32(1.0))
            return jax_ce(logits, jnp.asarray(y)) + reg

        jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(tree["params"]))
        assert not queue
    finally:
        jb.set_active_family(prev_j)
        tb.set_active_family(prev_t)

    for key in ("loss", "loss_ce") + (("loss_kurt",) if kurt else ()):
        np.testing.assert_allclose(tm[key].numpy(), jm[key], rtol=1e-5, err_msg=key)
    ref_g = flax_to_state_dict({"params": jgrads, "batch_stats": tree["batch_stats"]})
    assert set(tgrads) <= set(ref_g)
    for name, g in tgrads.items():
        want = ref_g[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)
    ref_sd = flax_to_state_dict(jvars)
    for name, v in tbuf.items():
        want = ref_sd[name].numpy()
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)

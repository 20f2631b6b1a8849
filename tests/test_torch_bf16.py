"""The port's bf16 modes against the JAX package's bf16 computations, on
the CPU through the kernels' plain versions:

- K1 (``binary_conv2d_mxu`` on bf16 ±1 operands) — bitwise, with dots
  above 256 where one rounding of ``dot·alpha`` would differ: the
  reference rounds the dot to bf16, then its bf16 multiply rounds again;
- K2 (``weight_binarize(..., dtype=bf16)``) against ``weight_sign`` /
  ``weight_alpha`` of ``w.astype(bf16)`` — the sign bitwise (a negative
  subnormal rounds to -0, whose sign is +1), alpha within one bf16 ulp
  (the reference sums in f32, the port in f64);
- the binary conv's forward and backward (``BinaryConvFn``: K1, K5, K6)
  against ``jax.vjp`` of the reference's layer for every estimator and
  the stochastic draw: y bitwise, dx and dW within one bf16 ulp at every
  entry (sums in another order, then one bf16 rounding); react's shift
  gradient within the error of the reference's XLA:CPU reduction, which
  adds the N·H·W bf16 terms in bf16 one at a time;
- BatchNorm, RPReLU and the react residual block in bf16 against flax.

The whole bf16 models are held in ``tests/test_torch_bf16_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from bdbnn_tpu.models import resnet as jres
from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn import layers as jlayers
from bdbnn_tpu.nn.kernels import binary_conv2d_mxu as jax_mxu
from bdbnn_tpu_torch.bridge import flax_to_state_dict
from bdbnn_tpu_torch.models import resnet as tres
from bdbnn_tpu_torch.nn import layers as tlayers
from bdbnn_tpu_torch.nn.kernels import (
    binary_conv2d_mxu,
    binary_conv2d_plain,
    weight_binarize,
)
from bdbnn_tpu_torch.nn.kernels.binary_conv import BinaryConvFn

BF = torch.bfloat16
JBF = jnp.bfloat16


def to_t(a) -> torch.Tensor:
    """A JAX array (f32 or bf16) as a torch tensor of the same dtype, exactly."""
    a = jnp.asarray(a)
    out = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return out.to(BF) if a.dtype == JBF else out


def bf16_ulps(got, ref) -> np.ndarray:
    """|got - ref| in units of the bf16 ulp of max(|got|, |ref|) (each
    entry a bf16 value); 0 where both are zero."""
    a = np.asarray(torch.as_tensor(got).detach().float(), np.float64)
    b = np.asarray(torch.as_tensor(ref).detach().float() if isinstance(ref, torch.Tensor)
                   else np.asarray(jnp.asarray(ref).astype(jnp.float32)), np.float64)
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return np.where(m > 0, np.abs(a - b) / ulp, 0.0)


# -- K1 ------------------------------------------------------------------

# (N, H, W, C, O, k, stride): K = k·k·C up to 2304 (dots well above 256)
K1_CASES = [(2, 8, 8, 256, 32, 3, 1), (2, 9, 9, 64, 48, 3, 2), (2, 6, 6, 40, 70, 1, 1)]


@pytest.mark.parametrize("case", K1_CASES, ids=["k2304", "s2", "1x1"])
def test_k1_bf16_bitwise_vs_reference_with_dots_above_256(case):
    n, h, w, c, o, k, s = case
    rng = np.random.default_rng(11)
    # biased signs, so that many dots exceed 256 in magnitude
    xb = np.where(rng.random((n, h, w, c)) < 0.8, 1.0, -1.0).astype(np.float32)
    wb = np.where(rng.random((k, k, c, o)) < 0.8, 1.0, -1.0).astype(np.float32)
    alpha = jnp.asarray(rng.uniform(0.01, 0.3, o).astype(np.float32)).astype(JBF)
    ref = jax_mxu(jnp.asarray(xb, JBF), jnp.asarray(wb, JBF), alpha, strides=(s, s))
    assert ref.dtype == JBF
    got = binary_conv2d_mxu(torch.from_numpy(xb).to(BF), torch.from_numpy(wb).to(BF),
                            to_t(alpha), strides=(s, s))
    assert got.dtype == BF
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    # the double rounding is what matches: at K = 2304, one rounding of
    # dot·alpha misses some of the outputs whose dot exceeds 256
    dot = binary_conv2d_plain(torch.from_numpy(xb), weight_binarize(torch.from_numpy(wb))[0],
                              torch.ones(o), strides=(s, s))
    if c * k * k > 256:
        assert float(dot.abs().max()) > 256
    if c * k * k == 2304:
        once = (dot * to_t(alpha).float()).to(BF)
        assert not torch.equal(once, got)


# -- K2 ------------------------------------------------------------------


@pytest.mark.parametrize("family", ["ste", "lab"])
@pytest.mark.parametrize("shape", [(3, 3, 5, 4), (1, 1, 7, 3), (3, 3, 64, 16)])
def test_k2_bf16_sign_bitwise_alpha_within_one_ulp(family, shape):
    w = np.random.default_rng(12).normal(0, 0.05, shape).astype(np.float32)
    w.reshape(-1)[::7] = 0.0
    w.reshape(-1)[3::11] = -1e-40  # an f32 subnormal: bf16 rounds it to -0
    fam = jb.make_family(family)
    wj = jnp.asarray(w).astype(JBF)
    jsign = np.asarray(fam.weight_sign(wj).astype(jnp.float32))
    jalpha = fam.weight_alpha(wj)
    assert jalpha.dtype == JBF
    sign, alpha = weight_binarize(torch.from_numpy(w), lab=family == "lab", dtype=BF)
    assert sign.dtype == torch.int8 and alpha.dtype == BF
    np.testing.assert_array_equal(sign.permute(1, 2, 3, 0).numpy().astype(np.float32), jsign)
    assert (jsign.reshape(-1)[3::11] == 1.0).all()  # sign(-0) = +1
    assert bf16_ulps(alpha, jalpha).max() <= 1.0


# -- the binary conv: forward and backward through BinaryConvFn ------------

# (name, p0, p1) as the layers pass them; "stoch" is the stochastic
# family's draw with the ste backward; "approx" is react's (with a shift)
GRAD_ESTIMATORS = [("approx", 0.0, 0.0), ("ste", 0.0, 0.0), ("ede", 0.7, 1.5),
                   ("prox", 0.8, 0.0), ("stoch", 0.0, 0.0)]
GRAD_CASES = [(2, 8, 8, 64, 64, 3, 1), (2, 9, 9, 40, 24, 3, 2), (2, 6, 6, 32, 48, 1, 1)]


def _jax_layer(est, strides):
    name, p0, p1 = est
    fam = jb.make_family("ste")

    def layer(x, shift, latent, u):
        w = latent.astype(x.dtype)
        if name == "approx":
            xb = jb.approx_sign(x - shift.astype(x.dtype))
        elif name == "ste":
            xb = jb.ste_sign(x)
        elif name == "ede":
            xb = jb.ede_sign(x, jnp.asarray(p0, x.dtype), jnp.asarray(p1, x.dtype))
        elif name == "prox":
            xb = jb.prox_sign(x, jnp.asarray(p0, x.dtype))
        else:
            xb = jb.stoch_sign(x, u)
        alpha = jax.lax.stop_gradient(fam.weight_alpha(w))
        return jax_mxu(xb, fam.weight_sign(w), alpha, strides=strides)

    return layer


@pytest.mark.parametrize("est", GRAD_ESTIMATORS, ids=[e[0] for e in GRAD_ESTIMATORS])
@pytest.mark.parametrize("case", GRAD_CASES, ids=["3x3", "s2", "1x1"])
def test_binary_conv_bf16_forward_and_backward_vs_jax_vjp(case, est):
    n, h, w, c, o, k, s = case
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.normal(size=(n, h, w, c)).astype(np.float32)).astype(JBF)
    shift = jnp.asarray(rng.normal(0, 0.3, c).astype(np.float32))
    latent = rng.normal(0, 0.6, (k, k, c, o)).astype(np.float32)  # some |W| > 1
    latent.reshape(-1)[::13] = np.float32(1.0 + 2.0**-10)  # |W| > 1, bf16(W) = 1
    latent = jnp.asarray(latent)
    u = jax.random.uniform(jax.random.PRNGKey(14), x.shape, JBF)
    ho = (h + 2 * (k // 2) - k) // s + 1
    g = jnp.asarray(rng.normal(size=(n, ho, ho, o)).astype(np.float32)).astype(JBF)
    y, vjp = jax.vjp(_jax_layer(est, (s, s)), x, shift, latent, u)
    jdx, jdshift, jdw, _ = vjp(g)

    react, stoch = est[0] == "approx", est[0] == "stoch"
    xt = to_t(x).requires_grad_(True)
    shift_t = to_t(shift).requires_grad_(True)
    wt = to_t(latent).requires_grad_(True)
    wsign, _ = weight_binarize(wt.detach(), dtype=BF)
    # the reference's own alpha, so the check isolates the conv (K2's
    # alpha is held to it above)
    alpha = to_t(jb.make_family("ste").weight_alpha(latent.astype(JBF)))
    estimator = ("ste", 0.0, 0.0) if stoch else est
    got = BinaryConvFn.apply(xt, shift_t.to(BF) if react else None, wt, wsign, alpha, (s, s),
                             "auto", estimator, to_t(u) if stoch else None)
    got.backward(to_t(g))
    assert got.dtype == BF and xt.grad.dtype == BF and wt.grad.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().view(torch.int16).numpy(),
                                  np.asarray(y).view(np.int16))
    assert bf16_ulps(xt.grad, jdx).max() <= 1.0
    assert bf16_ulps(wt.grad.to(BF), jdw.astype(JBF)).max() <= 1.0
    assert torch.equal(wt.grad.to(BF).float(), wt.grad)  # dW holds bf16 values
    if react:
        # dshift = -Σ dx: the port sums the bf16 dx in f32 and rounds once;
        # XLA:CPU adds them in bf16 one at a time, each add rounding by up
        # to 2⁻⁹ of a partial sum no larger than Σ|dx|
        terms = xt.grad.float().abs().sum(dim=(0, 1, 2)).numpy()
        err = np.abs(shift_t.grad.numpy() - np.asarray(jdshift))
        assert (err <= n * h * w * 2.0**-9 * terms + 2.0**-8 * np.abs(np.asarray(jdshift))).all()


# -- BatchNorm, RPReLU and the residual block ------------------------------


def test_batchnorm_bf16_matches_flax():
    """f32 statistics of the bf16 input, an f32 normalize, one cast: the
    output within one bf16 ulp of flax's (the f32 means are summed in
    another order, which can move an f32 value across a bf16 rounding
    boundary); the running statistics to rtol 1e-6; the gradients of x
    (bf16) within one bf16 ulp of 2⁻⁸ of their largest, of scale and bias
    (f32) to rtol 1e-5 of their largest."""
    rng = np.random.default_rng(15)
    x = jnp.asarray(rng.normal(1.0, 2.0, size=(4, 6, 6, 16)).astype(np.float32)).astype(JBF)
    scale = jnp.asarray(rng.uniform(0.5, 2.0, 16).astype(np.float32))
    bias = jnp.asarray(rng.normal(0, 0.5, 16).astype(np.float32))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=JBF)
    stats = {"mean": jnp.zeros(16), "var": jnp.ones(16)}

    def apply(x, scale, bias):
        return bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                        mutable=["batch_stats"])

    out, upd = apply(x, scale, bias)
    gy = jnp.asarray(rng.normal(size=out.shape).astype(np.float32)).astype(JBF)
    _, vjp = jax.vjp(lambda *a: apply(*a)[0], x, scale, bias)
    jdx, jds, jdb = vjp(gy)

    mod = tlayers.BatchNorm(16)
    with torch.no_grad():
        mod.weight.copy_(to_t(scale))
        mod.bias.copy_(to_t(bias))
    xt = to_t(x).requires_grad_(True)
    got = mod.train()(xt)
    got.backward(to_t(gy))
    assert got.dtype == BF and mod.running_mean.dtype == torch.float32
    assert bf16_ulps(got, out).max() <= 1.0
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    jdx32 = np.asarray(jdx.astype(jnp.float32))
    assert np.abs(xt.grad.float().numpy() - jdx32).max() <= 2.0**-8 * np.abs(jdx32).max()
    for got_g, ref_g in ((mod.weight.grad, jds), (mod.bias.grad, jdb)):
        ref_g = np.asarray(ref_g)
        np.testing.assert_allclose(got_g.numpy(), ref_g, rtol=0, atol=1e-5 * np.abs(ref_g).max())


def test_rprelu_bf16_bitwise_vs_flax():
    """Forward and dx bitwise (each bf16 op rounds once in both); the
    per-channel gradients within the error of the reference's XLA:CPU
    reduction, which adds the N·H·W bf16 terms in bf16 one at a time:
    n·2⁻⁹·Σ|terms| plus one rounding."""
    rng = np.random.default_rng(16)
    x = jnp.asarray(rng.normal(size=(2, 5, 5, 12)).astype(np.float32)).astype(JBF)
    params = {"gamma": jnp.asarray(rng.normal(0, 0.3, 12).astype(np.float32)),
              "zeta": jnp.asarray(rng.normal(0, 0.3, 12).astype(np.float32)),
              "slope": jnp.asarray(rng.uniform(0.1, 0.4, 12).astype(np.float32))}
    ref, vjp = jax.vjp(lambda p, x: jlayers.RPReLU().apply({"params": p}, x), params, x)
    gy = jnp.asarray(rng.normal(size=ref.shape).astype(np.float32)).astype(JBF)
    jgrads, jdx = vjp(gy)
    mod = tlayers.RPReLU(12)
    with torch.no_grad():
        for k, v in params.items():
            getattr(mod, k).copy_(to_t(v))
    xt = to_t(x).requires_grad_(True)
    got = mod(xt)
    got.backward(to_t(gy))
    assert ref.dtype == JBF and got.dtype == BF
    np.testing.assert_array_equal(got.detach().view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    np.testing.assert_array_equal(xt.grad.view(torch.int16).numpy(), np.asarray(jdx).view(np.int16))
    g = to_t(gy).float()
    y = (xt.detach() - mod.gamma.detach().to(BF)).float()
    terms = {"gamma": xt.grad.float().abs(), "zeta": g.abs(), "slope": (g * y).abs() * (y < 0)}
    n = 2 * 5 * 5
    for k, t in terms.items():
        want = np.asarray(jgrads[k])
        bound = n * 2.0**-9 * t.sum(dim=(0, 1, 2)).numpy() + 2.0**-8 * np.abs(want)
        assert (np.abs(getattr(mod, k).grad.numpy() - want) <= bound).all(), k


def _seeded_tree(flax_model, image_shape, seed, dtype_input=jnp.float32):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: flax_model.init(k, jnp.zeros((1, *image_shape), dtype_input), train=False),
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
        if name == "slope":
            return rng.uniform(0.1, 0.4, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(draw, dict(shapes)))


def test_react_residual_block_bf16_matches_flax():
    """The react block (downsample, BN, RPReLU, two residual units) in bf16
    training mode. Its first unit's convs read the same bf16 input as the
    reference's, so their outputs are bitwise; BN's f32 means (another
    summation order) can then move a value by one bf16 ulp, and the second
    conv's input signs see the values the port computed. The output is
    held to 2 bf16 ulps of the block's largest |output| wherever no sign
    of the second unit's input crossed its threshold, and the running
    statistics to rtol 1e-5."""
    jblock = jres.BiBasicBlock(features=32, strides=2, variant="react", act="rprelu", dtype=JBF)
    x = jnp.asarray(np.random.default_rng(17).normal(size=(2, 8, 8, 16)).astype(np.float32))
    xb = x.astype(JBF)
    tree = _seeded_tree(jblock, (8, 8, 16), 18)
    tree = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    ref, upd = jblock.apply(tree, xb, True, mutable=["batch_stats"])
    tblock = tres.BiBasicBlock(16, 32, 2, "react", "rprelu")
    tblock.load_state_dict(flax_to_state_dict(tree), strict=True)
    inputs = []
    hook = tblock.conv2.register_forward_pre_hook(lambda m, a: inputs.append(a[0].detach()))
    got = tblock.train()(to_t(xb))
    hook.remove()
    assert got.dtype == BF
    scale = float(np.abs(np.asarray(ref.astype(jnp.float32))).max())
    err = np.abs(got.detach().float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert err.max() <= 2 * 2.0**-7 * scale
    want = flax_to_state_dict({"params": tree["params"], "batch_stats": upd["batch_stats"]})
    for k, v in tblock.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)

"""Parity of the port's training kernels with the JAX primitives they
replace, on the CPU through each kernel's plain PyTorch version:

- K5 ``binary_conv2d_dgrad`` and K6 ``binary_conv2d_wgrad`` against
  ``jax.vjp`` of ``family act (x - shift)`` → ``binary_conv2d_mxu`` with
  ``ste_sign(W)`` and the detached alpha, for the ste, approx, ede and
  prox estimators, at 3×3 s1, 3×3 s2 with odd H/W, and 1×1. The products
  are exact (±1 · f32) and the sums run in another order, so each element
  is held to a summation bound: each side within ``4·2⁻²⁴·Σ|terms|`` of
  the exact sum, so ``|port − ref| ≤ 8·2⁻²⁴·Σ|terms|·|slope| +
  2⁻²⁴·|ref| + 1e-30`` (the last for the slope multiply's rounding), with
  Σ|terms| the plain version's sum over |operands|. EDE's slope goes
  through ``cosh``, whose last ulps differ between XLA and torch
  (ROADMAP C), so it also gets ``1e-6·|ref|``.
- The padding pin: a padding tap adds 0 to dW and receives nothing in dx,
  never ``sign(0 − shift)``.
- ``BinaryConvFn`` (K1 + K5 + K6 through autograd) through the port's
  layer against the flax layer's ``jax.vjp``: x, act_shift and the latent
  weight, to the same bound.
- K7 ``kurtosis_grouped`` against ``jax.value_and_grad(
  kurtosis_regularization)`` for avg / sum / max, including mean offsets
  and the μ = −8, σ = 0.05 case that breaks the raw-moment form: the
  reference sums in f32, the port in f64 and rounds once, so the loss is
  held to rtol 5e-6 and each gradient to 1e-5 of its largest |entry|
  (offset cases 1e-3: at μ = −8, σ = 0.05 the f32 ``w − mean(w)`` keeps
  about 16 significant bits of each deviation, and the reference's
  gradient differs from the port's by 1.0e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.losses import kurtosis as jk
from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn import layers as jl
from bdbnn_tpu.nn.kernels import binary_conv2d_mxu as jax_binary_conv2d_mxu
from bdbnn_tpu_torch.nn import binarize as tb
from bdbnn_tpu_torch.nn import layers as tl
from bdbnn_tpu_torch.nn.kernels import (
    binary_conv2d_dgrad,
    binary_conv2d_dgrad_plain,
    binary_conv2d_plain,
    binary_conv2d_wgrad,
    binary_conv2d_wgrad_plain,
    kurtosis_grouped,
    kurtosis_grouped_plain,
    weight_binarize,
)
from bdbnn_tpu_torch.nn.kernels.binary_conv import WGRAD_M_STAGE, estimator_slope, wgrad_splits
from bdbnn_tpu_torch.losses import kurtosis as tk

U = 2.0**-24

# (N, H, W, C, O, k, stride, react shift)
CONV_CASES = [
    (2, 8, 8, 5, 6, 3, 1, True),     # 3x3 s1
    (2, 9, 7, 4, 5, 3, 2, True),     # 3x3 s2, odd non-square H/W
    (2, 5, 5, 7, 3, 1, 1, False),    # 1x1
]
IDS = ["3x3s1", "3x3s2-odd", "1x1"]
# estimator -> (flax family, schedule, K5 estimator triple)
FAMILIES = {
    "ste": ("ste", None, ("ste", 0.0, 0.0)),
    "approx": ("approx", None, ("approx", 0.0, 0.0)),
    "ede": ("ede", (0.7, 1.5), ("ede", 0.7, 1.5)),
    "prox": ("proximal", (0.8,), ("prox", 0.8, 0.0)),
}


def _operands(case, seed):
    n, h, w, c, o, k, s, react = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.8, size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::13] = 0.0
    shift = rng.normal(0, 0.3, c).astype(np.float32) if react else None
    wt = rng.normal(0, 0.5, (k, k, c, o)).astype(np.float32)
    wt.reshape(-1)[::9] *= 4.0  # some latent weights beyond the STE clip
    ho = (h + 2 * (k // 2) - k) // s + 1
    wo = (w + 2 * (k // 2) - k) // s + 1
    g = rng.normal(size=(n, ho, wo, o)).astype(np.float32)
    return x, shift, wt, g


def _jax_vjp(x, shift, wt, g, stride, family, sched):
    fam = jb.make_family(family)

    def f(x, shift, w):
        v = x - shift if shift is not None else x
        xb = fam.binarize_act(v, sched=sched)
        alpha = jax.lax.stop_gradient(fam.weight_alpha(w))
        return jax_binary_conv2d_mxu(xb, fam.weight_sign(w), alpha, strides=(stride, stride))

    sh = jnp.asarray(shift) if shift is not None else None
    y, vjp = jax.vjp(f, jnp.asarray(x), sh, jnp.asarray(wt))
    dx, dshift, dw = vjp(jnp.asarray(g))
    alpha = np.asarray(fam.weight_alpha(jnp.asarray(wt)))
    return np.asarray(dx), (None if shift is None else np.asarray(dshift)), np.asarray(dw), alpha


def _t(a):
    return torch.from_numpy(np.array(a)) if a is not None else None


def _dgrad_bound(g, x, wsign, alpha, shift, stride, est, ref):
    terms = binary_conv2d_dgrad_plain(
        g.abs(), x, torch.ones_like(wsign), alpha.abs(), shift=shift, strides=(stride, stride)
    )
    slope = estimator_slope(x - shift if shift is not None else x, est)
    return 8 * U * (terms * slope.abs()).numpy() + U * np.abs(ref) + 1e-30


def _wgrad_bound(g, x, w, alpha, stride, ref):
    # x = 1 gives |sign| = 1 at every real tap and 0 in the padding; w = 0
    # opens every STE mask
    terms = binary_conv2d_wgrad_plain(g.abs(), torch.ones_like(x), torch.zeros_like(w),
                                      alpha.abs(), strides=(stride, stride))
    return 8 * U * terms.numpy() + U * np.abs(ref) + 1e-30


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_k5_k6_plain_vs_jax_vjp(case, family):
    x, shift, wt, g = _operands(case, seed=10 * list(FAMILIES).index(family) + CONV_CASES.index(case))
    stride = case[6]
    if family != "approx":
        shift = None  # the family-routed convs have no shift
    fam_name, sched, est = FAMILIES[family]
    rdx, rdshift, rdw, jalpha = _jax_vjp(x, shift, wt, g, stride, fam_name, sched)
    xt, st, wtt, gt, at = _t(x), _t(shift), _t(wt), _t(g), _t(jalpha)
    wsign, _ = weight_binarize(wtt)
    dx = binary_conv2d_dgrad(gt, xt, wsign, at, shift=st, strides=(stride, stride), estimator=est)
    dw = binary_conv2d_wgrad(gt, xt, wtt, at, shift=st, strides=(stride, stride))
    bx = _dgrad_bound(gt, xt, wsign, at, st, stride, est, rdx)
    if family == "ede":
        bx = bx + 1e-6 * np.abs(rdx)
    bw = _wgrad_bound(gt, xt, wtt, at, stride, rdw)
    assert dx.shape == rdx.shape and dw.shape == rdw.shape
    assert np.all(np.abs(dx.numpy() - rdx) <= bx), np.max(np.abs(dx.numpy() - rdx) - bx)
    assert np.all(np.abs(dw.numpy() - rdw) <= bw), np.max(np.abs(dw.numpy() - rdw) - bw)
    assert np.any(rdw == 0) and np.any(rdw != 0)  # the STE mask is exercised
    if shift is not None:
        ref_terms = np.sum(bx, axis=(0, 1, 2))
        assert np.all(np.abs(-dx.sum(dim=(0, 1, 2)).numpy() - rdshift) <= ref_terms * 2 + 1e-6)


def test_k5_k6_padding_taps_add_nothing():
    """x - shift > 0 everywhere, so sign(0 - shift) = -1 would show: a
    padding tap must add 0 to dW and dx must count only real taps."""
    x = torch.full((1, 3, 3, 2), 5.0)
    shift = torch.full((2,), 1.0)
    w = torch.full((3, 3, 2, 1), 0.5)
    g = torch.ones((1, 3, 3, 1))
    alpha = torch.ones(1)
    wsign, _ = weight_binarize(w)
    taps = np.array([[4, 6, 4], [6, 9, 6], [4, 6, 4]], np.float32)
    dw = binary_conv2d_wgrad(g, x, w, alpha, shift=shift).numpy()
    np.testing.assert_array_equal(dw[:, :, 0, 0], taps)
    np.testing.assert_array_equal(dw[:, :, 1, 0], taps)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift).numpy()
    np.testing.assert_array_equal(dx[0, :, :, 0], taps)


@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_binary_conv_fn_through_layer_vs_flax(case):
    """The port's BinaryConvReact in training (K2 → K1, K5 + K6) against
    the flax module's vjp from the same weights: dx, d act_shift, dW."""
    x, shift, wt, g = _operands(case, seed=11)
    n, h, w, c, o, k, s, _ = case
    shift = np.random.default_rng(3).normal(0, 0.3, c).astype(np.float32)
    mod = jl.BinaryConvReact(o, kernel_size=(k, k), strides=(s, s))
    params = {"params": {"float_weight": jnp.asarray(wt), "act_shift": jnp.asarray(shift)}}

    def f(p, xx):
        return mod.apply(p, xx)

    y, vjp = jax.vjp(f, params, jnp.asarray(x))
    dp, rdx = vjp(jnp.asarray(g))
    port = tl.BinaryConvReact(c, o, (k, k), (s, s)).train()
    with torch.no_grad():
        port.float_weight.copy_(_t(wt))
        port.act_shift.copy_(_t(shift))
    xt = _t(x).requires_grad_(True)
    yt = port(xt)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=2e-6, atol=0)
    yt.backward(_t(g))
    wsign, alpha = weight_binarize(_t(wt))
    st = _t(shift)
    rdw = np.asarray(dp["params"]["float_weight"])
    bx = _dgrad_bound(_t(g), _t(x), wsign, alpha, st, s, ("approx", 0, 0), rdx) + 2e-6 * np.abs(rdx)
    bw = _wgrad_bound(_t(g), _t(x), _t(wt), alpha, s, rdw) + 2e-6 * np.abs(rdw)
    assert np.all(np.abs(xt.grad.numpy() - np.asarray(rdx)) <= bx)
    assert np.all(np.abs(port.float_weight.grad.numpy() - np.asarray(dp["params"]["float_weight"])) <= bw)
    np.testing.assert_allclose(
        port.act_shift.grad.numpy(), np.asarray(dp["params"]["act_shift"]),
        rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(rdx)).sum()),
    )


def test_layer_routes_the_family_estimator():
    conv = tl.BinaryConvCifar(4, 4)
    cases = [("ste", None, ("ste", 0.0, 0.0)), ("ste", (0.5, 2.0), ("ede", 0.5, 2.0)),
             ("ede", (0.5, 2.0), ("ede", 0.5, 2.0)), ("approx", None, ("approx", 0.0, 0.0)),
             ("proximal", (0.7,), ("prox", 0.7, 0.0)), ("lab", None, ("ste", 0.0, 0.0))]
    for fam, sched, want in cases:
        with tb.active_family(fam):
            assert conv.train_estimator(sched) == want
    assert tl.BinaryConvReact(4, 4).train_estimator((0.5, 2.0)) == ("approx", 0.0, 0.0)
    # the stochastic family: the ste backward of stoch_sign; in training
    # the conv takes the installed draw's sampled sign, else the hard sign
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(0, 0.7, (1, 4, 4, 4)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(1, 4, 4, 4)).astype(np.float32))
    wsign, alpha = weight_binarize(conv.float_weight.detach())
    with tb.active_family("stochastic"):
        assert conv.train_estimator(None) == ("ste", 0.0, 0.0)
        with torch.no_grad():
            sampled = conv.train().forward(x, None, lambda v: u)
        with torch.no_grad():
            hard = conv.forward(x)
    assert torch.equal(sampled, binary_conv2d_plain(x, wsign, alpha, u=u))
    assert torch.equal(hard, binary_conv2d_plain(x, wsign, alpha))
    assert not torch.equal(sampled, hard)


def test_wgrad_splits_cover_every_row():
    # the ten flagship convs at -b 256 as K6 sees them (m, kh·kw·CP, O),
    # then odd sizes
    flagship = [(802816, 576, 64), (200704, 576, 128), (200704, 64, 128), (200704, 1152, 128),
                (50176, 1152, 256), (50176, 128, 256), (50176, 2304, 256), (12544, 2304, 512),
                (12544, 256, 512), (12544, 4608, 512)]
    odd = [(100352, 576, 64), (1568, 4608, 512), (7, 9, 3), (25088, 64, 128), (1, 8, 1),
           (33, 72, 70), (1000003, 576, 64)]
    for m, kd, o in flagship + odd:
        splits, rows = wgrad_splits(m, kd, o)
        # split z reduces positions [z·rows, min(m, (z+1)·rows)): each one
        # non-empty, a grid's z extent at most 65535, one split up to 512
        assert rows % WGRAD_M_STAGE == 0 and splits * rows >= m and (splits - 1) * rows < m
        assert 1 <= splits <= min(65535, max(1, -(-m // 512)))


# -- K7 ---------------------------------------------------------------------

def _kurt_tensors(kind):
    rng = np.random.default_rng(5)
    if kind == "offset":
        # the offsets of tests/test_kurtosis.py (0, 0.5, -2 at σ = 0.05)
        # and the μ = −8, σ = 0.05 tensor of kurtosis.py:64-69
        return [(rng.normal(size=s) * 0.05 + mu).astype(np.float32)
                for mu, s in zip((0.0, 0.5, -2.0, -8.0),
                                 [(3, 3, 32, 32)] * 3 + [(3, 3, 8, 8)])]
    shapes = [(3, 3, 4, 8), (1, 1, 4, 8), (3, 3, 8, 8), (50,)]
    return [rng.standard_t(5, size=s).astype(np.float32) * 0.1 for s in shapes]


@pytest.mark.parametrize("kind", ["plain", "offset"])
@pytest.mark.parametrize("mode", ["avg", "sum", "max"])
def test_k7_plain_vs_jax_value_and_grad(mode, kind):
    ws = _kurt_tensors(kind)
    targets = (1.8, 1.4, 3.0, 1.2)
    ref, rgrads = jax.value_and_grad(
        lambda w: jk.kurtosis_regularization(w, targets, mode)
    )([jnp.asarray(w) for w in ws])
    loss, kurt, grads = kurtosis_grouped([_t(w) for w in ws], targets, mode)
    rtol, gtol = (5e-6, 1e-3) if kind == "offset" else (5e-6, 1e-5)
    np.testing.assert_allclose(float(loss), float(ref), rtol=rtol)
    for w, k in zip(ws, kurt.numpy()):
        np.testing.assert_allclose(k, float(jk.kurtosis(jnp.asarray(w))), rtol=rtol)
    for got, want in zip(grads, rgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=gtol * max(float(np.abs(want).max()), 1e-30))


def test_k7_centered_form_survives_the_offset_case():
    """μ = −8, σ = 0.05: the raw-moment form reads −131 (kurtosis.py:64-69);
    the centered form stays at the normal's 3 within sampling noise."""
    w = np.random.default_rng(0).normal(-8.0, 0.05, 200_000).astype(np.float32)
    k = float(tk.kurtosis(_t(w)))
    assert abs(k - 3.0) < 0.05
    np.testing.assert_allclose(k, float(jk.kurtosis(jnp.asarray(w))), rtol=2e-4)


def test_kurtosis_regularization_autograd_scales_by_upstream():
    ws = [_t(w).requires_grad_(True) for w in _kurt_tensors("plain")]
    targets = (1.8, 1.4, 3.0, 1.2)
    loss = tk.kurtosis_regularization(ws, targets, "avg")
    (2.5 * loss).backward()
    _, _, grads = kurtosis_grouped_plain([w.detach() for w in ws], targets, "avg")
    for w, g in zip(ws, grads):
        torch.testing.assert_close(w.grad, 2.5 * g, rtol=1e-6, atol=0)
    assert tk.resolve_targets(19, diffkurt=True, dataset="imagenet") == jk.DIFFKURT_TARGETS_IMAGENET
    assert tk.DIFFKURT_TARGETS_CIFAR == jk.DIFFKURT_TARGETS_CIFAR
    assert tk.DIFFKURT_TARGETS_TS == jk.DIFFKURT_TARGETS_TS

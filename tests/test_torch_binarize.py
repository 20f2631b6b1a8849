"""Parity of the port's sign estimators and binarizer-family registry
(``bdbnn_tpu_torch/nn/binarize.py``) with the JAX reference
(``bdbnn_tpu/nn/binarize.py``).

Forward and backward of every family are compared BITWISE on float32
grids that include 0, -0, ±1 and the estimators' kinks, with the same
upstream gradient (and, for the stochastic sign, the same uniform draw)
fed to both packages as numpy arrays. One exception, stated where it
applies: EDE's backward evaluates cosh, and XLA's and torch's exp/cosh
implementations differ in the last few ulps (about 1 value in 10 for
exp), so that backward is held to a relative 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.train.ede import cpt_tk as jax_cpt_tk
from bdbnn_tpu_torch.nn import binarize as tb


def _grid():
    base = np.array(
        [-3.0, -2.0, -1.5, -1.0, -0.999, -0.5, -1e-7, -0.0, 0.0, 1e-7,
         0.25, 0.5, 0.999, 1.0, 1.0001, 1.5, 2.0, 3.0],
        np.float32,
    )
    rand = np.random.default_rng(0).uniform(-3, 3, 64).astype(np.float32)
    return np.concatenate([base, rand])


X = _grid()
G = np.random.default_rng(1).normal(size=X.shape).astype(np.float32)


def _jax_fwd_bwd(fn, x, *args):
    y, vjp = jax.vjp(lambda v: fn(v, *args), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(G))
    return np.asarray(y), np.asarray(dx)


def _torch_fwd_bwd(fn, x, *args):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt, *args)
    y.backward(torch.from_numpy(G))
    return y.detach().numpy(), xt.grad.numpy()


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _assert_grad(name, a, b):
    if name in ("ede",):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    else:
        _assert_bitwise(a, b)


def _case(name):
    """(jax fn, torch fn, extra jax args, extra torch args) per sign."""
    u = np.random.default_rng(2).uniform(size=X.shape).astype(np.float32)
    t, k = jax_cpt_tk(3, 10)
    return {
        "ste": (jb.ste_sign, tb.ste_sign, (), ()),
        "approx": (jb.approx_sign, tb.approx_sign, (), ()),
        "ede": (
            jb.ede_sign, tb.ede_sign,
            (jnp.float32(t), jnp.float32(k)), (t, k),
        ),
        "prox": (jb.prox_sign, tb.prox_sign, (jnp.float32(0.75),), (0.75,)),
        "stoch": (jb.stoch_sign, tb.stoch_sign, (jnp.asarray(u),), (torch.from_numpy(u),)),
    }[name]


@pytest.mark.parametrize("name", ["ste", "approx", "ede", "prox", "stoch"])
def test_sign_forward_backward_bitwise(name):
    jf, tf, jargs, targs = _case(name)
    jy, jdx = _jax_fwd_bwd(jf, X, *jargs)
    ty, tdx = _torch_fwd_bwd(tf, X, *targs)
    _assert_bitwise(ty, jy)
    _assert_grad(name, tdx, jdx)
    assert set(np.unique(ty)) <= {-1.0, 1.0}


def test_hard_sign_zero_is_plus_one():
    x = torch.tensor([-0.0, 0.0, -1e-30, 1e-30])
    np.testing.assert_array_equal(tb._hard_sign(x).numpy(), [1.0, 1.0, -1.0, 1.0])


@pytest.mark.parametrize("family", ["ste", "approx", "ede", "proximal", "lab", "stochastic"])
def test_family_binarize_act_bitwise(family):
    """The family dispatch with a schedule (training forward) and
    without one (the eval path, the hard sign) matches the reference."""
    jfam, tfam = jb.make_family(family), tb.make_family(family)
    sched = jfam.schedule(2, 8) or None
    assert tfam.schedule(2, 8) == jfam.schedule(2, 8)
    for s in (None, sched):
        jy, jdx = _jax_fwd_bwd(lambda v: jfam.binarize_act(v, sched=s), X)
        ty, tdx = _torch_fwd_bwd(lambda v: tfam.binarize_act(v, sched=s), X)
        _assert_bitwise(ty, jy)
        # ste/ede with a (t, k) schedule take the EDE backward
        _assert_grad("ede" if s is not None and family in ("ste", "ede") else family, tdx, jdx)


@pytest.mark.parametrize("family", ["ste", "lab"])
def test_family_weight_sign_and_alpha(family):
    w = np.random.default_rng(3).normal(0, 0.1, (3, 3, 8, 5)).astype(np.float32)
    w[0, 0, 0, 0] = 0.0
    jfam, tfam = jb.make_family(family), tb.make_family(family)
    g = np.random.default_rng(4).normal(size=w.shape).astype(np.float32)
    js, vjp = jax.vjp(jfam.weight_sign, jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(g))
    wt = torch.tensor(w, requires_grad=True)
    ts = tfam.weight_sign(wt)
    ts.backward(torch.from_numpy(g))
    _assert_bitwise(ts.detach().numpy(), np.asarray(js))
    _assert_bitwise(wt.grad.numpy(), np.asarray(jdw))
    # alpha: a mean over kh*kw*C = 72 terms, summed in different
    # orders by XLA and torch — relative 1e-6 (a few f32 ulps)
    np.testing.assert_allclose(
        tfam.weight_alpha(torch.from_numpy(w)).numpy(),
        np.asarray(jfam.weight_alpha(jnp.asarray(w))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        tb.weight_alpha_np(family, w), jb.weight_alpha_np(family, w), rtol=1e-6
    )


def test_binarize_weight_matches_reference():
    w = np.random.default_rng(5).normal(0, 0.1, (3, 3, 4, 6)).astype(np.float32)
    ref = np.asarray(jb.binarize_weight(jnp.asarray(w)))
    got = tb.binarize_weight(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))


def test_registry_parse_and_resolve_match_reference():
    for spec in ("ste", "proximal:delta0=1.5", "proximal:delta1=0.25,delta0=3", "lab"):
        assert tb.parse_binarizer(spec) == jb.parse_binarizer(spec)
        assert tb.resolve_family(spec).spec == jb.resolve_family(spec).spec
    assert tb.resolve_family("", ede=True).name == "ede"
    assert tb.FAMILY_NAMES == jb.FAMILY_NAMES
    for bad in ("nope", "proximal:gamma=1", "proximal:delta0=x", "proximal:delta0=-1"):
        with pytest.raises(ValueError):
            tb.parse_binarizer(bad)
    with pytest.raises(ValueError):
        tb.resolve_family("proximal", ede=True)
    for e in (0, 3, 9):
        assert tb.cpt_tk(e, 10) == jax_cpt_tk(e, 10)


def test_active_family_context_restores():
    assert tb.get_active_family().name == "ste"
    with tb.active_family("lab") as fam:
        assert fam.name == "lab" and tb.get_active_family().name == "lab"
    assert tb.get_active_family().name == "ste"

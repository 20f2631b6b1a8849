"""Parity of the port's kernel modules with the JAX primitives they
replace, on the CPU through each kernel's plain PyTorch version:

- K1 ``binary_conv2d`` (fused sign + ±1 conv) vs ``approx_sign(x −
  shift)`` → ``binary_conv2d_mxu`` — bitwise;
- K2 ``weight_binarize`` vs ``weight_sign`` / ``weight_alpha`` (ste, lab)
  — sign bitwise, alpha within rtol 1e-6 (a mean of up to 4608 f32
  terms, summed in another order);
- K3 ``packed_dense_weight`` vs the reference's — bitwise;
- K4 ``popcount_binary_conv`` vs the reference's and vs K1 — bitwise.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn import packed as jpacked
from bdbnn_tpu.nn.kernels import binary_conv2d_mxu as jax_binary_conv2d_mxu
from bdbnn_tpu.serve.export import _pack_sign
from bdbnn_tpu_torch.nn import packed as tpacked
from bdbnn_tpu_torch.nn.kernels import (
    binary_conv2d,
    binary_conv2d_mxu,
    binary_conv2d_plain,
    weight_binarize,
    weight_binarize_plain,
)

# (N, H, W, C, O, k, stride, react shift)
CONV_CASES = [
    (2, 9, 9, 5, 4, 3, 1, True),     # odd K = 45, odd H/W
    (2, 8, 8, 8, 8, 3, 2, True),     # strided, even H/W
    (1, 7, 9, 6, 3, 3, 2, False),    # strided, odd non-square H/W, no shift
    (2, 5, 5, 7, 3, 1, 1, True),     # 1x1, odd channels
    (1, 6, 6, 40, 70, 3, 1, False),  # K = 360 > one stage, O > one tile
]
IDS = ["k45", "s2", "s2-odd", "1x1", "wide"]


def _operands(case, seed=0):
    n, h, w, c, o, k, s, react = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::17] = 0.0  # exact zeros: sign(0) = +1
    shift = rng.normal(0, 0.3, c).astype(np.float32) if react else None
    wt = rng.normal(0, 0.1, (k, k, c, o)).astype(np.float32)
    wt.reshape(-1)[::11] = 0.0
    return x, shift, wt


def _jax_ref(x, shift, wt, stride, family="ste"):
    fam = jb.make_family(family)
    xj = jnp.asarray(x)
    xb = jb.approx_sign(xj - jnp.asarray(shift)) if shift is not None else jb.ste_sign(xj)
    w = jnp.asarray(wt)
    alpha = fam.weight_alpha(w)
    y = jax_binary_conv2d_mxu(xb, fam.weight_sign(w), alpha, strides=(stride, stride))
    return np.asarray(y), np.array(alpha)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_k1_fused_conv_bitwise_vs_reference(case):
    x, shift, wt = _operands(case)
    stride = case[6]
    ref, jalpha = _jax_ref(x, shift, wt, stride)
    wsign, _ = weight_binarize(torch.from_numpy(wt))
    # the reference's own alpha, so the check isolates the conv
    got = binary_conv2d(
        torch.from_numpy(x), wsign, torch.from_numpy(jalpha),
        shift=torch.from_numpy(shift) if shift is not None else None,
        strides=(stride, stride),
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("case", CONV_CASES[:3], ids=IDS[:3])
def test_unfused_mxu_signature_bitwise(case):
    """``binary_conv2d_mxu`` with the JAX signature (±1 xb, ±1 HWIO)."""
    x, _, wt = _operands(case, seed=1)
    stride = case[6]
    xb = np.where(x >= 0, 1.0, -1.0).astype(np.float32)
    wb = np.where(wt >= 0, 1.0, -1.0).astype(np.float32)
    alpha = np.random.default_rng(2).uniform(0.1, 2.0, wt.shape[-1]).astype(np.float32)
    ref = np.asarray(jax_binary_conv2d_mxu(xb, wb, alpha, strides=(stride, stride)))
    got = binary_conv2d_mxu(
        torch.from_numpy(xb), torch.from_numpy(wb), torch.from_numpy(alpha),
        strides=(stride, stride),
    ).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_k1_padding_taps_contribute_zero_not_sign_of_shift():
    """A shift that is positive everywhere makes sign(0 - shift) = -1; a
    padding tap must still contribute 0 (the reference pads after the
    sign)."""
    x = np.ones((1, 3, 3, 2), np.float32) * 5.0
    shift = np.full((2,), 1.0, np.float32)
    wt = np.ones((3, 3, 2, 1), np.float32)
    got = binary_conv2d(
        torch.from_numpy(x), weight_binarize(torch.from_numpy(wt))[0],
        torch.ones(1), shift=torch.from_numpy(shift),
    ).numpy()[0, :, :, 0]
    # valid taps per output position: corners 4*2, edges 6*2, centre 9*2
    np.testing.assert_array_equal(got, [[8, 12, 8], [12, 18, 12], [8, 12, 8]])


@pytest.mark.parametrize("family", ["ste", "lab"])
@pytest.mark.parametrize("shape", [(3, 3, 5, 4), (1, 1, 7, 3), (3, 3, 64, 16)])
def test_k2_weight_sign_and_alpha(family, shape):
    w = np.random.default_rng(3).normal(0, 0.05, shape).astype(np.float32)
    w.reshape(-1)[::7] = 0.0
    fam = jb.make_family(family)
    jsign = np.asarray(fam.weight_sign(jnp.asarray(w)))
    jalpha = np.asarray(fam.weight_alpha(jnp.asarray(w)))
    sign, alpha = weight_binarize(torch.from_numpy(w), lab=family == "lab")
    assert sign.dtype == torch.int8 and tuple(sign.shape) == (shape[3], *shape[:3])
    np.testing.assert_array_equal(
        sign.permute(1, 2, 3, 0).numpy().astype(np.float32), jsign
    )
    np.testing.assert_allclose(alpha.numpy(), jalpha, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(3, 3, 3, 3), (1, 1, 5, 5), (3, 3, 8, 8), (2, 2, 1, 1)])
def test_k3_unpack_bitwise_vs_reference(shape):
    w = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    packed = _pack_sign(w)
    alpha = np.mean(np.abs(w), axis=(0, 1, 2)).astype(np.float32)
    ref = np.asarray(jpacked.packed_dense_weight(jnp.asarray(packed), jnp.asarray(alpha), shape))
    got = tpacked.packed_dense_weight(
        torch.from_numpy(packed), torch.from_numpy(alpha), shape
    ).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        tpacked.unpack_sign_device(torch.from_numpy(packed), shape).numpy(),
        np.asarray(jpacked.unpack_sign_device(jnp.asarray(packed), shape)),
    )


@pytest.mark.parametrize("case", CONV_CASES, ids=IDS)
def test_k4_popcount_bitwise_vs_reference_and_k1(case):
    x, shift, wt = _operands(case, seed=5)
    stride = case[6]
    xt = torch.from_numpy(x)
    st = torch.from_numpy(shift) if shift is not None else None
    wsign, alpha = weight_binarize(torch.from_numpy(wt))
    got = tpacked.popcount_binary_conv(
        xt, wsign, alpha, shift=st, strides=(stride, stride)
    ).numpy()
    k1 = binary_conv2d(xt, wsign, alpha, shift=st, strides=(stride, stride)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(k1))
    xb = np.where((x - shift if shift is not None else x) >= 0, 1.0, -1.0).astype(np.float32)
    sign_hwio = wsign.permute(1, 2, 3, 0).numpy().astype(np.float32)
    ref = np.asarray(
        jpacked.popcount_binary_conv(
            jnp.asarray(xb), jnp.asarray(sign_hwio), jnp.asarray(alpha.numpy()),
            strides=(stride, stride),
        )
    )
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(3, 3, 5, 4), (1, 1, 7, 3), (3, 3, 512, 512)])
def test_byte_accounting_matches_reference(shape):
    assert tpacked.dense_weight_bytes(shape) == jpacked.dense_weight_bytes(shape)
    assert tpacked.packed_weight_bytes(shape) == jpacked.packed_weight_bytes(shape)
    assert tpacked.popcount_word_bytes(*shape[:3]) == jpacked.popcount_word_bytes(*shape[:3])
    n = int(np.prod(shape)) + 3
    assert tpacked.packed_activation_bytes(n) == jpacked.packed_activation_bytes(n)


def test_k4_chunked_rows_equal_unchunked():
    x, shift, wt = _operands(CONV_CASES[0], seed=6)
    wsign, alpha = weight_binarize(torch.from_numpy(wt))
    a = tpacked.popcount_binary_conv_plain(
        torch.from_numpy(x), wsign, alpha, shift=torch.from_numpy(shift), rows_per_chunk=7
    )
    b = tpacked.popcount_binary_conv_plain(
        torch.from_numpy(x), wsign, alpha, shift=torch.from_numpy(shift)
    )
    assert torch.equal(a, b)


def test_wrappers_validate_and_cpu_path_counts_no_launch():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 4)
    before = (binary_conv2d.launches, weight_binarize.launches,
              tpacked.popcount_binary_conv.launches, tpacked.packed_dense_weight.launches)
    wsign, alpha = weight_binarize(w)
    binary_conv2d(x, wsign, alpha)
    tpacked.popcount_binary_conv(x, wsign, alpha)
    tpacked.packed_dense_weight(torch.zeros(36, dtype=torch.uint8), alpha, (3, 3, 8, 4))
    after = (binary_conv2d.launches, weight_binarize.launches,
             tpacked.popcount_binary_conv.launches, tpacked.packed_dense_weight.launches)
    assert after == before
    with pytest.raises(ValueError, match="float32"):
        binary_conv2d(x.double(), wsign, alpha)
    with pytest.raises(ValueError, match="int8"):
        binary_conv2d(x, wsign.float(), alpha)
    with pytest.raises(ValueError, match="input channels"):
        binary_conv2d(torch.zeros(1, 4, 4, 5), wsign, alpha)
    with pytest.raises(ValueError, match="float32"):
        tpacked.popcount_binary_conv(x.to(torch.bfloat16), wsign, alpha)
    with pytest.raises(ValueError, match="uint8"):
        tpacked.packed_dense_weight(torch.zeros(35, dtype=torch.uint8), alpha, (3, 3, 8, 4))
    with pytest.raises(ValueError, match="unpack"):
        tpacked.set_packed_impl("int8")


def test_plain_versions_are_what_the_cpu_wrappers_run():
    x, shift, wt = _operands(CONV_CASES[1], seed=7)
    xt, st = torch.from_numpy(x), torch.from_numpy(shift)
    wsign, alpha = weight_binarize_plain(torch.from_numpy(wt))
    assert torch.equal(
        binary_conv2d(xt, wsign, alpha, shift=st, strides=(2, 2)),
        binary_conv2d_plain(xt, wsign, alpha, shift=st, strides=(2, 2)),
    )

"""The weight preparation kernels' arithmetic on the CPU, against the JAX
primitives they replace:

- K2 ``weight_binarize`` (``csrc/weight_binarize.cu``): the split of the
  K rows over blocks (:func:`weight_binarize_splits`) covers every row
  once and spreads the flagship's deep weights over two waves of the
  card; the kernel's summation order (a float64 partial per split, the
  partials added in split order, one rounding to float32) gives the
  plain version's alpha bitwise and stays within a relative 1e-6 of the
  reference's float32 ``weight_alpha`` (a mean of up to 4608 f32 terms,
  summed in another order); the sign is bitwise ``weight_sign``,
  ``sign(±0.0) = +1``; the kernel's sign words (4 rows of a channel in
  one little-endian word) are the plain sign's bytes;
- K3 ``packed_dense_weight`` (the unpack half of ``csrc/packed.cu``):
  bitwise the reference's at ``O % 8 != 0``, at a tail byte and from a
  payload at an odd byte offset; where ``O % 4 == 0`` a quad of 4 weights
  (half a packed byte) takes 4 consecutive alphas.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn import packed as jpacked
from bdbnn_tpu.serve.export import _pack_sign
from bdbnn_tpu_torch.nn import packed as tpacked
from bdbnn_tpu_torch.nn.kernels import (
    weight_binarize,
    weight_binarize_plain,
    weight_binarize_splits,
)
from bdbnn_tpu_torch.nn.kernels.weight_binarize import K2_O_TILE, K2_ROW_STEP
from chip_smoke import FLAGSHIP_CONVS

# HWIO weights: the flagship's ten distinct binary conv weights, then odd
# ones (K = 45, O = 130 off every tile, a 1x1 64->128, one row)
FLAGSHIP_W = [(k, k, c, o) for _, _, c, o, k, _, _ in FLAGSHIP_CONVS]
ODD_W = [(3, 3, 5, 4), (1, 1, 7, 130), (1, 1, 64, 128), (3, 3, 3, 130), (1, 1, 1, 3)]
W_SHAPES = FLAGSHIP_W + ODD_W
W_IDS = [f"{kh}x{kw}x{c}x{o}" for kh, kw, c, o in W_SHAPES]


def _weight(shape, seed):
    w = np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)
    w.reshape(-1)[::13] = 0.0
    return w


@pytest.mark.parametrize("shape", W_SHAPES, ids=W_IDS)
def test_k2_splits_cover_every_row_once(shape):
    kh, kw, c, o = shape
    k = kh * kw * c
    splits, rows = weight_binarize_splits(k, o)
    assert rows % K2_ROW_STEP == 0 and 1 <= splits <= 65535
    covered = np.zeros(k, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(k, (s + 1) * rows)
        assert lo < hi, "an empty split"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    blocks = splits * math.ceil(o / K2_O_TILE)
    if kh == 3 and c == o and c >= 256:  # layer3 and layer4 3x3: two waves of 132 SMs
        assert blocks >= 264, blocks


def _alpha_in_split_order(w: np.ndarray, lab: bool) -> np.ndarray:
    """K2's alpha as the kernel orders it: per split, a float64 partial of
    Σ|W| (and ΣW²) per channel; the partials added in split order; the
    mean rounded once to float32 (lab: ΣW²/Σ|W| as f32 means, + 1e-12)."""
    kh, kw, c, o = w.shape
    k = kh * kw * c
    wd = w.reshape(k, o).astype(np.float64)
    splits, rows = weight_binarize_splits(k, o)
    s_abs, s_sq = np.zeros(o), np.zeros(o)
    for s in range(splits):
        part = wd[s * rows : (s + 1) * rows]
        s_abs = s_abs + np.abs(part).sum(axis=0)
        s_sq = s_sq + (part * part).sum(axis=0)
    mean_abs = (s_abs / k).astype(np.float32)
    if not lab:
        return mean_abs
    return (s_sq / k).astype(np.float32) / (mean_abs + np.float32(1e-12))


@pytest.mark.parametrize("family", ["ste", "lab"])
@pytest.mark.parametrize("shape", W_SHAPES, ids=W_IDS)
def test_k2_split_order_alpha_equals_plain_and_reference(shape, family):
    w = _weight(shape, seed=sum(shape))
    lab = family == "lab"
    got = _alpha_in_split_order(w, lab)
    _, plain = weight_binarize_plain(torch.from_numpy(w), lab=lab)
    np.testing.assert_array_equal(got.view(np.uint32), plain.numpy().view(np.uint32))
    ref = np.asarray(jb.make_family(family).weight_alpha(jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(3, 3, 5, 4), (1, 1, 7, 130), (3, 3, 64, 64)],
                         ids=["k45", "o130", "layer1"])
def test_k2_sign_bitwise_at_signed_zeros(shape):
    w = _weight(shape, seed=7)
    flat = w.reshape(-1)
    flat[::3] = 0.0
    flat[1::3] = -0.0
    assert np.signbit(flat[1::3]).all()
    sign, _ = weight_binarize(torch.from_numpy(w))
    ref = np.asarray(jb.make_family("ste").weight_sign(jnp.asarray(w)))
    got = sign.permute(1, 2, 3, 0).numpy().astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert (got.reshape(-1)[::3] == 1).all() and (got.reshape(-1)[1::3] == 1).all()


@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (1, 1, 7, 130)], ids=["layer1", "o130"])
def test_k2_sign_words_are_the_plain_sign_bytes(shape):
    """The kernel packs a thread's 4 rows of one channel into a word, row
    i in byte i (``0x01`` for +1, ``0xFF`` for -1), and stores the words
    of a channel in order: read little-endian, they are the (O, K) sign."""
    w = _weight(shape, seed=8)
    kh, kw, c, o = shape
    k = kh * kw * c
    kp = -(-k // 4) * 4
    wk = np.zeros((kp, o), np.float32)
    wk[:k] = w.reshape(k, o)
    b = np.where(wk >= 0, np.uint32(0x01), np.uint32(0xFF)).reshape(kp // 4, 4, o)
    words = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24).astype("<u4")
    got = words.T.copy().view(np.int8).reshape(o, kp)[:, :k]
    sign, _ = weight_binarize_plain(torch.from_numpy(w))
    np.testing.assert_array_equal(got, sign.reshape(o, k).numpy())


# (shape, byte offset of the payload): O % 8 != 0 with a tail byte
# (n % 8 != 0), O % 8 != 0 without one, and payloads off 16 bytes
K3_CASES = [((3, 3, 5, 3), 0), ((1, 1, 7, 130), 0), ((3, 3, 3, 5), 1), ((2, 2, 3, 7), 3),
            ((1, 1, 4, 10), 0), ((3, 3, 8, 8), 5), ((1, 1, 64, 130), 1)]


@pytest.mark.parametrize("shape,offset", K3_CASES,
                         ids=[f"{'x'.join(map(str, s))}+{b}" for s, b in K3_CASES])
def test_k3_plain_bitwise_vs_reference_off_the_byte_grid(shape, offset):
    n = int(np.prod(shape))
    w = _weight(shape, seed=n)
    packed = _pack_sign(w)
    buf = np.zeros(offset + packed.size, np.uint8)
    buf[offset:] = packed
    alpha = np.random.default_rng(n).uniform(0.01, 1.0, shape[-1]).astype(np.float32)
    ref = np.asarray(jpacked.packed_dense_weight(jnp.asarray(packed), jnp.asarray(alpha), shape))
    got = tpacked.packed_dense_weight(torch.from_numpy(buf)[offset:], torch.from_numpy(alpha),
                                      shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape", FLAGSHIP_W + [(1, 1, 7, 132)],
                         ids=W_IDS[: len(FLAGSHIP_W)] + ["1x1x7x132"])
def test_k3_quad_takes_four_consecutive_alphas(shape):
    """K3's vector path: where O % 4 == 0 (every flagship conv) quad q's 4
    weights are half of packed byte q // 2 (the high half first) and
    channels ``4q % O .. 4q % O + 3`` of one row, so the thread reads those
    4 alphas as one float4 and writes 4 consecutive floats."""
    o = shape[-1]
    assert o % 4 == 0
    w = _weight(shape, seed=o)
    packed = _pack_sign(w)
    alpha = np.random.default_rng(o).uniform(0.01, 1.0, o).astype(np.float32)
    q = np.arange(int(np.prod(shape)) // 4)
    nib = np.where(q % 2 == 1, packed[q // 2], packed[q // 2] >> 4)
    bits = (nib[:, None] >> (3 - np.arange(4))) & 1
    got = (np.where(bits == 1, np.float32(1), np.float32(-1))
           * alpha[(4 * q % o)[:, None] + np.arange(4)]).reshape(shape)
    plain = tpacked.packed_dense_weight_plain(torch.from_numpy(packed), torch.from_numpy(alpha),
                                              shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))

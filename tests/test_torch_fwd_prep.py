"""The arithmetic K1 and K4 run on the integer tensor cores, checked on
the CPU against the JAX package:

- :func:`act_sign_int8`, the plain version of K1's prep pass, is the
  reference's activation sign (``_hard_sign(x - shift)``, sign(0) = +1)
  as int8 ±1, padded with zeros to CP channels, on inputs where x - shift
  is exactly 0 at many lanes;
- K1's GEMM layout: the int8 rows of the prep pass gathered tap by tap
  (reduction index ``tap·CP + c``, a padding tap all zeros) against the
  weight sign padded to CP, summed in int64, times alpha, is bitwise the
  reference's ``binary_conv2d_mxu``;
- :func:`pack_sign_words` and :func:`pack_weight_words`, the plain
  versions of K4's prep passes, are the reference's ``_pack_words`` of
  the same bits (and their +1 counts);
- :func:`popcount_binary_conv_plain`, K4's AND identity with the
  per-(tap, o) weight-count table and the per-row counts, is bitwise the
  reference's masked-XOR ``popcount_binary_conv`` on narrow convs with
  padding, stride 2, a shift, and images where most taps are padding.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdbnn_tpu.nn import binarize as jb
from bdbnn_tpu.nn import packed as jpacked
from bdbnn_tpu.nn.kernels import binary_conv2d_mxu as jax_binary_conv2d_mxu
from bdbnn_tpu_torch.nn import packed as tpacked
from bdbnn_tpu_torch.nn.kernels import weight_binarize_plain
from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    FWD_C_STAGE,
    _round_up,
    act_sign_int8,
    im2col_nhwc,
)

# (N, H, W, C, O, k, stride, react shift)
CASES = [
    (2, 9, 9, 5, 4, 3, 1, True),     # C = 5: one word, mostly padding lanes
    (2, 8, 8, 8, 6, 3, 2, True),     # stride 2, even H/W
    (1, 7, 9, 40, 3, 3, 2, False),   # C = 40 spans two words, O = 3, no shift
    (2, 5, 5, 7, 3, 1, 1, True),     # 1x1
    (1, 6, 6, 64, 70, 3, 1, True),   # C = 64, O past one 64-channel tile
    (3, 1, 1, 33, 5, 3, 1, True),    # H = W = 1: eight of nine taps padding
    (2, 2, 2, 12, 4, 3, 2, False),   # H = W = 2, stride 2
    (2, 9, 9, 20, 10, 5, 2, True),   # 5x5, stride 2
]
IDS = ["c5", "s2", "c40-o3", "1x1", "c64-o70", "hw1", "hw2-s2", "5x5-s2"]


def _operands(case, seed):
    n, h, w, c, o, k, s, react = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    shift = rng.normal(0, 0.3, c).astype(np.float32) if react else None
    if react:
        x[0, 0, 0, :] = shift  # x - shift exactly 0 at every lane: sign +1
        x.reshape(-1, c)[1::5] = shift
    wt = rng.normal(0, 0.1, (k, k, c, o)).astype(np.float32)
    wt.reshape(-1)[::11] = 0.0
    return x, shift, wt


def _jax_sign(x, shift):
    v = jnp.asarray(x) - jnp.asarray(shift) if shift is not None else jnp.asarray(x)
    return np.asarray(jb._hard_sign(v))


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_act_sign_int8_is_the_reference_sign(case):
    x, shift, _ = _operands(case, seed=41)
    c = case[3]
    cp = _round_up(c, FWD_C_STAGE)
    got = act_sign_int8(torch.from_numpy(x), torch.from_numpy(shift) if shift is not None else None,
                        cp)
    assert got.dtype == torch.int8 and tuple(got.shape) == x.shape[:3] + (cp,)
    np.testing.assert_array_equal(got[..., :c].numpy().astype(np.float32), _jax_sign(x, shift))
    assert bool((got[..., c:] == 0).all())
    if shift is not None:
        assert bool((got[0, 0, 0, :c] == 1).all())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k1_int8_rows_equal_reference_conv(case):
    """K1's GEMM in int64 over its own layout: rows of the int8 sign
    gathered per tap (zeros at a padding tap), reduction index tap·CP + c."""
    n, h, w, c, o, k, s, _ = case
    x, shift, wt = _operands(case, seed=42)
    xt = torch.from_numpy(x)
    st = torch.from_numpy(shift) if shift is not None else None
    wsign, alpha = weight_binarize_plain(torch.from_numpy(wt))
    cp = _round_up(c, FWD_C_STAGE)
    rows = im2col_nhwc(act_sign_int8(xt, st, cp), k, k, s, k // 2)  # (N, Ho, Wo, taps·CP)
    wk = torch.nn.functional.pad(wsign, (0, cp - c)).reshape(o, -1)  # (O, taps·CP)
    dot = rows.reshape(-1, rows.shape[-1]).to(torch.int64) @ wk.to(torch.int64).t()
    got = (dot.to(torch.float32) * alpha).reshape(*rows.shape[:3], o)
    ref = jax_binary_conv2d_mxu(
        jnp.asarray(_jax_sign(x, shift)), jnp.asarray(wsign.permute(1, 2, 3, 0).numpy()),
        jnp.asarray(alpha.numpy()), strides=(s, s),
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pack_sign_words_are_reference_pack_words(case):
    x, shift, _ = _operands(case, seed=43)
    c = case[3]
    cp = _round_up(c, tpacked.POPCOUNT_C_STAGE)
    words, count = tpacked.pack_sign_words(
        torch.from_numpy(x), torch.from_numpy(shift) if shift is not None else None, cp)
    bits = _jax_sign(x, shift) > 0
    ref = jpacked._pack_words(jnp.asarray(np.pad(bits, ((0, 0),) * 3 + ((0, cp - c),))))
    assert tuple(words.shape) == x.shape[:3] + (cp // 32,)
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref).astype(np.int64))
    np.testing.assert_array_equal(count.numpy(), bits.sum(axis=-1))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pack_weight_words_are_reference_pack_words(case):
    _, _, wt = _operands(case, seed=44)
    k, c, o = case[5], case[3], case[4]
    wsign, _ = weight_binarize_plain(torch.from_numpy(wt))
    cp = _round_up(c, tpacked.POPCOUNT_C_STAGE)
    words, table = tpacked.pack_weight_words(wsign, cp)
    bits = wsign.numpy().reshape(o, k * k, c) > 0
    ref = jpacked._pack_words(jnp.asarray(np.pad(bits, ((0, 0), (0, 0), (0, cp - c)))))
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref).astype(np.int64))
    assert tuple(table.shape) == (k * k, o)
    np.testing.assert_array_equal(table.numpy(), bits.sum(axis=-1).T)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_and_identity_equals_reference_popcount_conv(case):
    n, h, w, c, o, k, s, _ = case
    x, shift, wt = _operands(case, seed=45)
    wsign, alpha = weight_binarize_plain(torch.from_numpy(wt))
    got = tpacked.popcount_binary_conv_plain(
        torch.from_numpy(x), wsign, alpha,
        shift=torch.from_numpy(shift) if shift is not None else None, strides=(s, s),
        rows_per_chunk=5,
    )
    ref = jpacked.popcount_binary_conv(
        jnp.asarray(_jax_sign(x, shift)), jnp.asarray(wsign.permute(1, 2, 3, 0).numpy()),
        jnp.asarray(alpha.numpy()), strides=(s, s),
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))

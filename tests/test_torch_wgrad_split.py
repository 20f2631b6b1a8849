"""The arithmetic K6 runs on the tensor cores, checked on the CPU:

- :func:`wgrad_sign_bf16`, the plain version of K6's sign pass, is
  ``binarize_input`` (sign(x - shift) with sign(0) = +1) as bf16 ±1,
  padded with zeros to CP channels, on inputs with exact zeros of x and
  of x - shift;
- a float64 dW summed from the bf16 sx and the three bf16 pieces of
  ``g·alpha``, tile by tile over K6's GEMM rows ``r = tap·CP + c`` as the
  kernel sums them, equals ``chip_smoke.wgrad_exact`` bitwise (every
  product is exact and float64 holds these sums without rounding).

That :func:`wgrad_splits` covers every position once is checked in
``tests/test_torch_train_kernels.py``.
"""

import numpy as np
import pytest
import torch

from bdbnn_tpu_torch.nn.kernels import weight_binarize_plain
from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    WGRAD_ROW_TILE,
    _round_up,
    binarize_input,
    out_size,
    split_bf16x3,
    wgrad_sign_bf16,
)
from chip_smoke import wgrad_exact


@pytest.mark.parametrize("react", [True, False], ids=["shift", "no-shift"])
@pytest.mark.parametrize("c", [5, 8, 40, 64])
def test_sign_pass_plain_is_binarize_input(c, react):
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 5, 6, c)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    shift = rng.normal(0, 0.3, c).astype(np.float32) if react else None
    if react:
        x[0, 0, 0, :] = shift  # x - shift is exactly 0: sign +1
        x[1, 2, 3, :] = -0.0
    xt = torch.from_numpy(x)
    st = torch.from_numpy(shift) if react else None
    cp = _round_up(c, 8)
    got = wgrad_sign_bf16(xt, st, cp)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 5, 6, cp)
    assert torch.equal(got[..., :c].float(), binarize_input(xt, st))
    assert bool((got[..., c:] == 0).all())
    if react:
        assert bool((got[0, 0, 0, :c] == 1).all())


def _wgrad_from_pieces(g, x, shift, w, alpha, k, s, p):
    """K6's sum in float64: the GEMM's rows r = tap·CP + c in tiles of
    WGRAD_ROW_TILE, each row's sx at the tap's input position (zero in
    the padding) times the three bf16 pieces of g·alpha, summed over every
    position; then the rows mapped back to HWIO and the STE mask."""
    n, h, wd, c = x.shape
    o = g.shape[-1]
    cp = _round_up(c, 8)
    ho, wo = g.shape[1], g.shape[2]
    sx = torch.nn.functional.pad(wgrad_sign_bf16(x, shift, cp).double(), (0, 0, p, p, p, p))
    pieces = [t.double().reshape(-1, o) for t in split_bf16x3(g * alpha)]
    rows = k * k * cp
    dws = torch.zeros((k * k, c, o), dtype=torch.float64)
    for r0 in range(0, rows, WGRAD_ROW_TILE):
        for r in range(r0, min(rows, r0 + WGRAD_ROW_TILE), 8):
            tap, c0 = divmod(r, cp)
            i, j = divmod(tap, k)
            a = sx[:, i : i + s * (ho - 1) + 1 : s, j : j + s * (wo - 1) + 1 : s, c0 : c0 + 8]
            keep = min(8, c - c0)
            for piece in pieces:  # hi, mid, lo, as the kernel takes them
                part = a.reshape(-1, 8).t() @ piece
                if keep > 0:
                    dws[tap, c0 : c0 + keep] += part[:keep]
    return dws.reshape(k, k, c, o) * (w.abs() <= 1.0).double()


# (N, H, W, C, O, k, stride, react shift)
CASES = [(2, 8, 8, 5, 6, 3, 1, True), (2, 9, 7, 12, 5, 3, 2, True), (2, 5, 5, 7, 3, 1, 1, False)]


@pytest.mark.parametrize("case", CASES, ids=["3x3s1", "3x3s2-odd", "1x1"])
def test_wgrad_from_pieces_equals_exact(case):
    n, h, w, c, o, k, s, react = case
    p = k // 2
    ho, wo = out_size(h, k, s, p), out_size(w, k, s, p)
    rng = np.random.default_rng(32)
    # |g| >= 2^-6 keeps every float64 partial sum within 53 bits (exact)
    g = rng.normal(size=(n, ho, wo, o)).astype(np.float32)
    g = torch.from_numpy((np.sign(g) * (np.abs(g) + 2.0**-6)).astype(np.float32))
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::11] = 0.0
    x = torch.from_numpy(x)
    shift = torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)) if react else None
    wt = torch.from_numpy(rng.normal(0, 0.8, (k, k, c, o)).astype(np.float32))  # some |W| > 1
    _, alpha = weight_binarize_plain(wt)
    got = _wgrad_from_pieces(g, x, shift, wt, alpha, k, s, p)
    assert torch.equal(got, wgrad_exact(g, x, wt, alpha, shift, s, p))

"""The arithmetic and the tap enumeration K5 runs on the tensor cores,
checked on the CPU:

- :func:`split_bf16x3` splits f32 ``g·alpha`` into three bf16 pieces
  whose float64 sum is the f32 value exactly, over exponents 2^-100 to
  2^100, both signs, zero and values at bf16 rounding ties;
- :func:`dgrad_tap_table` (the table K5 reads, built from
  :func:`dgrad_parity_classes`) covers every (dx position, g position,
  tap) triple of the conv-transpose exactly once;
- a float64 dgrad summed from the three pieces, class by class and tap by
  tap as K5 sums them, equals ``chip_smoke.dgrad_exact`` bitwise (every
  product is exact and float64 holds these sums without rounding).
"""

import numpy as np
import pytest
import torch

from bdbnn_tpu_torch.nn.kernels import weight_binarize_plain
from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    dgrad_parity_classes,
    dgrad_tap_table,
    out_size,
    split_bf16x3,
)
from chip_smoke import dgrad_exact


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(21)
    if kind == "wide":
        mant = rng.uniform(1.0, 2.0, 20000)
        exp = rng.integers(-100, 101, 20000)
        v = np.ldexp(mant, exp) * rng.choice([-1.0, 1.0], 20000)
        return np.concatenate([v, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    if kind == "ties":
        # f32 values halfway between bf16 neighbours (and one ulp either
        # side), where round-to-nearest-even decides hi and the residual
        frac = rng.integers(0, 2**7, 5000, dtype=np.uint32)
        exp = rng.integers(127 - 100, 127 + 100, 5000, dtype=np.uint32)
        base = (exp << 23) | (frac << 16) | 0x8000
        bits = np.concatenate([base, base - 1, base + 1, base | 0x80000000])
        return bits.astype(np.uint32).view(np.float32)
    # "gradients": g·alpha as K5's split pass forms it
    g = rng.normal(size=20000).astype(np.float32)
    alpha = rng.uniform(0.01, 2.0, 20000).astype(np.float32)
    return g * alpha


@pytest.mark.parametrize("kind", ["wide", "ties", "gradients"])
def test_split_bf16x3_is_exact(kind):
    ga = torch.from_numpy(_values(kind))
    hi, mid, lo = split_bf16x3(ga)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, ga.double())
    # the pieces shrink: mid below half an ulp of hi, lo below half of mid's
    nz = ga != 0
    assert bool((mid.double().abs() <= 2.0**-8 * hi.double().abs())[nz].all())
    assert bool((lo.double().abs() <= 2.0**-8 * mid.double().abs() + 0.0)[mid != 0].all())


def _decode(table, s):
    """(class z, i·kw + j, di, dj) for every tap entry, as K5 reads them."""
    offs, ents = table[: s * s + 1], table[s * s + 1 :]
    for z in range(s * s):
        for t in range(offs[z], offs[z + 1]):
            yield z, ents[3 * t], ents[3 * t + 1], ents[3 * t + 2]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("hw", [(7, 8), (8, 7), (9, 9), (6, 6)], ids=lambda v: f"{v[0]}x{v[1]}")
def test_parity_classes_cover_each_triple_once(k, s, hw):
    h_in, w_in = hw
    p = k // 2
    ho, wo = out_size(h_in, k, s, p), out_size(w_in, k, s, p)
    want = {
        (ho_ * s - p + i, wo_ * s - p + j, ho_, wo_, i * k + j)
        for ho_ in range(ho) for wo_ in range(wo) for i in range(k) for j in range(k)
        if 0 <= ho_ * s - p + i < h_in and 0 <= wo_ * s - p + j < w_in
    }
    got = []
    table = dgrad_tap_table(k, k, s, p)
    assert table[0] == 0 and table[s * s] == k * k and len(table) == s * s + 1 + 3 * k * k
    for z, tap, di, dj in _decode(table, s):
        a, b = divmod(z, s)
        for h in range(a, h_in, s):
            for w in range(b, w_in, s):
                g_h, g_w = h // s + di, w // s + dj
                if 0 <= g_h < ho and 0 <= g_w < wo:
                    got.append((h, w, g_h, g_w, tap))
    assert len(got) == len(set(got))
    assert set(got) == want
    # one axis: every tap in exactly one class
    classes = dgrad_parity_classes(k, s, p)
    assert sorted(i for cls in classes for i, _ in cls) == list(range(k))


# (N, H, W, C, O, k, stride)
CASES = [(2, 8, 8, 5, 6, 3, 1), (2, 9, 7, 4, 5, 3, 2), (2, 5, 5, 7, 3, 1, 1)]


@pytest.mark.parametrize("case", CASES, ids=["3x3s1", "3x3s2-odd", "1x1"])
def test_dgrad_from_pieces_equals_exact(case):
    n, h, w, c, o, k, s = case
    p = k // 2
    ho, wo = out_size(h, k, s, p), out_size(w, k, s, p)
    rng = np.random.default_rng(22)
    # |g| >= 2^-6 keeps every float64 partial sum within 53 bits (exact)
    g = rng.normal(size=(n, ho, wo, o)).astype(np.float32)
    g = (np.sign(g) * (np.abs(g) + 2.0**-6)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    wsign, alpha = weight_binarize_plain(
        torch.from_numpy(rng.normal(0, 0.5, (k, k, c, o)).astype(np.float32))
    )
    g = torch.from_numpy(g)
    pieces = [t.double() for t in split_bf16x3(g * alpha)]
    wd = wsign.double()  # (O, kh, kw, C)
    dx = torch.zeros((n, h, w, c), dtype=torch.float64)
    for z, tap, di, dj in _decode(dgrad_tap_table(k, k, s, p), s):
        a, b = divmod(z, s)
        i, j = divmod(tap, k)
        for hh, hd in enumerate(range(a, h, s)):
            if not 0 <= hh + di < ho:
                continue
            for ww, wdx in enumerate(range(b, w, s)):
                if not 0 <= ww + dj < wo:
                    continue
                for piece in pieces:
                    dx[:, hd, wdx, :] += piece[:, hh + di, ww + dj, :] @ wd[:, i, j, :]
    assert torch.equal(dx, dgrad_exact(g, x, wsign, alpha, s, p))

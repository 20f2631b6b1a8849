"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1-K4 bitwise (K1 and K4 also against each other at the
flagship's ten conv shapes at batch 1, 32 and 256 and at sizes off every
tile edge; K2 and K3 at the flagship's ten weights and weights off every
tile, vector width and alignment, K2's alpha to rtol 1e-6 of the plain
version, bitwise across two runs and across CUDA-graph replays); K5 and K6 to the summation bound
``8·2⁻²⁴·Σ|terms|·|slope| + 2⁻²⁴·|plain|`` (the products are exact, the
sums run in another order and each side's sum carries a rounding error of
a few 2⁻²⁴·Σ|terms|; one rounding of the slope multiply), K5 and K6
bitwise between two runs, K6 also against the float64 sum (within
4·2⁻²⁴·Σ|terms| + 2⁻²⁴·|exact|), K5 and K6 also on same-sign terms
(within 4·2⁻²⁴·Σ|terms| of the float64 sum); K7 to rtol 1e-5 (both sum
in f64 and round once; the f32 mean can round the other way), bitwise
across two runs and between its calls with and without the gradient,
across a changed tensor set, an in-place weight update and CUDA-graph
replays. Under the stochastic family K1 with the draw ``u`` is bitwise
equal to its plain version and K6 with ``u`` within its bound, at shapes
where the sampled dW is far from the hard one. The bf16 modes: K1 bitwise
its plain bf16 version (hard sign and draw), K2's sign bitwise and its
alpha within one bf16 rounding, K5 and K6 within the f32 summation bound
plus a bf16 rounding on each side, all bitwise across two runs and
counted apart (``launches_bf16``); the redesigned K1, K5 and K6 bf16
kernels also at shapes off their tiles and chunks (K5 and K6 against the
float64 sum too; K5 under every estimator; K1 and K6 with the hard sign
and the draw), K6 with the draw over one split of 49 stages and K5 over a
long reduction, five runs bitwise alike, and K5 on same-sign terms. The HTTP front end over the flagship
engine on ``cuda:0`` answers 8 requests over loopback, each bitwise the
engine's logits of the batch it rode in, rounded to 4 places. A
bucket-8 flagship forward in the engine's trace window has every K1 and K2
kernel in its own binary conv's layer span, and a span outside a window
adds no launch. Every test here is marked ``cuda`` and
skips with a reason where no CUDA device exists (this file imports torch
and the port only, no JAX). On the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the GPU
machine does not have.)
"""

import numpy as np
import pytest
import torch

from bdbnn_tpu_torch.nn import packed as P
from bdbnn_tpu_torch.nn.kernels import (
    binary_conv2d,
    binary_conv2d_dgrad,
    binary_conv2d_dgrad_plain,
    binary_conv2d_plain,
    binary_conv2d_wgrad,
    binary_conv2d_wgrad_plain,
    kurtosis_grouped,
    kurtosis_grouped_plain,
    weight_binarize,
    weight_binarize_plain,
)
from bdbnn_tpu_torch.nn.kernels.binary_conv import estimator_slope, wgrad_bf16_splits
from bdbnn_tpu_torch.serve.export import _pack_sign
from chip_smoke import FLAGSHIP_CONVS

# (N, H, W, C, O, k, stride, react shift)
CONV_CASES = [
    (2, 9, 9, 5, 4, 3, 1, True),
    (2, 8, 8, 8, 8, 3, 2, True),
    (1, 7, 9, 6, 3, 3, 2, False),
    (2, 5, 5, 7, 3, 1, 1, True),
    (1, 6, 6, 40, 70, 3, 1, False),
    (2, 14, 14, 256, 96, 3, 2, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
    return torch.device("cuda")


def _operands(case, dev, seed):
    n, h, w, c, o, k, s, react = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    x.reshape(-1)[::17] = 0.0
    shift = rng.normal(0, 0.3, c).astype(np.float32) if react else None
    wt = rng.normal(0, 0.1, (k, k, c, o)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dev) if a is not None else None
    return to(x), to(shift), to(wt)


# K1 and K4 on the integer tensor cores: the flagship's ten distinct
# binary conv shapes at batch 1, 32 and 256, then sizes that fall off
# every tile edge (M, O and C not multiples of the 128 x 64 tile or of
# the 32-channel / 64-lane stage), 1x1, 5x5, stride 2, no shift, and images
# where most taps are padding
FWD_CASES = [
    (n, hw, hw, c, o, k, s, True)
    for n in (1, 32, 256)
    for _, hw, c, o, k, s, _ in FLAGSHIP_CONVS
] + [
    (3, 11, 13, 5, 3, 3, 1, True),
    (2, 9, 9, 40, 3, 3, 2, False),
    (2, 7, 7, 40, 67, 1, 1, True),
    (3, 13, 11, 200, 131, 3, 2, False),
    (5, 1, 1, 64, 70, 3, 1, True),
    (4, 2, 2, 96, 130, 3, 1, False),
    (4, 2, 2, 32, 8, 3, 2, True),
    (1, 3, 3, 512, 512, 3, 1, True),
    (2, 9, 9, 20, 10, 5, 2, True),
]
FWD_IDS = [f"n{c[0]}-{c[1]}x{c[2]}-c{c[3]}-o{c[4]}-k{c[5]}s{c[6]}-{'shift' if c[7] else 'none'}"
           for c in FWD_CASES]


def _fwd_all(x, wsign, alpha, shift, st):
    before = (binary_conv2d.launches, P.popcount_binary_conv.launches)
    k1 = binary_conv2d(x, wsign, alpha, shift=shift, strides=st)
    k4 = P.popcount_binary_conv(x, wsign, alpha, shift=shift, strides=st)
    plain = binary_conv2d_plain(x, wsign, alpha, shift=shift, strides=st)
    plain4 = P.popcount_binary_conv_plain(x, wsign, alpha, shift=shift, strides=st)
    torch.cuda.synchronize()
    assert (binary_conv2d.launches, P.popcount_binary_conv.launches) == (
        before[0] + 1, before[1] + 1
    )
    return k1, k4, plain, plain4


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES + FWD_CASES,
                         ids=[f"case{i}" for i in range(len(CONV_CASES))] + FWD_IDS)
def test_k1_k4_bitwise_vs_plain(cuda, case):
    x, shift, w = _operands(case, cuda, seed=8)
    wsign, alpha = weight_binarize_plain(w)
    k1, k4, plain, plain4 = _fwd_all(x, wsign, alpha, shift, (case[6], case[6]))
    assert torch.equal(plain4, plain)
    assert torch.equal(k1, plain)
    assert torch.equal(k4, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_k1_k4_padding_wider_than_the_kernel(cuda, k):
    """Explicit padding past the kernel: some rows have no valid tap."""
    x, shift, w = _operands((2, 5, 6, 24, 9, k, 1, True), cuda, seed=18)
    wsign, alpha = weight_binarize(w)
    pad = ((k + 2, k + 2), (k + 2, k + 2))
    plain = binary_conv2d_plain(x, wsign, alpha, shift=shift, padding=pad)
    k1 = binary_conv2d(x, wsign, alpha, shift=shift, padding=pad)
    k4 = P.popcount_binary_conv(x, wsign, alpha, shift=shift, padding=pad)
    torch.cuda.synchronize()
    assert torch.equal(k1, plain)
    assert torch.equal(k4, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("react", [True, False], ids=["shift", "none"])
def test_k1_k4_sign_of_zero_is_plus_one(cuda, react):
    """x - shift exactly 0 (and x = ±0 without a shift) at many lanes."""
    case = (4, 9, 9, 72, 40, 3, 1, react)
    x, shift, w = _operands(case, cuda, seed=17)
    flat = x.reshape(-1, 72)
    flat[::2] = shift if react else 0.0
    if not react:
        flat[1::4] = -0.0
    wsign, alpha = weight_binarize(w)
    k1, k4, plain, _ = _fwd_all(x, wsign, alpha, shift, (1, 1))
    assert torch.equal(k1, plain)
    assert torch.equal(k4, plain)
    # the same as where those lanes are plainly positive
    v = x - shift if react else x
    clear = torch.where(v == 0, (shift if react else 0.0) + 1.0, x)
    assert torch.equal(k1, binary_conv2d(clear, wsign, alpha, shift=shift))
    assert torch.equal(k4, P.popcount_binary_conv(clear, wsign, alpha, shift=shift))


# K2 and K3 at the flagship's ten distinct weights, then weights off the
# kernels' grids: O = 130, 132 and 48 (off K2's 64-channel tile; 130 also
# off the 4-channel vectors, 132 off K3's 8-weight bytes), K = 45, 27 and
# 180 (off the 16-row step), K = 48 and 320 (on the step, off the 64-row
# chunk), one row
WEIGHT_SHAPES = [(k, k, c, o) for _, _, c, o, k, _, _ in FLAGSHIP_CONVS] + [
    (3, 3, 5, 4), (3, 3, 64, 48), (1, 1, 7, 130), (1, 1, 7, 132), (3, 3, 3, 130),
    (3, 3, 20, 64), (1, 1, 48, 64), (1, 1, 320, 72), (1, 1, 1, 3),
]


def _weight(shape, dev, seed, offset=0):
    """An f32 HWIO weight on ``dev`` with exact ±0.0 entries, starting
    ``offset`` floats into its storage (off 16 bytes where offset % 4)."""
    w = np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)
    w.reshape(-1)[::13] = 0.0
    w.reshape(-1)[5::13] = -0.0
    buf = torch.zeros(offset + w.size, device=dev)
    buf[offset:] = torch.from_numpy(w.reshape(-1)).to(dev)
    return buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "w+4B"])
@pytest.mark.parametrize("shape", WEIGHT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_vs_plain(cuda, lab, shape, offset):
    w = _weight(shape, cuda, 9, offset)
    sign, alpha = weight_binarize(w, lab=lab)
    sign2, alpha2 = weight_binarize(w, lab=lab)
    psign, palpha = weight_binarize_plain(w, lab=lab)
    torch.cuda.synchronize()
    assert torch.equal(sign, psign)
    torch.testing.assert_close(alpha, palpha, rtol=1e-6, atol=0)
    # the split sums run in an order fixed by the shapes: bitwise across runs
    assert torch.equal(sign, sign2)
    assert torch.equal(alpha.view(torch.int32), alpha2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("shape", [(3, 3, 512, 512), (1, 1, 7, 130)], ids=["layer4", "o130"])
def test_k2_cuda_graph_replays_equal(cuda, lab, shape):
    """K2 captured in a CUDA graph and replayed twice, on the weight it was
    captured with and on a new one copied in: each replay equals the
    eager call, so the kernel keeps no state from one launch to the next."""
    w = _weight(shape, cuda, 11)
    weight_binarize(w, lab=lab)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sign, alpha = weight_binarize(w, lab=lab)
    for seed in (11, 12, 12):
        w.copy_(_weight(shape, cuda, seed))
        graph.replay()
        esign, ealpha = weight_binarize(w, lab=lab)
        torch.cuda.synchronize()
        assert torch.equal(sign, esign)
        assert torch.equal(alpha.view(torch.int32), ealpha.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "payload+1B"])
@pytest.mark.parametrize("shape", [(3, 3, 7, 5), (1, 1, 64, 128)] + WEIGHT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k3_vs_plain(cuda, shape, offset):
    w = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    packed = _pack_sign(w)
    buf = torch.zeros(offset + packed.size, dtype=torch.uint8, device=cuda)
    buf[offset:] = torch.from_numpy(packed).to(cuda)
    payload = buf[offset:]
    alpha = torch.rand(shape[-1], device=cuda) + 0.1
    got = P.packed_dense_weight(payload, alpha, shape)
    torch.cuda.synchronize()
    assert torch.equal(got, P.packed_dense_weight_plain(payload, alpha, shape))
    # alpha off 16 bytes takes the per-weight path: the same values
    abuf = torch.zeros(shape[-1] + 1, device=cuda)
    abuf[1:] = alpha
    assert torch.equal(P.packed_dense_weight(payload, abuf[1:], shape), got)


@pytest.mark.cuda
def test_wrapper_refuses_non_contiguous_cuda_input(cuda):
    x = torch.zeros(1, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    wsign, alpha = weight_binarize_plain(torch.zeros(3, 3, 8, 4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        binary_conv2d(x, wsign, alpha)


ESTIMATORS = [("approx", 0.0, 0.0), ("ste", 0.0, 0.0), ("ede", 0.7, 1.5), ("prox", 0.8, 0.0)]
U = 2.0**-24


def _grad_operands(case, dev, seed):
    x, shift, w = _operands(case, dev, seed)
    n, h, wd, c, o, k, s, _ = case
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (wd + 2 * (k // 2) - k) // s + 1
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.normal(size=(n, ho, wo, o)).astype(np.float32)).to(dev)
    return x, shift, w * 8.0, g  # some |W| > 1, so the STE mask bites


@pytest.mark.cuda
@pytest.mark.parametrize("est", ESTIMATORS, ids=[e[0] for e in ESTIMATORS])
@pytest.mark.parametrize("case", CONV_CASES)
def test_k5_k6_vs_plain(cuda, case, est):
    x, shift, w, g = _grad_operands(case, cuda, seed=12)
    st = (case[6], case[6])
    wsign, alpha = weight_binarize_plain(w)
    before = (binary_conv2d_dgrad.launches, binary_conv2d_wgrad.launches)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    dw = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st)
    dw2 = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st)
    pdx = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    pdw = binary_conv2d_wgrad_plain(g, x, w, alpha, shift=shift, strides=st)
    torch.cuda.synchronize()
    assert (binary_conv2d_dgrad.launches, binary_conv2d_wgrad.launches) == (
        before[0] + 1, before[1] + 2
    )
    terms = binary_conv2d_dgrad_plain(g.abs(), x, torch.ones_like(wsign), alpha.abs(),
                                      shift=shift, strides=st)
    v = x - shift if shift is not None else x
    slope = estimator_slope(v, est)
    over = (dx - pdx).abs() - 8 * U * terms * slope.abs() - U * pdx.abs() - 1e-30
    if bool((over > 0).any()):
        i = int(over.reshape(-1).argmax())
        acc = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st,
                                  estimator=("none", 0.0, 0.0)).reshape(-1)[i]
        pacc = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift,
                                         strides=st).reshape(-1)[i]
        pytest.fail(
            f"dx beyond the bound at flat index {i}: v={float(v.reshape(-1)[i])!r} "
            f"plain slope={float(slope.reshape(-1)[i])!r} dx={float(dx.reshape(-1)[i])!r} "
            f"plain dx={float(pdx.reshape(-1)[i])!r} acc={float(acc)!r} plain acc={float(pacc)!r} "
            f"terms={float(terms.reshape(-1)[i])!r}"
        )
    wterms = binary_conv2d_wgrad_plain(g.abs(), torch.ones_like(x), torch.zeros_like(w),
                                       alpha.abs(), strides=st)
    assert bool(((dw - pdw).abs() <= 8 * U * wterms + U * pdw.abs() + 1e-30).all())
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_k5_bitwise_across_two_runs(cuda, case):
    x, shift, w, g = _grad_operands(case, cuda, seed=14)
    st = (case[6], case[6])
    wsign, alpha = weight_binarize_plain(w)
    est = ("approx", 0.0, 0.0)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    dx2 = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2)


@pytest.mark.cuda
def test_k5_same_sign_terms_within_bound(cuda):
    """|g| and all +1 signs at C = O = 512, 3×3: every term is positive,
    so no truncation or rounding bias of the sum can cancel."""
    from chip_smoke import dgrad_exact

    case = (4, 7, 7, 512, 512, 3, 1, False)
    x, _, w, g = _grad_operands(case, cuda, seed=15)
    g = g.abs()
    _, alpha = weight_binarize_plain(w)
    wsign = torch.ones((512, 3, 3, 512), dtype=torch.int8, device=cuda)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha)
    pdx = binary_conv2d_dgrad_plain(g, x, wsign, alpha)
    exact = dgrad_exact(g, x, wsign, alpha, 1, 1)
    torch.cuda.synchronize()
    terms = exact  # every term is positive
    assert bool(((dx.double() - exact).abs() <= 4 * U * terms + U * exact + 1e-30).all())
    # against the plain version where it is within its own float64 bound:
    # its f32 chain of 512 positive terms can drift beyond (chip_smoke.py)
    plain_in = (pdx.double() - exact).abs() <= 4 * U * terms + U * exact + 1e-30
    within = (dx - pdx).abs() <= 8 * U * terms.float() + U * pdx.abs() + 1e-30
    assert bool(within[plain_in].all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_k6_vs_exact(cuda, case):
    """K6 against the float64 sum (every product sx·(g·alpha) is exact,
    float64 holds these sums) within 4·u·Σ|terms| + u·|exact|."""
    from chip_smoke import wgrad_exact

    x, shift, w, g = _grad_operands(case, cuda, seed=16)
    k, s = case[5], case[6]
    _, alpha = weight_binarize_plain(w)
    dw = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=(s, s))
    exact = wgrad_exact(g, x, w, alpha, shift, s, k // 2)
    wterms = binary_conv2d_wgrad_plain(g.abs(), torch.ones_like(x), torch.zeros_like(w),
                                       alpha.abs(), strides=(s, s)).double()
    torch.cuda.synchronize()
    assert bool(((dw.double() - exact).abs() <= 4 * U * wterms + U * exact.abs() + 1e-30).all())


@pytest.mark.cuda
def test_k6_same_sign_terms_within_bound(cuda):
    """|g|, every activation sign +1 (x ≥ 0, no shift) and every |W| ≤ 1
    at C = O = 64, 3×3 s1 on 56×56 at batch 4: each dW entry is a sum of
    up to 12,544 positive terms, so no truncation or rounding bias of the
    sum can cancel."""
    from chip_smoke import wgrad_exact

    case = (4, 56, 56, 64, 64, 3, 1, False)
    x, _, w, g = _grad_operands(case, cuda, seed=17)
    x, g = x.abs(), g.abs()
    _, alpha = weight_binarize_plain(w)
    w = torch.zeros_like(w)
    dw = binary_conv2d_wgrad(g, x, w, alpha)
    exact = wgrad_exact(g, x, w, alpha, None, 1, 1)
    torch.cuda.synchronize()
    terms = exact  # every term is positive
    assert bool(((dw.double() - exact).abs() <= 4 * U * terms + U * exact + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["avg", "sum", "max"])
def test_k7_grouped_vs_plain(cuda, mode):
    rng = np.random.default_rng(13)
    shapes = [(3, 3, 64, 64), (1, 1, 64, 128), (3, 3, 128, 256), (7,), (20000,)]
    ws = [torch.from_numpy((rng.standard_t(5, size=s) * 0.05 + m).astype(np.float32)).to(cuda)
          for s, m in zip(shapes, (0.0, -8.0, 0.3, 2.0, 0.0))]
    targets = (1.8, 1.4, 1.2, 3.0, 1.0)
    before = kurtosis_grouped.launches
    loss, kurt, grads = kurtosis_grouped(ws, targets, mode)
    loss2, kurt2, grads2 = kurtosis_grouped(ws, targets, mode)
    ploss, pkurt, pgrads = kurtosis_grouped_plain(ws, targets, mode)
    torch.cuda.synchronize()
    assert kurtosis_grouped.launches == before + 2
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
    torch.testing.assert_close(kurt, pkurt, rtol=1e-5, atol=0)
    assert torch.equal(loss, loss2) and torch.equal(kurt, kurt2)
    for g, g2, pg in zip(grads, grads2, pgrads):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g, pg, rtol=0, atol=1e-5 * float(pg.abs().max()) + 1e-30)


# the stochastic family's draw u: no shift (react never samples), the
# vector and the scalar prep paths (C % 4), the three flagship shapes the
# chip smoke holds, and sizes off every tile edge
STOCH_CASES = [c for c in CONV_CASES if not c[7]] + [
    (2, 9, 9, 5, 4, 3, 1, False), (2, 8, 8, 8, 8, 3, 2, False), (2, 14, 14, 256, 96, 3, 2, False),
    (8, 56, 56, 64, 64, 3, 1, False), (8, 56, 56, 64, 128, 3, 2, False),
    (8, 7, 7, 512, 512, 3, 1, False), (3, 13, 11, 200, 131, 3, 2, False),
]
STOCH_IDS = [f"n{c[0]}-{c[1]}x{c[2]}-c{c[3]}-o{c[4]}-k{c[5]}s{c[6]}" for c in STOCH_CASES]


def _draw(x, seed):
    g = torch.Generator(device=x.device).manual_seed(seed)
    return torch.rand(x.shape, generator=g, device=x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STOCH_CASES, ids=STOCH_IDS)
def test_k1_with_u_bitwise_vs_plain(cuda, case):
    x, _, w = _operands(case, cuda, seed=31)
    u = _draw(x, 32)
    wsign, alpha = weight_binarize(w)
    st = (case[6], case[6])
    before = binary_conv2d.launches
    y = binary_conv2d(x, wsign, alpha, strides=st, u=u)
    plain = binary_conv2d_plain(x, wsign, alpha, strides=st, u=u)
    hard = binary_conv2d_plain(x, wsign, alpha, strides=st)
    torch.cuda.synchronize()
    assert binary_conv2d.launches == before + 1
    assert torch.equal(y, plain)
    assert not torch.equal(y, hard)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STOCH_CASES, ids=STOCH_IDS)
def test_k6_with_u_within_bound(cuda, case):
    """K6 with u against its plain version (8·u·Σ|terms| + u|plain|) and
    the float64 sum of the sampled signs (4·u·Σ|terms| + u|exact|), bitwise
    across two runs; the hard sign's dW lies far beyond that bound, so a
    K6 that ignored u would fail."""
    from chip_smoke import wgrad_exact

    x, _, w, g = _grad_operands(case, cuda, seed=33)
    u = _draw(x, 34)
    k, s = case[5], case[6]
    st = (s, s)
    _, alpha = weight_binarize_plain(w)
    dw = binary_conv2d_wgrad(g, x, w, alpha, strides=st, u=u)
    dw2 = binary_conv2d_wgrad(g, x, w, alpha, strides=st, u=u)
    pdw = binary_conv2d_wgrad_plain(g, x, w, alpha, strides=st, u=u)
    hard = binary_conv2d_wgrad_plain(g, x, w, alpha, strides=st)
    exact = wgrad_exact(g, x, w, alpha, None, s, k // 2, u=u)
    wterms = binary_conv2d_wgrad_plain(g.abs(), torch.ones_like(x), torch.zeros_like(w),
                                       alpha.abs(), strides=st)
    torch.cuda.synchronize()
    bound = 8 * U * wterms + U * pdw.abs() + 1e-30
    assert bool(((dw - pdw).abs() <= bound).all())
    assert bool(((dw.double() - exact).abs() <= 4 * U * wterms.double() + U * exact.abs() + 1e-30).all())
    assert torch.equal(dw, dw2)
    assert bool(((hard - pdw).abs() > 100 * bound).any())


def _k7_weights(dev, seed, shapes=((3, 3, 64, 64), (1, 1, 64, 128), (3, 3, 128, 256), (7,), (20000,)),
                means=(0.0, -8.0, 0.3, 2.0, 0.0)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_t(5, size=s) * 0.05 + m).astype(np.float32)).to(dev)
            for s, m in zip(shapes, means)]


def _k7_matches_plain(got, ws, targets, mode, with_grad=True):
    loss, kurt, grads = got
    ploss, pkurt, pgrads = kurtosis_grouped_plain(ws, targets, mode, with_grad=with_grad)
    torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
    torch.testing.assert_close(kurt, pkurt, rtol=1e-5, atol=0)
    if with_grad:
        for g, pg in zip(grads, pgrads):
            assert g.shape == pg.shape
            torch.testing.assert_close(g, pg, rtol=0, atol=1e-5 * float(pg.abs().max()) + 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["avg", "sum", "max"])
def test_k7_without_grad_is_the_same_finalize(cuda, mode):
    """Without the gradient K7 finalizes in one block: loss and kurt are
    the same bits as the call with the gradient, twice."""
    ws = _k7_weights(cuda, 13)
    targets = (1.8, 1.4, 1.2, 3.0, 1.0)
    full = kurtosis_grouped(ws, targets, mode)
    bare = kurtosis_grouped(ws, targets, mode, with_grad=False)
    bare2 = kurtosis_grouped(ws, targets, mode, with_grad=False)
    torch.cuda.synchronize()
    assert bare[2] is None
    _k7_matches_plain(bare, ws, targets, mode, with_grad=False)
    for a, b in ((full, bare), (bare, bare2)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_k7_follows_a_changed_tensor_set_and_in_place_updates(cuda):
    """The tensor table is cached per set of addresses, shapes and targets:
    another subset, other targets, weights updated in place (the same
    addresses, new values), a weight of another shape at a reused address
    and an offset view (no 16-byte access) each give the plain result."""
    ws = _k7_weights(cuda, 14)
    targets = (1.8, 1.4, 1.2, 3.0, 1.0)
    for sub, tg in ((ws, targets), (ws[1:4], targets[1:4]), (ws[::2], (2.0, 1.0, 1.5)),
                    (ws, (1.0,) * 5)):
        _k7_matches_plain(kurtosis_grouped(sub, tg, "avg"), sub, tg, "avg")
    for w in ws:
        w.mul_(1.5).add_(0.01)
    _k7_matches_plain(kurtosis_grouped(ws, targets, "max"), ws, targets, "max")
    flat = ws[0].reshape(-1)
    reshaped = [flat.view(64, 576), ws[1], flat[1:4097]]  # the last: 4 bytes off 16
    _k7_matches_plain(kurtosis_grouped(reshaped, (1.0, 2.0, 3.0), "sum"), reshaped,
                      (1.0, 2.0, 3.0), "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_k7_cuda_graph_replays(cuda, warm):
    """K7 captured in a CUDA graph (its table already cached, or packed
    during the capture): each replay reads the weights' current values and
    equals an eager call, bitwise."""
    from bdbnn_tpu_torch.nn.kernels import kurtosis as KM

    ws = _k7_weights(cuda, 15)
    targets = (1.8, 1.4, 1.2, 3.0, 1.0)
    if warm:
        kurtosis_grouped(ws, targets, "avg")
    else:
        KM._plans.clear()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        loss, kurt, grads = kurtosis_grouped(ws, targets, "avg")
    torch.cuda.current_stream().wait_stream(side)
    for step in range(3):
        graph.replay()
        eager = kurtosis_grouped(ws, targets, "avg")
        torch.cuda.synchronize()
        assert torch.equal(loss, eager[0]) and torch.equal(kurt, eager[1])
        assert all(torch.equal(a, b) for a, b in zip(grads, eager[2]))
        _k7_matches_plain((loss, kurt, grads), ws, targets, "avg")
        for w in ws:
            w.mul_(0.9).add_(0.003 * (step + 1))


# ---------------------------------------------------------------------------
# The bf16 modes of K1, K2, K5 and K6 (a bf16 model's binary convs)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# one bf16 rounding, relative: half an ulp, at most 2⁻⁸ of the value
UB = 2.0**-8
BF16_CASES = CONV_CASES + [
    (4, 56, 56, 64, 64, 3, 1, True), (4, 56, 56, 64, 128, 3, 2, True),
    (4, 7, 7, 512, 512, 3, 1, True), (3, 13, 11, 200, 131, 3, 2, False),
]


def _bf16_operands(case, dev, seed):
    x, shift, w = _operands(case, dev, seed)
    return x.to(BF16), shift.to(BF16) if shift is not None else None, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CASES)
def test_k1_bf16_bitwise_vs_plain(cuda, case):
    """K1's bf16 mode writes bf16(bf16(dot)·alpha): bitwise its plain
    version, with the hard sign and with a bf16 draw (no shift)."""
    x, shift, w = _bf16_operands(case, cuda, seed=41)
    wsign, alpha = weight_binarize(w, dtype=BF16)
    st = (case[6], case[6])
    before = (binary_conv2d.launches, binary_conv2d.launches_bf16)
    y = binary_conv2d(x, wsign, alpha, shift=shift, strides=st)
    plain = binary_conv2d_plain(x, wsign, alpha, shift=shift, strides=st)
    u = _draw(x, 42).to(BF16)
    yu = binary_conv2d(x, wsign, alpha, strides=st, u=u)
    plain_u = binary_conv2d_plain(x, wsign, alpha, strides=st, u=u)
    torch.cuda.synchronize()
    assert (binary_conv2d.launches, binary_conv2d.launches_bf16) == (before[0] + 2, before[1] + 2)
    assert y.dtype == BF16 and torch.equal(y, plain)
    assert torch.equal(yu, plain_u)


@pytest.mark.cuda
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "w+4B"])
@pytest.mark.parametrize("shape", WEIGHT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_bf16_vs_plain(cuda, lab, shape, offset):
    """K2's bf16 mode: the sign of bf16(W) bitwise (a negative subnormal
    rounds to -0 and takes +1), alpha bf16 within one bf16 rounding of the
    plain version (both sum in float64) and bitwise across two runs."""
    w = _weight(shape, cuda, 43, offset)
    w.reshape(-1)[7::29] = -1e-40  # rounds to -0 in bf16
    before = weight_binarize.launches_bf16
    sign, alpha = weight_binarize(w, lab=lab, dtype=BF16)
    sign2, alpha2 = weight_binarize(w, lab=lab, dtype=BF16)
    psign, palpha = weight_binarize_plain(w, lab=lab, dtype=BF16)
    torch.cuda.synchronize()
    assert weight_binarize.launches_bf16 == before + 2
    assert torch.equal(sign, psign) and alpha.dtype == BF16
    assert bool(((alpha.float() - palpha.float()).abs() <= UB * palpha.float().abs()).all())
    assert torch.equal(sign, sign2) and torch.equal(alpha, alpha2)


@pytest.mark.cuda
@pytest.mark.parametrize("est", ESTIMATORS, ids=[e[0] for e in ESTIMATORS])
@pytest.mark.parametrize("case", BF16_CASES)
def test_k5_k6_bf16_vs_plain(cuda, case, est):
    """K5's and K6's bf16 modes (one bf16 piece of g·alpha) against their
    plain versions: the sums before the bf16 rounding agree to the f32
    summation bound 8·2⁻²⁴·Σ|terms|, so the rounded sums lie within that
    plus one bf16 rounding on each side, and the slope multiply rounds once
    more on each side; bitwise across two runs."""
    x, shift, w, g = _grad_operands(case, cuda, seed=44)
    x, g = x.to(BF16), g.to(BF16)
    shift = shift.to(BF16) if shift is not None else None
    st = (case[6], case[6])
    wsign, alpha = weight_binarize_plain(w, dtype=BF16)
    before = (binary_conv2d_dgrad.launches_bf16, binary_conv2d_wgrad.launches_bf16)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    dx2 = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    dw = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st)
    dw2 = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st)
    pdx = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    pdw = binary_conv2d_wgrad_plain(g, x, w, alpha, shift=shift, strides=st)
    torch.cuda.synchronize()
    assert (binary_conv2d_dgrad.launches_bf16, binary_conv2d_wgrad.launches_bf16) == (
        before[0] + 2, before[1] + 2
    )
    assert dx.dtype == BF16 and dw.dtype == torch.float32
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    ga = (g * alpha).float()
    terms = binary_conv2d_dgrad_plain(ga.abs(), x.float(), torch.ones_like(wsign),
                                      torch.ones_like(alpha, dtype=torch.float32), strides=st)
    sum_plain = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift, strides=st).float()
    slope = estimator_slope((x - shift if shift is not None else x), est).float().abs()
    bound5 = ((8 * U * terms + 2 * UB * sum_plain.abs()) * slope
              + UB * (dx.float().abs() + pdx.float().abs()) + 1e-30)
    over = (dx.float() - pdx.float()).abs() - bound5
    if bool((over > 0).any()):
        i = int(over.reshape(-1).argmax())
        v = (x - shift if shift is not None else x).reshape(-1)[i]
        raw = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st).reshape(-1)[i]
        pytest.fail(
            f"dx beyond the bound at {int((over > 0).sum())} entries; the worst, flat index {i}: "
            f"v={float(v)!r} plain slope={float(slope.reshape(-1)[i])!r} "
            f"cpu slope={float(estimator_slope(v.cpu().reshape(1), est)[0])!r} "
            f"dx={float(dx.reshape(-1)[i])!r} plain dx={float(pdx.reshape(-1)[i])!r} "
            f"sum={float(raw)!r} plain sum={float(sum_plain.reshape(-1)[i])!r}"
        )
    wterms = binary_conv2d_wgrad_plain(ga.abs(), torch.ones_like(x.float()), torch.zeros_like(w),
                                       torch.ones_like(alpha, dtype=torch.float32), strides=st)
    assert bool(((dw - pdw).abs() <= 8 * U * wterms + UB * (dw.abs() + pdw.abs()) + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", STOCH_CASES[-4:], ids=STOCH_IDS[-4:])
def test_k6_bf16_with_u_within_bound(cuda, case):
    x, _, w, g = _grad_operands(case, cuda, seed=45)
    x, g = x.to(BF16), g.to(BF16)
    u = _draw(x, 46).to(BF16)
    st = (case[6], case[6])
    _, alpha = weight_binarize_plain(w, dtype=BF16)
    dw = binary_conv2d_wgrad(g, x, w, alpha, strides=st, u=u)
    pdw = binary_conv2d_wgrad_plain(g, x, w, alpha, strides=st, u=u)
    hard = binary_conv2d_wgrad_plain(g, x, w, alpha, strides=st)
    ga = (g * alpha).float()
    wterms = binary_conv2d_wgrad_plain(ga.abs(), torch.ones_like(x.float()), torch.zeros_like(w),
                                       torch.ones_like(alpha, dtype=torch.float32), strides=st)
    torch.cuda.synchronize()
    bound = 8 * U * wterms + UB * (dw.abs() + pdw.abs()) + 1e-30
    assert bool(((dw - pdw).abs() <= bound).all())
    assert bool(((hard - pdw).abs() > 100 * bound).any())


# The redesigned bf16 kernels (K1 bf16: the halo signed in shared memory,
# wgmma s8; K6 bf16: the warp-specialized wgmma bf16 with the folded
# chains and the split of wgrad_bf16_splits) at shapes off their edges: C
# not a multiple of 8, 32 or 64 (the chunk), O not a multiple of the
# 64-channel tile, stride 2, 1x1 downsamples, M not a multiple of the
# 128-position tile, reductions split and not, the hard sign with and
# without a shift and the draw u
BF16_EDGE_CASES = [
    (2, 9, 9, 5, 4, 3, 1, True),
    (1, 7, 9, 6, 3, 3, 2, False),
    (2, 5, 5, 7, 3, 1, 1, True),
    (1, 6, 6, 40, 70, 3, 1, False),
    (3, 13, 11, 200, 131, 3, 2, True),
    (3, 16, 16, 64, 64, 3, 1, True),
    (2, 14, 14, 128, 256, 1, 1, True),
    (5, 7, 7, 512, 96, 3, 1, False),
    (4, 28, 28, 96, 72, 3, 2, True),
]
BF16_EDGE_IDS = [f"n{c[0]}-{c[1]}x{c[2]}-c{c[3]}-o{c[4]}-k{c[5]}s{c[6]}-"
                 f"{'shift' if c[7] else 'none'}" for c in BF16_EDGE_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("draw", [False, True], ids=["hard", "u"])
@pytest.mark.parametrize("case", BF16_EDGE_CASES, ids=BF16_EDGE_IDS)
def test_k1_bf16_edge_shapes_bitwise(cuda, case, draw):
    """K1 bf16 bitwise its plain bf16 version and across two runs, one
    launch a call counted in its bf16 mode."""
    x, shift, w = _bf16_operands(case, cuda, seed=51)
    wsign, alpha = weight_binarize(w, dtype=BF16)
    st = (case[6], case[6])
    u = _draw(x, 52).to(BF16) if draw else None
    if draw:
        shift = None
    before = binary_conv2d.launches_bf16
    y = binary_conv2d(x, wsign, alpha, shift=shift, strides=st, u=u)
    y2 = binary_conv2d(x, wsign, alpha, shift=shift, strides=st, u=u)
    plain = binary_conv2d_plain(x, wsign, alpha, shift=shift, strides=st, u=u)
    torch.cuda.synchronize()
    assert binary_conv2d.launches_bf16 == before + 2
    assert y.dtype == BF16 and torch.equal(y, plain) and torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", [False, True], ids=["hard", "u"])
@pytest.mark.parametrize("case", BF16_EDGE_CASES, ids=BF16_EDGE_IDS)
def test_k6_bf16_edge_shapes_within_bound(cuda, case, draw):
    """K6 bf16 against the float64 sum of the same bf16 products (within
    4·2⁻²⁴·Σ|terms| plus one bf16 rounding of it, the STE mask on bf16(W))
    and against its plain version (8·2⁻²⁴·Σ|terms| plus a bf16 rounding on
    each side), bitwise across two runs: chip_smoke.py's [train-bf16] (a)
    gates."""
    from chip_smoke import wgrad_exact

    x, shift, w, g = _grad_operands(case, cuda, seed=53)
    x, g = x.to(BF16), g.to(BF16)
    shift = shift.to(BF16) if shift is not None and not draw else None
    u = _draw(x, 54).to(BF16) if draw else None
    k, s = case[5], case[6]
    st = (s, s)
    _, alpha = weight_binarize_plain(w, dtype=BF16)
    before = binary_conv2d_wgrad.launches_bf16
    dw = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st, u=u)
    dw2 = binary_conv2d_wgrad(g, x, w, alpha, shift=shift, strides=st, u=u)
    pdw = binary_conv2d_wgrad_plain(g, x, w, alpha, shift=shift, strides=st, u=u)
    exact = wgrad_exact(g, x, w.to(BF16).float(), alpha, shift, s, k // 2, u=u)
    ga = (g * alpha).float()
    wterms = binary_conv2d_wgrad_plain(ga.abs(), torch.ones_like(x.float()), torch.zeros_like(w),
                                       torch.ones_like(alpha, dtype=torch.float32),
                                       strides=st).double()
    torch.cuda.synchronize()
    assert binary_conv2d_wgrad.launches_bf16 == before + 2
    assert dw.dtype == torch.float32 and torch.equal(dw, dw2)
    assert bool(((dw.double() - exact).abs() <= 4 * U * wterms + UB * exact.abs() + 1e-30).all())
    assert bool(((dw - pdw).abs().double()
                 <= 8 * U * wterms + UB * (dw.abs() + pdw.abs()).double() + 1e-30).all())


def _k5_bf16_bounds(g, x, wsign, alpha, shift, s, k, est, dx, pdx):
    """K5 bf16's gates (chip_smoke.py [train-bf16] (a)): (error, bound)
    against the float64 sum of the same bf16 products times the slope —
    4·2⁻²⁴·Σ|terms| plus one bf16 rounding of the sum, and the slope
    multiply's rounding on each side — and against the plain version —
    8·2⁻²⁴·Σ|terms| plus a bf16 rounding of the sum and of the slope
    multiply on each side."""
    from chip_smoke import dgrad_exact

    st = (s, s)
    exact = dgrad_exact(g, x, wsign, alpha, s, k // 2)
    ga = (g * alpha).float()
    terms = binary_conv2d_dgrad_plain(ga.abs(), x.float(), torch.ones_like(wsign),
                                      torch.ones_like(alpha, dtype=torch.float32),
                                      strides=st).double()
    slope = estimator_slope(x - shift if shift is not None else x, est)
    slope = (slope if slope is not None else torch.ones_like(x)).double().abs()
    ex = exact * slope
    d, p = dx.double(), pdx.double()
    bound_ex = (4 * U * terms + UB * exact.abs()) * slope + UB * (d.abs() + ex.abs()) + 1e-30
    bound_p = (8 * U * terms + 2 * UB * exact.abs()) * slope + UB * (d.abs() + p.abs()) + 1e-30
    return (d - ex).abs(), bound_ex, (d - p).abs(), bound_p


@pytest.mark.cuda
@pytest.mark.parametrize("est", ESTIMATORS + [("none", 0.0, 0.0)],
                         ids=[e[0] for e in ESTIMATORS] + ["none"])
@pytest.mark.parametrize("case", BF16_EDGE_CASES, ids=BF16_EDGE_IDS)
def test_k5_bf16_edge_shapes_within_bound(cuda, case, est):
    """K5 bf16 (csrc/binary_conv_dgrad_bf16.cu) at shapes off its tiles,
    stages and halo: against the float64 sum within 4·2⁻²⁴·Σ|terms| plus
    one bf16 rounding, against its plain version within 8·2⁻²⁴·Σ|terms|
    plus the roundings, bitwise across two runs, one launch a call counted
    in its bf16 mode."""
    x, shift, w, g = _grad_operands(case, cuda, seed=61)
    x, g = x.to(BF16), g.to(BF16)
    shift = shift.to(BF16) if shift is not None else None
    k, s = case[5], case[6]
    st = (s, s)
    wsign, alpha = weight_binarize_plain(w, dtype=BF16)
    before = (binary_conv2d_dgrad.launches, binary_conv2d_dgrad.launches_bf16)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    dx2 = binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    torch.cuda.synchronize()
    assert (binary_conv2d_dgrad.launches, binary_conv2d_dgrad.launches_bf16) == (
        before[0] + 2, before[1] + 2
    )
    pdx = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift, strides=st, estimator=est)
    err_ex, bound_ex, err_p, bound_p = _k5_bf16_bounds(g, x, wsign, alpha, shift, s, k, est,
                                                       dx, pdx)
    assert dx.dtype == BF16 and torch.equal(dx, dx2)
    assert bool((err_ex <= bound_ex).all()), float((err_ex / bound_ex).max())
    assert bool((err_p <= bound_p).all()), float((err_p / bound_p).max())


@pytest.mark.cuda
def test_k5_bf16_same_sign_terms_within_bound(cuda):
    """|g|, alpha > 0 and every weight sign +1 at layer4's 3×3 s1 512→512
    @7: each dx entry sums 4,608 positive terms, so a drift of the tensor
    cores' truncation cannot cancel. Held to the float64 sum (Σ|terms| is
    the sum itself) within 4·2⁻²⁴·Σ|terms| plus one bf16 rounding."""
    from chip_smoke import dgrad_exact

    case = (8, 7, 7, 512, 512, 3, 1, False)
    x, _, w, g = _grad_operands(case, cuda, seed=62)
    x, g = x.to(BF16), g.abs().to(BF16)
    alpha = (0.05 + w.abs().mean(dim=(0, 1, 2))).to(BF16)
    wsign = torch.ones((512, 3, 3, 512), dtype=torch.int8, device=cuda)
    dx = binary_conv2d_dgrad(g, x, wsign, alpha)
    exact = dgrad_exact(g, x, wsign, alpha, 1, 1)
    torch.cuda.synchronize()
    assert bool(((dx.double() - exact).abs() <= 4 * U * exact + UB * exact + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(32, 7, 7, 512, 512, 3, 1, True), (9, 29, 31, 72, 200, 3, 2, True)],
                         ids=["layer4-b32", "c72-o200-s2"])
def test_k5_bf16_long_k_bitwise_across_runs(cuda, case):
    """K5 bf16 over a long reduction (16 stages of 9 taps at layer4's
    width; 7 stages of up to 4 taps off the tiles), every block walking
    several tiles through its ring: five runs bitwise alike, within the
    float64 sum's bound."""
    x, shift, w, g = _grad_operands(case, cuda, seed=63)
    x, g, shift = x.to(BF16), g.to(BF16), shift.to(BF16)
    k, s = case[5], case[6]
    wsign, alpha = weight_binarize_plain(w, dtype=BF16)
    est = ("approx", 0.0, 0.0)
    runs = [binary_conv2d_dgrad(g, x, wsign, alpha, shift=shift, strides=(s, s), estimator=est)
            for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    pdx = binary_conv2d_dgrad_plain(g, x, wsign, alpha, shift=shift, strides=(s, s),
                                    estimator=est)
    err_ex, bound_ex, _, _ = _k5_bf16_bounds(g, x, wsign, alpha, shift, s, k, est, runs[0], pdx)
    assert bool((err_ex <= bound_ex).all())


@pytest.mark.cuda
def test_k5_bf16_smem_is_the_schedules(cuda):
    """The kernel's shared memory a block is what dgrad_bf16_schedule
    sized, at the flagship's ten shapes."""
    from bdbnn_tpu_torch.nn.kernels import _build
    from bdbnn_tpu_torch.nn.kernels.binary_conv import dgrad_bf16_schedule

    lib = _build.library("binary_conv_dgrad_bf16")
    for _, hw, _, _, k, s, _ in FLAGSHIP_CONVS:
        halo, taps, nstage, smem = dgrad_bf16_schedule(256, hw, hw, k, k, s, k // 2)
        assert nstage >= 2 and lib.bdbnn_binary_conv_dgrad_bf16_smem(halo, taps, nstage) == smem


# K6 bf16 with the draw over one long split (49 stages of 128 positions a
# block): the draw's one-stage raw ring reuses its slot every stage, off
# the vector path (C and O not multiples of 8, every chunk a synchronous
# load) and on it
K6_BF16_LONG_CASES = [(32, 14, 14, 509, 130, 3, 1, False), (32, 14, 14, 512, 192, 3, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_BF16_LONG_CASES, ids=["c509-o130", "c512-o192"])
def test_k6_bf16_draw_long_split_bitwise_across_runs(cuda, case):
    """K6 bf16 with a draw u, one split of 49 stages: five runs bitwise
    alike and within the float64 sum's bound."""
    from chip_smoke import wgrad_exact

    n, h, wd, c, o, k, s, _ = case
    cp = -(-c // 8) * 8
    assert wgrad_bf16_splits(n * h * wd, k * k * cp, k * k * c, o) == (1, 6272)
    x, _, w, g = _grad_operands(case, cuda, seed=57)
    x, g = x.to(BF16), g.to(BF16)
    u = _draw(x, 58).to(BF16)
    _, alpha = weight_binarize_plain(w, dtype=BF16)
    runs = [binary_conv2d_wgrad(g, x, w, alpha, u=u) for _ in range(5)]
    exact = wgrad_exact(g, x, w.to(BF16).float(), alpha, None, s, k // 2, u=u)
    ga = (g * alpha).float()
    wterms = binary_conv2d_wgrad_plain(ga.abs(), torch.ones_like(x.float()), torch.zeros_like(w),
                                       torch.ones_like(alpha, dtype=torch.float32)).double()
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert bool(((runs[0].double() - exact).abs()
                 <= 4 * U * wterms + UB * exact.abs() + 1e-30).all())


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_step_as_one_process(cuda):
    """A data-parallel train step of ``resnet20_react`` on ``cuda:0``: two
    ranks over gloo (global BN statistics, DDP's gradient all-reduce on
    card tensors) against one process on the card fed the concatenated
    batch, whose binary convs and RPReLUs take the job's inputs (the
    threshold crossings of BN's sums in another order replayed away): the
    loss to rtol 1e-5,
    every gradient within 1e-3 of its tensor's largest |entry|, the ranks'
    gradients and final states bitwise equal, K1, K2, K5 and K6 launched
    on each rank."""
    import chip_smoke

    cfg_kw = dict(dataset="cifar10", arch="resnet20_react", synthetic=True, seed=0, lr=0.05,
                  epochs=2, w_kurtosis=True, device="cuda")
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, size=(8,)).astype(np.int64)) for _ in range(2)]
    ranks = chip_smoke.spawn_ranks(
        "steps", 2, "cuda:0", "gloo",
        dict(cfg_kw=cfg_kw, batches=batches, device="cuda:0", inputs="record"), timeout_s=300)
    inputs = [torch.cat(per_rank) for per_rank in zip(*(r["inputs"] for r in ranks))]
    one = chip_smoke.ddp_steps(cfg_kw, batches[:1], device="cuda", inputs=inputs)
    cmp = chip_smoke.compare_ddp_step(ranks, one)
    assert cmp["ranks_grads_equal"] and cmp["loss_rel"] <= 1e-5
    assert max(cmp["grad_err"].values()) <= 1e-3, cmp["grad_err"]
    assert not chip_smoke.state_diff(ranks[0]["state"], ranks[1]["state"])
    assert all(r["launches"][k] > 0 for r in ranks for k in ("K1", "K2", "K5", "K6"))


@pytest.mark.cuda
def test_http_front_end_over_the_flagship_engine(cuda, tmp_path):
    """``HttpFrontEnd`` over the flagship engine on ``cuda:0``: 8 raw
    float32 requests at once over loopback, every answer equal to the
    engine's logits of the batch it rode in (recomputed on the same
    batch), rounded to 4 places, with the argmax as ``pred``; /readyz
    reads the engine's warm state."""
    import json
    import socket
    import threading

    import chip_smoke
    from bdbnn_tpu_torch.serve.admission import AdmissionController
    from bdbnn_tpu_torch.serve.batching import MicroBatcher
    from bdbnn_tpu_torch.serve.engine import InferenceEngine
    from bdbnn_tpu_torch.serve.http import HttpFrontEnd, image_codec
    from bdbnn_tpu_torch.serve.loadgen import recv_response

    art = str(tmp_path / "resnet18_react")
    chip_smoke.make_flagship_artifact(art)
    engine = InferenceEngine(art, buckets=(1, 8), device="cuda", warm=False)
    batches = []

    def runner(xs):
        out = engine.predict_logits(np.stack(xs))
        batches.append((np.stack(xs), out))
        return out

    decode, encode = image_codec(224)
    fe = HttpFrontEnd(MicroBatcher(runner, max_batch=8, max_queue=16, max_delay_ms=50.0,
                                   priorities=3),
                      AdmissionController(default_rate=1e9, default_burst=1e9),
                      ready_fn=lambda: engine.warmed, decode=decode, encode=encode, port=0)
    host, port = fe.start()

    def call(method, path, body=b"", headers=None):
        with socket.create_connection((host, port), timeout=60) as s:
            head = f"{method} {path} HTTP/1.1\r\nhost: t\r\ncontent-length: {len(body)}\r\n"
            for k, v in (headers or {}).items():
                head += f"{k}: {v}\r\n"
            s.sendall((head + "connection: close\r\n\r\n").encode("latin-1") + body)
            status, _, raw = recv_response(s.makefile("rb"))
            return status, json.loads(raw)

    try:
        assert call("GET", "/readyz")[0] == 503
        engine.warmup()
        assert call("GET", "/readyz")[0] == 200
        x = np.random.default_rng(3).integers(-1, 2, size=(8, 224, 224, 3)).astype(np.float32)
        answers = {}
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, call(
            "POST", "/v1/predict", x[i].astype("<f4").tobytes(),
            {"content-type": "application/octet-stream", "x-priority": str(i % 3)})))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        assert fe.drain(timeout=60)
    assert sorted(answers) == list(range(8)) and all(a[0] == 200 for a in answers.values())
    for batch, out in batches:
        want = engine.predict_logits(batch)
        assert np.array_equal(out.view(np.uint32), want.view(np.uint32))
        for row, img in enumerate(batch):
            (i,) = [i for i in range(8) if np.array_equal(x[i], img)]
            assert answers[i][1]["result"] == encode(want[row])


@pytest.mark.cuda
def test_a_traced_flagship_forward_charges_k1_and_k2_to_their_layers(cuda, tmp_path):
    """A bucket-8 flagship forward inside the engine's trace window: every
    K1 and K2 kernel of the trace lies in a binary conv's layer (its scope
    span), one of each a layer a forward; the stem and the classifier are
    attributed too."""
    import chip_smoke
    from bdbnn_tpu_torch.obs.roofline import model_layer_table
    from bdbnn_tpu_torch.obs.trace import (
        attribute_trace_layers,
        find_trace_file,
        layer_needles,
        layer_of,
        scoped_device_ops,
    )
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    art = str(tmp_path / "resnet18_react")
    chip_smoke.make_flagship_artifact(art)
    engine = InferenceEngine(art, buckets=(8,), device="cuda")
    t = engine.trace_step(str(tmp_path / "tr"), bucket=8, iters=2)
    trace = find_trace_file(str(tmp_path / "tr"))
    rows = model_layer_table("resnet18", "imagenet", 8, image_size=224)
    binary = {r["name"] for r in rows if r["kind"] == "binary"}
    needles = layer_needles({r["name"]: r["scope"] for r in rows})
    per = {}
    for op in scoped_device_ops(trace):
        k = chip_smoke.k_of(op["name"])
        if k in ("K1", "K2"):
            layer = layer_of(op["path"], needles)
            assert layer in binary, (op["name"], op["path"])
            if chip_smoke.PERF_TRACE_NAMES[k] in op["name"]:
                per[(layer, k)] = per.get((layer, k), 0) + 1
    assert per == {(name, k): t["iters"] for name in binary for k in ("K1", "K2")}
    att = attribute_trace_layers(trace, t["iters"], layers={r["name"]: r["scope"] for r in rows})
    assert set(att["layers"]) == {r["name"] for r in rows}


@pytest.mark.cuda
def test_spans_off_a_window_add_no_launch(cuda, tmp_path):
    """Outside a window a span is the shared nullcontext and a forward's
    launch counts are those of 19 binary convs; inside one the same
    forward launches the same kernels, and no more."""
    import chip_smoke
    from bdbnn_tpu_torch.obs import trace as ttrace
    from bdbnn_tpu_torch.serve.engine import InferenceEngine

    art = str(tmp_path / "resnet18_react")
    chip_smoke.make_flagship_artifact(art)
    engine = InferenceEngine(art, buckets=(8,), device="cuda", packed=True)
    x = np.zeros((8, 224, 224, 3), np.float32)
    assert not ttrace.spans_recording() and ttrace.span("a") is ttrace.span("b")
    chip_smoke.reset_counts()
    engine.predict_logits(x)
    off = chip_smoke.read_counts()
    cap = ttrace.TraceCapture(str(tmp_path / "tr"), [(0, 0, 1)], device=engine.device)
    assert cap.maybe_start(0, 0)
    chip_smoke.reset_counts()
    engine.predict_logits(x)
    on = chip_smoke.read_counts()
    cap.stop_if_active()
    assert off == on and off["K1"] == off["K2"] == off["K3"] == 19

"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips with a reason where
no CUDA device exists (this file imports torch and the port only, no
JAX). On the GPU machine:

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
    binary_conv2d_plain,
    weight_binarize,
    weight_binarize_plain,
)
from bdbnn_tpu_torch.serve.export import _pack_sign

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_k1_k4_bitwise_vs_plain(cuda, case):
    x, shift, w = _operands(case, cuda, seed=8)
    st = (case[6], case[6])
    wsign, alpha = weight_binarize_plain(w)
    before = (binary_conv2d.launches, P.popcount_binary_conv.launches)
    plain = binary_conv2d_plain(x, wsign, alpha, shift=shift, strides=st)
    k1 = binary_conv2d(x, wsign, alpha, shift=shift, strides=st)
    k4 = P.popcount_binary_conv(x, wsign, alpha, shift=shift, strides=st)
    torch.cuda.synchronize()
    assert (binary_conv2d.launches, P.popcount_binary_conv.launches) == (
        before[0] + 1, before[1] + 1
    )
    assert torch.equal(k1, plain)
    assert torch.equal(k4, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("lab", [False, True])
@pytest.mark.parametrize("shape", [(3, 3, 5, 4), (3, 3, 64, 48), (1, 1, 7, 130)])
def test_k2_vs_plain(cuda, lab, shape):
    w = torch.from_numpy(
        np.random.default_rng(9).normal(0, 0.05, shape).astype(np.float32)
    ).to(cuda)
    sign, alpha = weight_binarize(w, lab=lab)
    psign, palpha = weight_binarize_plain(w, lab=lab)
    torch.cuda.synchronize()
    assert torch.equal(sign, psign)
    torch.testing.assert_close(alpha, palpha, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 3, 7, 5), (1, 1, 64, 128)])
def test_k3_vs_plain(cuda, shape):
    w = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    packed = torch.from_numpy(_pack_sign(w)).to(cuda)
    alpha = torch.rand(shape[-1], device=cuda) + 0.1
    got = P.packed_dense_weight(packed, alpha, shape)
    torch.cuda.synchronize()
    assert torch.equal(got, P.packed_dense_weight_plain(packed, alpha, shape))


@pytest.mark.cuda
def test_wrapper_refuses_non_contiguous_cuda_input(cuda):
    x = torch.zeros(1, 4, 4, 8, device=cuda).permute(0, 2, 1, 3)
    wsign, alpha = weight_binarize_plain(torch.zeros(3, 3, 8, 4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        binary_conv2d(x, wsign, alpha)

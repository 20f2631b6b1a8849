"""Hand-written Hopper kernels for the binary compute hot spot.

- K1 ``binary_conv2d`` — fused sign + ±1 conv (``csrc/binary_conv.cu``;
  its bf16 mode ``csrc/binary_conv_fwd_bf16.cu``);
- K2 ``weight_binarize`` — weight sign + alpha (``csrc/weight_binarize.cu``);
- K3 / K4 live in :mod:`bdbnn_tpu_torch.nn.packed` (``csrc/packed.cu``);
- K5 ``binary_conv2d_dgrad`` — input gradient with the sign estimator's
  slope (``csrc/binary_conv_dgrad.cu``);
- K6 ``binary_conv2d_wgrad`` — weight gradient with the STE mask
  (``csrc/binary_conv_wgrad.cu``; its bf16 mode
  ``csrc/binary_conv_wgrad_bf16.cu``);
- K7 ``kurtosis_grouped`` — the grouped kurtosis regularizer and its
  gradient (``csrc/kurtosis.cu``).

Kernels are built with ``nvcc`` at first use (:mod:`._build`); importing
this package needs neither ``nvcc`` nor a card.
"""

from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    BinaryConvFn,
    binary_conv2d,
    binary_conv2d_dgrad,
    binary_conv2d_dgrad_plain,
    binary_conv2d_mxu,
    binary_conv2d_plain,
    binary_conv2d_wgrad,
    binary_conv2d_wgrad_plain,
)
from bdbnn_tpu_torch.nn.kernels.kurtosis import kurtosis_grouped, kurtosis_grouped_plain
from bdbnn_tpu_torch.nn.kernels.weight_binarize import (
    weight_binarize,
    weight_binarize_plain,
    weight_binarize_splits,
)

__all__ = [
    "BinaryConvFn",
    "binary_conv2d",
    "binary_conv2d_dgrad",
    "binary_conv2d_dgrad_plain",
    "binary_conv2d_mxu",
    "binary_conv2d_plain",
    "binary_conv2d_wgrad",
    "binary_conv2d_wgrad_plain",
    "kurtosis_grouped",
    "kurtosis_grouped_plain",
    "weight_binarize",
    "weight_binarize_plain",
    "weight_binarize_splits",
]

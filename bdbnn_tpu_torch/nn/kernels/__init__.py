"""Hand-written Hopper kernels for the binary compute hot spot.

- K1 ``binary_conv2d`` — fused sign + ±1 conv (``csrc/binary_conv.cu``);
- K2 ``weight_binarize`` — weight sign + alpha (``csrc/weight_binarize.cu``);
- K3 / K4 live in :mod:`bdbnn_tpu_torch.nn.packed` (``csrc/packed.cu``).

Kernels are built with ``nvcc`` at first use (:mod:`._build`); importing
this package needs neither ``nvcc`` nor a card.
"""

from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    binary_conv2d,
    binary_conv2d_mxu,
    binary_conv2d_plain,
)
from bdbnn_tpu_torch.nn.kernels.weight_binarize import (
    weight_binarize,
    weight_binarize_plain,
)

__all__ = [
    "binary_conv2d",
    "binary_conv2d_mxu",
    "binary_conv2d_plain",
    "weight_binarize",
    "weight_binarize_plain",
]

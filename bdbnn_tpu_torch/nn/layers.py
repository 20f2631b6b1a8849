"""Binary conv modules (``torch.nn``), counterparts of
``bdbnn_tpu/nn/layers.py``.

- ``BinaryConvReact`` — sign(x - act_shift) input (ApproxSign backward in
  training), magnitude-scaled binary weights; the ImageNet react recipe.
- ``BinaryConv``      — family-routed input binarization ("step 2").
- ``BinaryConvCifar`` — the CIFAR variant (EDE-able in training).
- ``FloatConv``       — the full-precision twin (``weight``, OIHW).
- ``LearnableBias``, ``RPReLU`` — ReActNet's shift and activation.

Activations are NHWC tensors (the reference's layout). A binary conv
keeps its latent weight ``float_weight`` in HWIO, as the reference does,
or — built with ``packed=True`` — a packed ``{sign, alpha}`` buffer pair
(the export artifact's 1-bit representation) and no ``float_weight``.

The forward runs every binary conv on the hand-written kernels:
K3 (packed only: unpack to ``sign * alpha``) → K2 (weight sign + the
active family's alpha) → K1 (fused ``sign(x - shift)`` + ±1 conv), or
K4 in place of K1 under the ``popcount`` packed impl. On the CPU each
wrapper runs its plain PyTorch version.

This slice serves: the binary convs and BatchNorm run in eval mode only
and raise in training mode (training and the backward kernels come in a
later slice). In eval every family's activation forward is the hard
sign, which is what K1 and K4 fuse.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch import nn

from bdbnn_tpu_torch.nn.binarize import get_active_family
from bdbnn_tpu_torch.nn.kernels import binary_conv2d, weight_binarize

Tensor = torch.Tensor

BN_EPS = 1e-5


def _training_slice_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} runs in eval mode only in this slice of the port "
        "(serving); training mode and the backward kernels arrive with "
        "the training slice — call .eval()"
    )


def he_normal_(t: Tensor, fan_in: int, generator: Optional[torch.Generator]) -> Tensor:
    """flax ``he_normal``: truncated normal (±2σ) with variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_normal_(t: Tensor, fan_in: int, generator: Optional[torch.Generator]) -> Tensor:
    """flax ``lecun_normal`` (the Dense default): variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


def conv2d(x: Tensor, w: Tensor, *, strides: Tuple[int, int] = (1, 1), padding="auto") -> Tensor:
    """NHWC input, OIHW weight full-precision conv with torch-style
    symmetric ``k//2`` padding ("auto"); NHWC output."""
    if padding == "auto":
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    y = nn.functional.conv2d(x.permute(0, 3, 1, 2), w, stride=tuple(strides), padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` in eval mode over the last (channel) axis:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, the reference's
    order of operations. Parameters ``weight``/``bias`` (flax
    ``scale``/``bias``), buffers ``running_mean``/``running_var`` (flax
    ``batch_stats``)."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            raise _training_slice_error("BatchNorm")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class LearnableBias(nn.Module):
    """Per-channel learnable shift (ReActNet's "move" op)."""

    def __init__(self, features: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        return x + self.bias


class RPReLU(nn.Module):
    """ReActNet RPReLU: ``PReLU_slope(x - gamma) + zeta``, per channel."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(features))
        self.zeta = nn.Parameter(torch.zeros(features))
        self.slope = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: Tensor) -> Tensor:
        y = x - self.gamma
        y = torch.where(y >= 0, y, self.slope * y)
        return y + self.zeta


class _BinaryConvBase(nn.Module):
    """Shared body: latent ``float_weight`` (HWIO) or packed
    ``{sign, alpha}`` buffers + the magnitude-scaled binary conv."""

    has_shift = False

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Tuple[int, int] = (1, 1),
        padding: Any = "auto",
        *,
        packed: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.packed = packed
        shape = self.weight_shape
        if packed:
            n = shape[0] * shape[1] * shape[2] * shape[3]
            self.register_buffer("sign", torch.zeros(((n + 7) // 8,), dtype=torch.uint8))
            self.register_buffer("alpha", torch.ones(features))
        else:
            fan_in = shape[0] * shape[1] * shape[2]
            self.float_weight = nn.Parameter(he_normal_(torch.empty(shape), fan_in, generator))
        if self.has_shift:
            self.act_shift = nn.Parameter(torch.zeros(in_features))

    @property
    def weight_shape(self) -> Tuple[int, int, int, int]:
        return (*self.kernel_size, self.in_features, self.features)

    def binary_conv(self, x: Tensor, shift: Optional[Tensor]) -> Tensor:
        """±alpha binary conv of ``sign(x - shift)``: K3 (packed) → K2
        → K1, or K4 under the ``popcount`` packed impl. The weight sign
        and alpha come from the active binarizer family (alpha: mean|W|,
        or ``lab``'s ΣW²/Σ|W|); the export fixed point mean|sign·alpha|
        == alpha makes the packed path family-invariant."""
        from bdbnn_tpu_torch.nn.packed import (
            get_packed_impl,
            packed_dense_weight,
            popcount_binary_conv,
        )

        if self.training:
            raise _training_slice_error(type(self).__name__)
        if self.packed:
            w = packed_dense_weight(self.sign, self.alpha, self.weight_shape)
        else:
            w = self.float_weight.detach()
        wsign, alpha = weight_binarize(w, lab=get_active_family().name == "lab")
        x = x.contiguous()
        shift = shift.detach() if shift is not None else None
        if self.packed and get_packed_impl() == "popcount":
            return popcount_binary_conv(
                x, wsign, alpha, shift=shift, strides=self.strides, padding=self.padding
            )
        return binary_conv2d(
            x, wsign, alpha, shift=shift, strides=self.strides, padding=self.padding
        )

    def forward(self, x: Tensor, tk=None) -> Tensor:
        # ``tk`` (the family's schedule scalars) only changes the
        # training backward; the eval forward is the hard sign
        del tk
        return self.binary_conv(x, self.act_shift if self.has_shift else None)


class BinaryConvReact(_BinaryConvBase):
    """ReActNet-style binary conv: sign(x - act_shift) input,
    sign(W)·alpha weights (↔ reference ``HardBinaryConv_react``)."""

    has_shift = True


class BinaryConv(_BinaryConvBase):
    """Binary conv with family-routed input binarization ("step 2"
    variant ↔ reference ``HardBinaryConv``)."""


class BinaryConvCifar(_BinaryConvBase):
    """CIFAR binary conv (↔ reference ``HardBinaryConv_cifar``)."""


class FloatConv(nn.Module):
    """Full-precision conv with torch-compatible symmetric padding; the
    teacher-side twin of the binary convs (``weight``, OIHW)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        strides: Tuple[int, int] = (1, 1),
        use_bias: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.strides = tuple(strides)
        kh, kw = kernel_size
        self.weight = nn.Parameter(
            he_normal_(torch.empty(features, in_features, kh, kw), kh * kw * in_features, generator)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: Tensor, tk=None) -> Tensor:
        del tk
        y = conv2d(x, self.weight, strides=self.strides)
        if self.bias is not None:
            y = y + self.bias
        return y


__all__ = [
    "BN_EPS",
    "BatchNorm",
    "BinaryConv",
    "BinaryConvCifar",
    "BinaryConvReact",
    "FloatConv",
    "LearnableBias",
    "RPReLU",
    "conv2d",
    "he_normal_",
    "lecun_normal_",
]

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
wrapper runs its plain PyTorch version. Every family's activation
forward is the hard sign, which is what K1 and K4 fuse.

In training mode a binary conv runs K2 → :class:`BinaryConvFn` (K1
forward; K5 + K6 backward) on its latent weight. The activation
estimator whose backward K5 fuses is routed as in the reference
(``bdbnn_tpu/nn/layers.py:108-123, 195-234``): react always uses
approx; the others take ``fam.binarize_act(x, sched=tk)``'s choice —
ede when ``tk`` is a (t, k) pair (ste / ede families), prox(δ) under
the proximal family, approx under approx, else ste. The stochastic
family samples its signs in training: a non-react binary conv takes one
uniform draw of its input's shape from the ``draws`` source its forward
is given (the train step's per-step
:class:`~bdbnn_tpu_torch.nn.binarize.StepDraws`), which K1 and K6 read
to take the sampled sign, and K5 fuses the clipped-identity (ste)
backward; without a source, and always in eval mode, it takes the hard
sign (the reference's ``family_act``). BatchNorm trains with flax
semantics (batch mean, the fast biased variance, running stats
``0.9·ra + 0.1·batch``), over the global batch in a data-parallel job.

bf16 models (flax's mixed-precision recipe, as the reference runs
``--dtype bfloat16``): parameters and running statistics stay f32, and
each module computes in its input's dtype. ``LearnableBias``, ``RPReLU``
and ``FloatConv`` cast their parameters to it; ``BatchNorm`` takes f32
statistics of the bf16 input, normalizes in f32 and casts to bf16 once
(flax ``_normalize``); a binary conv casts its ``act_shift`` and hands
bf16 operands to the kernels' bf16 modes (K2 rounds the f32 latent
weight to bf16 itself). Under remat (``models/resnet.py``) a residual
block's forward runs again in the backward; :func:`frozen_running_stats`
keeps that recompute from updating the running statistics a second time.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from bdbnn_tpu_torch.nn.binarize import DrawSource, get_active_family
from bdbnn_tpu_torch.nn.kernels import binary_conv2d, weight_binarize
from bdbnn_tpu_torch.nn.kernels.binary_conv import BinaryConvFn

Tensor = torch.Tensor

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: ra = 0.9·ra + (1 − 0.9)·batch


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


_recompute = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """BatchNorm in training mode leaves its running statistics as they
    are inside this context: remat's recompute of a block's forward
    (the reference updates them once a step, in its one forward)."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce over a group whose backward all-reduces the
    cotangent: each rank's loss reads the global sums, so the cotangent of
    a rank's local sums is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last (channel) axis:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, the reference's
    order of operations. Parameters ``weight``/``bias`` (flax
    ``scale``/``bias``), buffers ``running_mean``/``running_var`` (flax
    ``batch_stats``).

    Training mode takes flax's batch statistics (``_compute_stats`` with
    ``use_fast_variance``): the batch mean and ``max(0, E[x²] − E[x]²)``,
    the biased variance, and updates the running statistics as
    ``0.9·ra + (1 − 0.9)·batch`` — torch's ``F.batch_norm`` stores the
    unbiased variance and is not a drop-in. A bf16 input is normalized in
    f32 from f32 statistics and the output cast to bf16 once.

    With a ``process_group`` (set on the student of a data-parallel job,
    :func:`~bdbnn_tpu_torch.parallel.create_sharded_state`) the statistics
    are the global batch's, as GSPMD makes flax's over a batch axis
    sharded across devices: the local f32 ``[Σx, Σx²]`` are summed over
    the ranks in one all-reduce of 2·C values (its backward all-reduces
    the matching cotangents) and divided by the global count, then taken
    through the same ``max(0, E[x²] − E[x]²)`` and running update. Every
    rank then holds the same running statistics. Without a group the code
    is the one-process path above."""

    process_group = None

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            # the statistics take their own f32 copy of a bf16 x, as flax's
            # _compute_stats does: its gradient reaches x rounded to bf16
            # and is added there to the normalize's (a no-op for f32)
            xs = x.to(torch.float32)
            dims = tuple(range(x.dim() - 1))
            if self.process_group is None:
                mean = xs.mean(dim=dims)
                ex2 = (xs * xs).mean(dim=dims)
            else:
                sums = _AllReduceSum.apply(
                    torch.stack([xs.sum(dim=dims), (xs * xs).sum(dim=dims)]), self.process_group
                )
                count = xs.numel() // xs.shape[-1] * dist.get_world_size(self.process_group)
                mean, ex2 = sums[0] / count, sums[1] / count
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            if not getattr(_recompute, "on", False):
                with torch.no_grad():
                    self.running_mean.copy_(
                        BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean
                    )
                    self.running_var.copy_(
                        BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var
                    )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.to(torch.float32) - mean) * mul + self.bias).to(x.dtype)


class LearnableBias(nn.Module):
    """Per-channel learnable shift (ReActNet's "move" op)."""

    def __init__(self, features: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        return x + self.bias.to(x.dtype)


class RPReLU(nn.Module):
    """ReActNet RPReLU: ``PReLU_slope(x - gamma) + zeta``, per channel."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(features))
        self.zeta = nn.Parameter(torch.zeros(features))
        self.slope = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: Tensor) -> Tensor:
        y = x - self.gamma.to(x.dtype)
        y = torch.where(y >= 0, y, self.slope.to(x.dtype) * y)
        return y + self.zeta.to(x.dtype)


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

    def train_estimator(self, tk=None):
        """The activation sign estimator whose backward K5 fuses, as an
        ``(name, p0, p1)`` triple, routed as the reference's
        ``family_act`` (react: always approx; stochastic: the
        clipped-identity ste backward of ``stoch_sign``)."""
        if self.has_shift:
            return ("approx", 0.0, 0.0)
        fam = get_active_family()
        if fam.name in ("ste", "ede") and tk is not None:
            t, k = tk
            return ("ede", float(t), float(k))
        if fam.name == "proximal" and tk is not None:
            (delta,) = tk
            return ("prox", float(delta), 0.0)
        if fam.name == "approx":
            return ("approx", 0.0, 0.0)
        return ("ste", 0.0, 0.0)

    def binary_conv(
        self, x: Tensor, shift: Optional[Tensor], tk=None, draws: Optional[DrawSource] = None
    ) -> Tensor:
        """±alpha binary conv of ``sign(x - shift)``: K3 (packed) → K2
        → K1, or K4 under the ``popcount`` packed impl; in training K2 →
        :class:`BinaryConvFn` (K1, with K5 + K6 backward). The weight
        sign and alpha come from the active binarizer family (alpha:
        mean|W|, or ``lab``'s ΣW²/Σ|W|, detached); the export fixed point
        mean|sign·alpha| == alpha makes the packed path family-invariant.
        A bf16 ``x`` takes the kernels' bf16 modes: K2 rounds the weight
        to bf16 before its sign and alpha (alpha bf16), the shift is cast
        to bf16, and K1 / K5 / K6 run on bf16 operands."""
        from bdbnn_tpu_torch.nn.packed import (
            get_packed_impl,
            packed_dense_weight,
            popcount_binary_conv,
        )

        fam = get_active_family()
        lab = fam.name == "lab"
        if shift is not None:
            shift = shift.to(x.dtype)
        if self.training:
            if self.packed:
                raise ValueError(
                    "a packed binary conv holds no latent weight to train; "
                    "build the model without packed=True"
                )
            estimator = self.train_estimator(tk)
            x = x.contiguous()
            # the stochastic family's draw (react never samples)
            sample = draws is not None and fam.stochastic and not self.has_shift
            u = draws(x).contiguous() if sample else None
            wsign, alpha = weight_binarize(self.float_weight.detach(), lab=lab, dtype=x.dtype)
            return BinaryConvFn.apply(
                x, shift, self.float_weight, wsign, alpha, self.strides,
                self.padding, estimator, u,
            )
        if self.packed:
            w = packed_dense_weight(self.sign, self.alpha, self.weight_shape)
        else:
            w = self.float_weight.detach()
        wsign, alpha = weight_binarize(w, lab=lab, dtype=x.dtype)
        x = x.contiguous()
        shift = shift.detach() if shift is not None else None
        if self.packed and get_packed_impl() == "popcount":
            return popcount_binary_conv(
                x, wsign, alpha, shift=shift, strides=self.strides, padding=self.padding
            )
        return binary_conv2d(
            x, wsign, alpha, shift=shift, strides=self.strides, padding=self.padding
        )

    def forward(self, x: Tensor, tk=None, draws: Optional[DrawSource] = None) -> Tensor:
        # ``tk`` (the family's schedule scalars) only changes the
        # training backward; ``draws`` only the stochastic family's
        # training forward
        return self.binary_conv(x, self.act_shift if self.has_shift else None, tk, draws)


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

    def forward(self, x: Tensor, tk=None, draws=None) -> Tensor:
        del tk, draws
        y = conv2d(x, self.weight.to(x.dtype), strides=self.strides)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


__all__ = [
    "BN_EPS",
    "BN_MOMENTUM",
    "BatchNorm",
    "BinaryConv",
    "BinaryConvCifar",
    "BinaryConvReact",
    "FloatConv",
    "LearnableBias",
    "RPReLU",
    "conv2d",
    "frozen_running_stats",
    "he_normal_",
    "lecun_normal_",
]

"""K1 — the fused sign + binary (±1) convolution, forward.

Counterpart of ``bdbnn_tpu/nn/kernels/binary_conv.py``. There the
forward of ``binary_conv2d_mxu`` is the XLA convolution on ±1 operands;
here it is the hand-written CUDA kernel ``csrc/binary_conv.cu``, which
also takes the activation sign (``sign(x - shift)``, sign(0) := +1) while
it loads the input, so the ±1 activation never exists in device memory.

- :func:`binary_conv2d` — the fused entry the layers call: f32 NHWC
  ``x``, an optional per-channel ``shift`` (react's ``act_shift``), the
  int8 ``(O, kh, kw, C)`` weight sign K2 emits, and f32 ``alpha (O,)``.
- :func:`binary_conv2d_mxu` — the unfused counterpart with the JAX
  signature (±1 ``xb`` NHWC, ±1 ``wb_sign`` HWIO), for like-with-like
  parity tests; it runs through the same kernel (the sign of a ±1 input
  is itself).
- :func:`binary_conv2d_plain` — the plain PyTorch version of the same
  function: the CPU path, and what ``chip_smoke.py`` holds the kernel
  against on the card.

Padding is symmetric ``k//2`` ("auto", torch-style) or explicit
symmetric pairs, applied AFTER the sign as in the reference (a padding
tap contributes 0, never ``sign(0 - shift)``).

The wrapper launches the kernel for a CUDA tensor (or raises) and uses
the plain version only for a tensor on the CPU. Backward kernels arrive
with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bdbnn_tpu_torch.nn.binarize import _hard_sign

Tensor = torch.Tensor


def _symmetric_pad(padding, kh: int, kw: int) -> int:
    """The one symmetric pad the kernels take: "auto" is k//2; explicit
    ((p, p), (p, p)) pairs must all be equal."""
    if padding == "auto":
        if kh != kw:
            raise ValueError(f"non-square kernel {kh}x{kw} is not supported")
        return kh // 2
    if isinstance(padding, str):
        raise ValueError(
            f"padding must be 'auto' or explicit symmetric pairs, got {padding!r}"
        )
    pads = {int(p) for pair in padding for p in pair}
    if len(pads) != 1:
        raise ValueError(f"only symmetric equal padding is supported, got {padding!r}")
    return pads.pop()


def out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def _check_strides(strides) -> int:
    sh, sw = (int(s) for s in strides)
    if sh != sw or sh < 1:
        raise ValueError(f"strides must be equal and >= 1, got {strides!r}")
    return sh


def check_conv_args(x: Tensor, wsign: Tensor, alpha: Tensor, shift: Optional[Tensor]):
    """Validate the operands of K1 / K4; returns (N, H, W, C, O, kh, kw)."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 NHWC, got {x.dtype} {tuple(x.shape)}")
    if wsign.dim() != 4 or wsign.dtype != torch.int8:
        raise ValueError(
            f"wsign must be int8 (O, kh, kw, C), got {wsign.dtype} {tuple(wsign.shape)}"
        )
    n, h, w, c = (int(d) for d in x.shape)
    o, kh, kw, cw = (int(d) for d in wsign.shape)
    if cw != c:
        raise ValueError(f"wsign has {cw} input channels, x has {c}")
    if alpha.shape != (o,) or alpha.dtype != torch.float32:
        raise ValueError(f"alpha must be float32 ({o},), got {alpha.dtype} {tuple(alpha.shape)}")
    if shift is not None and (shift.shape != (c,) or shift.dtype != torch.float32):
        raise ValueError(f"shift must be float32 ({c},), got {shift.dtype} {tuple(shift.shape)}")
    tensors = [x, wsign, alpha] + ([shift] if shift is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if x.is_cuda and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    return n, h, w, c, o, kh, kw


def im2col_nhwc(xb: Tensor, kh: int, kw: int, stride: int, pad: int) -> Tensor:
    """Zero-pad a (binarized) NHWC tensor and gather its patches as
    (N, Ho, Wo, kh*kw*C), in the HWIO flatten order (i, j, c)."""
    n, h, w, c = xb.shape
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    xp = torch.nn.functional.pad(xb, (0, 0, pad, pad, pad, pad))
    cols = [
        xp[:, i : i + stride * (ho - 1) + 1 : stride, j : j + stride * (wo - 1) + 1 : stride, :]
        for i in range(kh)
        for j in range(kw)
    ]
    return torch.cat(cols, dim=-1)


def binarize_input(x: Tensor, shift: Optional[Tensor]) -> Tensor:
    return _hard_sign(x - shift if shift is not None else x)


def binary_conv2d_plain(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
) -> Tensor:
    """Plain PyTorch K1: ``sign(x - shift)`` → zero pad → ±1 conv in
    f32 → ``· alpha``. The conv is an explicit im2col and an f32 matrix
    product rather than ``F.conv2d``: every ±1 product and every partial
    sum is an exact integer below 2^24, so any summation order gives
    the same result, while a convolution library may pick a transform
    algorithm (Winograd, FFT) that is not exact on these operands."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    patches = im2col_nhwc(binarize_input(x, shift), kh, kw, stride, pad)
    ho, wo = patches.shape[1], patches.shape[2]
    dot = patches.reshape(-1, kh * kw * c) @ wsign.reshape(o, -1).to(torch.float32).t()
    return (dot * alpha).reshape(n, ho, wo, o)


def binary_conv2d(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
) -> Tensor:
    """``conv(sign(x - shift), wsign) * alpha`` — K1 on a CUDA tensor,
    the plain version on a CPU tensor. f32 NHWC in, f32 NHWC out."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return binary_conv2d_plain(
            x, wsign, alpha, shift=shift, strides=strides, padding=padding
        )
    from bdbnn_tpu_torch.nn.kernels import _build

    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    y = torch.empty((n, ho, wo, o), dtype=torch.float32, device=x.device)
    lib = _build.library("binary_conv")
    err = lib.bdbnn_binary_conv_fwd(
        x.data_ptr(), shift.data_ptr() if shift is not None else None,
        wsign.data_ptr(), alpha.data_ptr(), y.data_ptr(),
        n, h, w, c, o, kh, kw, stride, pad, ho, wo, _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "binary_conv2d")
    binary_conv2d.launches += 1
    return y


binary_conv2d.launches = 0


def sign_int8_from_hwio(wb_sign: Tensor) -> Tensor:
    """±1 (any dtype) HWIO kernel → the int8 (O, kh, kw, C) layout K1
    reads, with sign(0) := +1."""
    one = torch.ones((), dtype=torch.int8, device=wb_sign.device)
    return torch.where(wb_sign >= 0, one, -one).permute(3, 0, 1, 2).contiguous()


def binary_conv2d_mxu(
    xb: Tensor,
    wb_sign: Tensor,
    alpha: Tensor,
    *,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
) -> Tensor:
    """±alpha binary conv with the JAX signature: ``xb`` ±1 (N,H,W,C),
    ``wb_sign`` ±1 HWIO (kh,kw,C,O), ``alpha`` per output channel. Runs
    through :func:`binary_conv2d` (sign of a ±1 input is itself)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=xb.device).reshape(-1)
    return binary_conv2d(
        xb.contiguous(), sign_int8_from_hwio(wb_sign), alpha.contiguous(),
        strides=strides, padding=padding,
    )


__all__ = [
    "binary_conv2d",
    "binary_conv2d_mxu",
    "binary_conv2d_plain",
    "im2col_nhwc",
    "sign_int8_from_hwio",
]

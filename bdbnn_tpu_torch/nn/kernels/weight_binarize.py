"""K2 — weight sign + per-output-channel alpha in one pass.

Counterpart of ``BinarizerFamily.weight_sign`` + ``weight_alpha``
(``bdbnn_tpu/nn/binarize.py``) as ``_BinaryConvBase.binary_conv`` calls
them at every forward (``bdbnn_tpu/nn/layers.py``): the kernel
``csrc/weight_binarize.cu`` reads the f32 HWIO latent weight once and
emits the int8 ±1 sign in the ``(O, kh, kw, C)`` layout K1 and K4 read,
plus ``alpha (O,)`` — mean|W| (every family but ``lab``) or ``lab``'s
ΣW²/Σ|W| (as means, + 1e-12).

The wrapper launches the kernel for a CUDA tensor (or raises) and uses
:func:`weight_binarize_plain` only for a tensor on the CPU. Both sum in
float64 and round once to float32, so alpha does not depend on the
summation order: the card and the CPU give the same alpha (barring a
double-rounding tie), and both stay within a relative 1e-6 of the
reference's float32 mean (stated tolerance). The sign is bitwise equal.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _check(w: Tensor) -> Tuple[int, int, int, int]:
    if w.dim() != 4 or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 HWIO, got {w.dtype} {tuple(w.shape)}")
    if w.is_cuda and not w.is_contiguous():
        raise ValueError("the kernel takes a contiguous weight")
    return tuple(int(d) for d in w.shape)


def weight_binarize_plain(w: Tensor, *, lab: bool = False) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch K2: ``where(w >= 0, 1, -1)`` as int8 (O, kh, kw, C)
    and the per-output-channel alpha over (kh, kw, C), averaged in
    float64 and rounded once to float32."""
    _check(w)
    one = torch.ones((), dtype=torch.int8, device=w.device)
    sign = torch.where(w >= 0, one, -one).permute(3, 0, 1, 2).contiguous()
    wd = w.to(torch.float64)
    mean_abs = wd.abs().mean(dim=(0, 1, 2)).to(torch.float32)
    if lab:
        mean_sq = (wd * wd).mean(dim=(0, 1, 2)).to(torch.float32)
        alpha = mean_sq / (mean_abs + 1e-12)
    else:
        alpha = mean_abs
    return sign, alpha


def weight_binarize(w: Tensor, *, lab: bool = False) -> Tuple[Tensor, Tensor]:
    """(sign int8 (O, kh, kw, C), alpha f32 (O,)) of an f32 HWIO weight —
    K2 on a CUDA tensor, the plain version on a CPU tensor."""
    kh, kw, c, o = _check(w)
    if not w.is_cuda:
        if w.device.type != "cpu":
            raise ValueError(f"unsupported device {w.device}")
        return weight_binarize_plain(w, lab=lab)
    from bdbnn_tpu_torch.nn.kernels import _build

    k = kh * kw * c
    sign = torch.empty((o, kh, kw, c), dtype=torch.int8, device=w.device)
    alpha = torch.empty((o,), dtype=torch.float32, device=w.device)
    lib = _build.library("weight_binarize")
    err = lib.bdbnn_weight_binarize(
        w.data_ptr(), sign.data_ptr(), alpha.data_ptr(), k, o, int(bool(lab)),
        _build.stream_ptr(w.device),
    )
    _build.check(lib, err, "weight_binarize")
    weight_binarize.launches += 1
    return sign, alpha


weight_binarize.launches = 0

__all__ = ["weight_binarize", "weight_binarize_plain"]

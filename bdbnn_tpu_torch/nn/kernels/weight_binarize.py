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

The bf16 mode (``dtype=torch.bfloat16``, a bf16 model's forward:
the reference casts the latent weight to the activation dtype before the
sign and alpha, ``bdbnn_tpu/nn/layers.py`` ``binary_conv``) rounds each
f32 weight to bf16 first — so a negative weight that rounds to -0 takes
the sign +1 — and returns alpha as a bf16 tensor: the float64 mean of
the rounded |W| rounded to f32 and then to bf16 (jnp.mean's f32 mean
cast to bf16). The reference sums in f32, so its alpha may differ from
this one by one bf16 ulp where the f32 mean lies at a rounding boundary.

The kernel splits the K = kh·kw·C rows of a weight over blocks as
:func:`weight_binarize_splits` says, sums each split's float64 partial
per channel, and adds the partials in split order: the order is a
function of the shapes alone, so alpha is also bitwise equal across runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor

# csrc/weight_binarize.cu: output channels a block, the step of a split's
# rows (its sign leaves as 16-byte stores along K), and the blocks a
# weight is spread over where K allows (two waves of the H100's 132 SMs)
K2_O_TILE = 64
K2_ROW_STEP = 16
K2_BLOCKS = 264


def weight_binarize_splits(k: int, o: int) -> Tuple[int, int]:
    """(splits, rows per split) of K2's K rows: rows a multiple of
    :data:`K2_ROW_STEP`, as few as give about :data:`K2_BLOCKS` blocks
    over the ``ceil(o / K2_O_TILE)`` channel tiles. Split ``s`` takes rows
    ``[s·rows, min(k, (s + 1)·rows))``."""
    want = math.ceil(K2_BLOCKS / math.ceil(o / K2_O_TILE))
    rows = max(K2_ROW_STEP, k // want // K2_ROW_STEP * K2_ROW_STEP)
    return math.ceil(k / rows), rows


def _check(w: Tensor, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    if w.dim() != 4 or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 HWIO, got {w.dtype} {tuple(w.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if w.is_cuda and not w.is_contiguous():
        raise ValueError("the kernel takes a contiguous weight")
    return tuple(int(d) for d in w.shape)


def weight_binarize_plain(
    w: Tensor, *, lab: bool = False, dtype: torch.dtype = torch.float32
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch K2: ``where(w >= 0, 1, -1)`` as int8 (O, kh, kw, C)
    and the per-output-channel alpha over (kh, kw, C), averaged in
    float64 and rounded once to float32. In bf16 (``dtype``) ``w`` is
    rounded to bf16 first (a subnormal read as zero) and alpha follows the
    reference's bf16 ops."""
    _check(w, dtype)
    bf16 = dtype == torch.bfloat16
    if bf16:
        w = w.to(torch.bfloat16).to(torch.float32)
        w = torch.where(w.abs() < torch.finfo(torch.float32).tiny, torch.zeros_like(w), w)
    one = torch.ones((), dtype=torch.int8, device=w.device)
    sign = torch.where(w >= 0, one, -one).permute(3, 0, 1, 2).contiguous()
    wd = w.to(torch.float64)
    mean_abs = wd.abs().mean(dim=(0, 1, 2)).to(torch.float32)
    if bf16:
        mean_abs = mean_abs.to(torch.bfloat16)
        if not lab:
            return sign, mean_abs
        sq = (w * w).to(torch.bfloat16).to(torch.float64)
        mean_sq = sq.mean(dim=(0, 1, 2)).to(torch.float32).to(torch.bfloat16)
        return sign, mean_sq / (mean_abs + 1e-12)
    if lab:
        mean_sq = (wd * wd).mean(dim=(0, 1, 2)).to(torch.float32)
        alpha = mean_sq / (mean_abs + 1e-12)
    else:
        alpha = mean_abs
    return sign, alpha


def weight_binarize(
    w: Tensor, *, lab: bool = False, dtype: torch.dtype = torch.float32
) -> Tuple[Tensor, Tensor]:
    """(sign int8 (O, kh, kw, C), alpha (O,) in ``dtype``) of an f32
    HWIO weight — K2 on a CUDA tensor, the plain version on a CPU tensor.
    ``dtype=torch.bfloat16`` is the bf16 mode."""
    kh, kw, c, o = _check(w, dtype)
    if not w.is_cuda:
        if w.device.type != "cpu":
            raise ValueError(f"unsupported device {w.device}")
        return weight_binarize_plain(w, lab=lab, dtype=dtype)
    from bdbnn_tpu_torch.nn.kernels import _build

    k = kh * kw * c
    splits, rows = weight_binarize_splits(k, o)
    sign = torch.empty((o, kh, kw, c), dtype=torch.int8, device=w.device)
    alpha = torch.empty((o,), dtype=dtype, device=w.device)
    # each split's float64 partials of Σ|W| and ΣW² per channel
    part = torch.empty((2, splits, o), dtype=torch.float64, device=w.device) if splits > 1 else None
    lib = _build.library("weight_binarize")
    err = lib.bdbnn_weight_binarize(
        w.data_ptr(), sign.data_ptr(), alpha.data_ptr(),
        part.data_ptr() if part is not None else None, k, o, rows, splits, int(bool(lab)),
        int(dtype == torch.bfloat16), _build.stream_ptr(w.device),
    )
    _build.check(lib, err, "weight_binarize")
    _build.count_launch(weight_binarize, dtype == torch.bfloat16)
    return sign, alpha


# launches of the kernel, and of its bf16 mode alone
weight_binarize.launches = 0
weight_binarize.launches_bf16 = 0

__all__ = ["weight_binarize", "weight_binarize_plain", "weight_binarize_splits"]

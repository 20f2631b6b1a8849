"""Packed-weight serving primitives: on-the-fly unpack (K3) and the
XNOR-popcount binary conv (K4).

Counterpart of ``bdbnn_tpu/nn/packed.py``. The export artifact stores
every binary conv as ``np.packbits`` sign (MSB first, HWIO flatten
order) + per-output-channel f32 alpha; in packed mode the engine keeps
that payload resident on the card and reconstructs the dense weight only
transiently inside each forward:

- :func:`unpack_sign_device` / :func:`packed_dense_weight` — K3
  (``csrc/packed.cu``): packbits → ±1 → ``* alpha``, f32 HWIO, the
  layout K2 reads. Every op is exact, so the reconstruction is bitwise
  the host loader's ``sign * alpha``.
- :func:`popcount_binary_conv` — K4 (``csrc/packed.cu``): the ±1 conv
  on the binary tensor cores as ``4·popc(x & w) − 2·popc(x) −
  2·popc(m & w) + popc(m)`` over 1-bit words (:func:`pack_sign_words`,
  :func:`pack_weight_words`), with the activation sign fused into its
  prep pass. Its integer dot equals K1's exactly, so the result is
  bitwise K1's. f32 only (bf16 is refused, as in the reference).

The impl switch (``unpack`` | ``popcount``) is the reference's
process-global pattern; the engine binds it around each forward.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses
its plain PyTorch version (``*_plain``) only for tensors on the CPU.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from bdbnn_tpu_torch.nn.kernels.binary_conv import (
    _check_strides,
    _round_up,
    _symmetric_pad,
    binarize_input,
    check_conv_args,
    im2col_nhwc,
    out_size,
)

Tensor = torch.Tensor

PACKED_IMPLS = ("unpack", "popcount")
_packed_impl = "unpack"


def set_packed_impl(impl: str) -> None:
    """Set the process-wide packed binary-conv implementation:
    ``unpack`` reconstructs the ±1 kernel (K3) and feeds K2 + K1;
    ``popcount`` feeds K2's sign to the XNOR-popcount conv (K4)."""
    global _packed_impl
    if impl not in PACKED_IMPLS:
        raise ValueError(
            f"packed impl must be one of {PACKED_IMPLS}, got {impl!r}"
        )
    _packed_impl = impl


def get_packed_impl() -> str:
    return _packed_impl


@contextmanager
def packed_impl(impl: str):
    prev = get_packed_impl()
    set_packed_impl(impl)
    try:
        yield
    finally:
        set_packed_impl(prev)


# ---------------------------------------------------------------------------
# byte accounting (pure int math)
# ---------------------------------------------------------------------------


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def dense_weight_bytes(shape) -> int:
    """f32 dense footprint of a weight tensor: ``prod(shape) * 4``."""
    return _numel(shape) * 4


def packed_weight_bytes(shape) -> int:
    """Packbits sign (1 bit/element, byte-rounded) + f32 alpha per
    output channel — the bytes the artifact stores for a binary conv."""
    return (_numel(shape) + 7) // 8 + int(shape[-1]) * 4


def packed_activation_bytes(n_elems: int) -> int:
    """1-bit activation footprint: ``n_elems`` sign bits, byte-rounded."""
    return (int(n_elems) + 7) // 8


def popcount_word_bytes(kh: int, kw: int, c: int) -> int:
    """Per-output-position uint32 working set of the popcount dot: the
    ``K = kh*kw*c`` lanes padded to a multiple of 32, packed twice
    (sign words + mask words), 4 bytes each."""
    k = int(kh) * int(kw) * int(c)
    return 2 * ((k + 31) // 32) * 4


# ---------------------------------------------------------------------------
# K3: packbits decode
# ---------------------------------------------------------------------------


def _check_packed(packed: Tensor, alpha: Tensor, shape) -> int:
    n = _numel(shape)
    o = int(shape[-1])
    if packed.dtype != torch.uint8 or packed.dim() != 1 or packed.numel() != (n + 7) // 8:
        raise ValueError(
            f"packed must be uint8 ({(n + 7) // 8},) for shape {tuple(shape)}, "
            f"got {packed.dtype} {tuple(packed.shape)}"
        )
    if alpha.dtype != torch.float32 or alpha.shape != (o,):
        raise ValueError(f"alpha must be float32 ({o},), got {alpha.dtype} {tuple(alpha.shape)}")
    if packed.device != alpha.device:
        raise ValueError("packed and alpha must be on one device")
    if packed.is_cuda and not (packed.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    return n


def unpack_sign_device(packed: Tensor, shape) -> Tensor:
    """±1 float32 of ``shape`` from a uint8 packbits payload (the plain
    shift-and-mask decode; the fused K3 path is
    :func:`packed_dense_weight`)."""
    n = _numel(shape)
    shifts = torch.arange(7, -1, -1, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[:, None] >> shifts) & 1
    bits = bits.reshape(-1)[:n].reshape(tuple(int(d) for d in shape))
    return bits.to(torch.float32) * 2.0 - 1.0


def packed_dense_weight_plain(packed: Tensor, alpha: Tensor, shape) -> Tensor:
    """Plain PyTorch K3: shift-and-mask unpack, ``* 2 - 1``, ``* alpha``."""
    _check_packed(packed, alpha, shape)
    return unpack_sign_device(packed, shape) * alpha


def packed_dense_weight(packed: Tensor, alpha: Tensor, shape) -> Tensor:
    """The transient dense ``float_weight = sign * alpha`` (f32 HWIO of
    ``shape``) — K3 on a CUDA tensor, the plain version on a CPU
    tensor."""
    n = _check_packed(packed, alpha, shape)
    if not packed.is_cuda:
        if packed.device.type != "cpu":
            raise ValueError(f"unsupported device {packed.device}")
        return packed_dense_weight_plain(packed, alpha, shape)
    from bdbnn_tpu_torch.nn.kernels import _build

    out = torch.empty(tuple(int(d) for d in shape), dtype=torch.float32, device=packed.device)
    lib = _build.library("packed")
    err = lib.bdbnn_unpack_sign(
        packed.data_ptr(), alpha.data_ptr(), out.data_ptr(), n, int(shape[-1]),
        _build.stream_ptr(packed.device),
    )
    _build.check(lib, err, "packed_dense_weight")
    packed_dense_weight.launches += 1
    return out


packed_dense_weight.launches = 0


# ---------------------------------------------------------------------------
# K4: XNOR-popcount binary conv
# ---------------------------------------------------------------------------


def _pack_words(bits: Tensor) -> Tensor:
    """Pack a bool tensor's LAST axis (length a multiple of 32) into
    32-bit words held in int64: word w, bit b <- bits[..., 32*w + b]."""
    shaped = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return (shaped << shifts).sum(dim=-1)


def _popcount32(v: Tensor) -> Tensor:
    """SWAR popcount of 32-bit words held in int64 (torch has none)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _reject_bf16(x: Tensor) -> None:
    if x.dtype == torch.bfloat16:
        raise ValueError(
            "popcount packed impl needs float32 activations: bf16 conv "
            "accumulation is inexact past 256 terms, so the popcount "
            "dot (exact integers) would diverge from the dense forward "
            "— use packed impl 'unpack' for bf16 artifacts"
        )


# K4's reduction runs over 1-bit rows of one tap's channels, padded to a
# multiple of 64 lanes: every 8-byte copy of the kernel lies in one tap
POPCOUNT_C_STAGE = 64


def pack_sign_words(x: Tensor, shift: Optional[Tensor], cp: int) -> Tuple[Tensor, Tensor]:
    """Plain version of K4's activation prep: the sign bits of ``x -
    shift`` (1 for +1, sign(0) := +1; 0 for −1 and past C) packed along C
    into 32-bit words held in int64, (N, H, W, cp/32), lane c at bit
    c % 32 of word c // 32; and each pixel's count of +1s, (N, H, W)."""
    bits = binarize_input(x, shift) > 0
    words = _pack_words(torch.nn.functional.pad(bits, (0, cp - int(x.shape[-1]))))
    return words, bits.sum(dim=-1)


def pack_weight_words(wsign: Tensor, cp: int) -> Tuple[Tensor, Tensor]:
    """Plain version of K4's weight prep: the int8 ``(O, kh, kw, C)``
    sign's +1 bits packed per tap as :func:`pack_sign_words` packs a
    pixel, (O, kh·kw, cp/32); and the table of +1 counts (kh·kw, O)."""
    o, kh, kw, c = (int(d) for d in wsign.shape)
    bits = (wsign > 0).reshape(o, kh * kw, c)
    words = _pack_words(torch.nn.functional.pad(bits, (0, cp - c)))
    return words, bits.sum(dim=-1).t()


def popcount_binary_conv_plain(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    rows_per_chunk: int = 4096,
) -> Tensor:
    """Plain PyTorch K4, the kernel's arithmetic in torch integer ops:
    the prep passes' words and counts, an im2col of the words (a padding
    tap gives zero words), SWAR popcounts of ``x & w`` and the identity
    ``dot = 4·popc(x & w) − 2·popc(x) − 2·popc(m & w) + popc(m)`` over
    the valid lanes (``popc(m) = C·valid taps``; ``popc(x)`` and
    ``popc(m & w)`` sum the per-pixel and per-(tap, o) counts over the
    valid taps), ``· alpha``. Rows are processed in chunks to bound the
    (rows, words, O) intermediate."""
    _reject_bf16(x)
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    cp = _round_up(c, POPCOUNT_C_STAGE)
    xwords, xcount = pack_sign_words(x, shift, cp)
    wwords, wcount = pack_weight_words(wsign, cp)
    words = im2col_nhwc(xwords, kh, kw, stride, pad)  # (N, Ho, Wo, taps·cp/32)
    ho, wo = words.shape[1], words.shape[2]
    words = words.reshape(n * ho * wo, -1)
    taps = kh * kw
    valid = im2col_nhwc(torch.ones_like(xcount)[..., None], kh, kw, stride, pad)
    valid = valid.reshape(-1, taps)  # (M, taps): 1 where the tap is in the image
    px = im2col_nhwc(xcount[..., None], kh, kw, stride, pad).reshape(-1, taps).sum(dim=-1)
    row_term = c * valid.sum(dim=-1) - 2 * px  # popc(m) - 2 popc(x)
    wwords = wwords.reshape(o, -1).t()  # (taps·cp/32, O)
    out = []
    for r0 in range(0, words.shape[0], rows_per_chunk):
        xw = words[r0 : r0 + rows_per_chunk, :, None]
        both = _popcount32(xw & wwords[None]).sum(dim=1)  # (rows, O)
        mask_w = (valid[r0 : r0 + rows_per_chunk, :, None] * wcount[None]).sum(dim=1)
        out.append(4 * both + row_term[r0 : r0 + rows_per_chunk, None] - 2 * mask_w)
    dot = torch.cat(out)
    return (dot.to(torch.float32) * alpha).reshape(n, ho, wo, o)


def popcount_binary_conv(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
) -> Tensor:
    """``conv(sign(x - shift), wsign) * alpha`` as a popcount dot on
    1-bit words — K4 on a CUDA tensor, the plain version on a CPU tensor. Operands
    and layouts as :func:`bdbnn_tpu_torch.nn.kernels.binary_conv2d`.

    K4's scratch is allocated here, as one int32 tensor: the activation
    words (N, H, W, CP/32), the weight words (O, kh·kw, CP/32), the
    activation's +1 counts (N, H, W) and the weight's (kh·kw, O), CP being
    C rounded up to :data:`POPCOUNT_C_STAGE`."""
    _reject_bf16(x)
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return popcount_binary_conv_plain(
            x, wsign, alpha, shift=shift, strides=strides, padding=padding
        )
    from bdbnn_tpu_torch.nn.kernels import _build

    if kh > 16 or kw > 16:  # K4's per-block prefix table of the taps
        raise ValueError(f"K4 takes kernels up to 16x16, got {kh}x{kw}")
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    cw = _round_up(c, POPCOUNT_C_STAGE) // 32  # even: 8-byte rows
    pixels, taps = n * h * w, kh * kw
    # int32 offsets of the four parts; the word parts come first and are
    # 8-byte aligned
    sizes = (pixels * cw, o * taps * cw, pixels, taps * o)
    scratch = torch.empty((sum(sizes),), dtype=torch.int32, device=x.device)
    base = scratch.data_ptr()
    parts = [base + 4 * sum(sizes[:i]) for i in range(4)]
    y = torch.empty((n, ho, wo, o), dtype=torch.float32, device=x.device)
    lib = _build.library("packed")
    err = lib.bdbnn_popcount_conv_fwd(
        x.data_ptr(), shift.data_ptr() if shift is not None else None,
        wsign.data_ptr(), alpha.data_ptr(), parts[0], parts[2], parts[1], parts[3],
        y.data_ptr(), n, h, w, c, o, kh, kw, stride, pad, ho, wo, cw * 4,
        _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "popcount_binary_conv")
    popcount_binary_conv.launches += 1
    return y


popcount_binary_conv.launches = 0


__all__ = [
    "PACKED_IMPLS",
    "POPCOUNT_C_STAGE",
    "dense_weight_bytes",
    "get_packed_impl",
    "packed_activation_bytes",
    "packed_dense_weight",
    "packed_dense_weight_plain",
    "packed_impl",
    "packed_weight_bytes",
    "pack_sign_words",
    "pack_weight_words",
    "popcount_binary_conv",
    "popcount_binary_conv_plain",
    "popcount_word_bytes",
    "set_packed_impl",
    "unpack_sign_device",
]

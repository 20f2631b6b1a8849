"""K1, K5, K6 — the fused sign + binary (±1) convolution and its backward.

Counterpart of ``bdbnn_tpu/nn/kernels/binary_conv.py``. There the
forward of ``binary_conv2d_mxu`` is the XLA convolution on ±1 operands
and its backward the exact float conv VJP; here all three are
hand-written CUDA kernels:

- K1 :func:`binary_conv2d` (``csrc/binary_conv.cu``) — the fused forward
  the layers call: f32 NHWC ``x``, an optional per-channel ``shift``
  (react's ``act_shift``), the int8 ``(O, kh, kw, C)`` weight sign K2
  emits, and f32 ``alpha (O,)``, on the int8 tensor cores: a prep pass
  writes the activation sign (``sign(x - shift)``, sign(0) := +1) once
  as int8 ±1 (:func:`act_sign_int8`, channels padded to a multiple of
  :data:`FWD_C_STAGE`), then an implicit GEMM gathers its taps.
  Under the stochastic family the prep pass takes the uniform draw
  ``u`` (f32, shaped like ``x``) and writes the sampled sign
  ``u < clip((x + 1)/2, 0, 1) ? +1 : -1`` (the reference's
  ``stoch_sign``) in place of the hard sign; ``u`` never comes with a
  ``shift``, as the reference never combines them.
- K5 :func:`binary_conv2d_dgrad` (``csrc/binary_conv_dgrad.cu``) — the
  input gradient ``conv_transpose(g·alpha, sign W)`` times the active
  sign estimator's slope at ``x - shift`` (:data:`ESTIMATORS`), on the
  bf16 tensor cores: ``g·alpha`` split exactly into three bf16 pieces
  (:func:`split_bf16x3`) and the dx rows taken by stride-parity class
  (:func:`dgrad_parity_classes`), so only the taps on the stride grid
  are multiplied.
- K6 :func:`binary_conv2d_wgrad` (``csrc/binary_conv_wgrad.cu``) — the
  weight gradient ``conv(sign(x - shift)ᵀ, g·alpha)`` times the latent
  weight's STE mask ``1{|W| <= 1}``, in HWIO, on the bf16 tensor cores:
  the same exact split of ``g·alpha``, the activation sign written once
  as bf16 ±1 (:func:`wgrad_sign_bf16`; the sampled sign when given
  ``u``, so dW is taken against the signs the forward used), the long
  reduction over positions split in a fixed count (:func:`wgrad_splits`).
- :class:`BinaryConvFn` — the autograd function the layers train
  through: K1 forward, K5 + K6 backward, ``-Σ dx`` for the shift, no
  gradient for alpha (the reference's ``stop_gradient``), and the draw
  ``u`` of a stochastic layer passed to K1 and K6.
- :func:`binary_conv2d_mxu` — the unfused forward with the JAX
  signature (±1 ``xb`` NHWC, ±1 ``wb_sign`` HWIO), for like-with-like
  parity tests; it runs through K1 (the sign of a ±1 input is itself).
- ``*_plain`` — the plain PyTorch version of each kernel: the CPU path,
  and what ``chip_smoke.py`` holds each kernel against on the card.
  Each is an explicit im2col / col2im and an f32 matrix product.

bf16 mode. A bf16 model's binary conv hands the kernels bf16 ``x``,
``shift``, ``u``, ``alpha`` and ``g``, and each kernel computes what the
reference's bf16 ops compute (``bdbnn_tpu/nn/kernels/binary_conv.py``
``_forward`` and its ``jax.vjp``), never an f32 kernel on upcast copies:

- K1 writes bf16 ``y = bf16(bf16(dot)·alpha)`` — the reference's bf16
  conv rounds the exact dot, its bf16 multiply rounds again;
- K5 takes ``ga = bf16(g·alpha)`` as its one bf16 piece (the reference's
  cotangent is that bf16 product), rounds the sum to bf16, and applies
  the estimator's slope at ``bf16(x - shift)`` in the reference's bf16
  ops (EDE's ``t, k`` and prox's ``δ`` rounded to bf16); dx is bf16;
- K6 takes the same one piece, and returns ``f32(bf16(Σ)·1{|bf16(W)| <=
  1})``: the reference's weight cotangent is bf16, its STE mask reads the
  bf16-rounded weight, and the cast to the f32 latent passes it on.

Padding is symmetric ``k//2`` ("auto", torch-style) or explicit
symmetric pairs, applied AFTER the sign as in the reference (a padding
tap contributes 0 to y and to dW and receives nothing in dx, never
``sign(0 - shift)``).

Each wrapper launches its kernel for a CUDA tensor (or raises) and uses
the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from bdbnn_tpu_torch.nn.binarize import _hard_sign, stoch_sign

Tensor = torch.Tensor

# the sign estimator backwards K5 fuses, by name -> kernel code. An
# estimator is a triple (name, p0, p1): ("ede", t, k), ("prox", delta,
# 0.0), the others take no parameter; "none" is slope 1 (the bare
# conv-transpose sum, which the tests' error bounds read).
ESTIMATORS = {"none": -1, "approx": 0, "ste": 1, "ede": 2, "prox": 3}
Estimator = Tuple[str, float, float]


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


ACT_DTYPES = (torch.float32, torch.bfloat16)


def check_conv_args(x: Tensor, wsign: Tensor, alpha: Tensor, shift: Optional[Tensor]):
    """Validate the operands of K1 / K4; returns (N, H, W, C, O, kh, kw).
    ``x`` is float32 or bfloat16, and ``alpha`` and ``shift`` take its
    dtype."""
    if x.dim() != 4 or x.dtype not in ACT_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 NHWC, got {x.dtype} {tuple(x.shape)}")
    if wsign.dim() != 4 or wsign.dtype != torch.int8:
        raise ValueError(
            f"wsign must be int8 (O, kh, kw, C), got {wsign.dtype} {tuple(wsign.shape)}"
        )
    n, h, w, c = (int(d) for d in x.shape)
    o, kh, kw, cw = (int(d) for d in wsign.shape)
    if cw != c:
        raise ValueError(f"wsign has {cw} input channels, x has {c}")
    if alpha.shape != (o,) or alpha.dtype != x.dtype:
        raise ValueError(f"alpha must be {x.dtype} ({o},), got {alpha.dtype} {tuple(alpha.shape)}")
    if shift is not None and (shift.shape != (c,) or shift.dtype != x.dtype):
        raise ValueError(f"shift must be {x.dtype} ({c},), got {shift.dtype} {tuple(shift.shape)}")
    tensors = [x, wsign, alpha] + ([shift] if shift is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if x.is_cuda and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    return n, h, w, c, o, kh, kw


def check_draw(u: Optional[Tensor], x: Tensor, shift: Optional[Tensor]) -> None:
    """Validate the stochastic family's uniform draw ``u`` for ``x``."""
    if u is None:
        return
    if shift is not None:
        raise ValueError("a draw u never comes with a shift: the reference never combines them")
    if u.dtype != x.dtype or u.shape != x.shape or u.device != x.device:
        raise ValueError(
            f"u must be {x.dtype} {tuple(x.shape)} on {x.device}, got {u.dtype} "
            f"{tuple(u.shape)} on {u.device}"
        )
    if x.is_cuda and not u.is_contiguous():
        raise ValueError("the kernel takes contiguous tensors")


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


def binarize_input(x: Tensor, shift: Optional[Tensor], u: Optional[Tensor] = None) -> Tensor:
    """The activation sign the kernels take: ``sign(x - shift)`` (sign(0)
    := +1), or with a draw ``u`` the sampled ``u < hard_sigmoid(x) ? +1 :
    -1`` (the reference's ``stoch_sign`` forward)."""
    if u is not None:
        check_draw(u, x, shift)
        return stoch_sign(x, u)
    return _hard_sign(x - shift if shift is not None else x)


def binary_conv2d_plain(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    u: Optional[Tensor] = None,
) -> Tensor:
    """Plain PyTorch K1: ``sign(x - shift)`` (or the sampled sign of the
    draw ``u``) → zero pad → ±1 conv in f32 → ``· alpha`` (in bf16: the
    dot rounded to bf16, then the bf16 multiply). The conv is
    an explicit im2col and an f32 matrix product rather than
    ``F.conv2d``: every ±1 product and every partial
    sum is an exact integer below 2^24, so any summation order gives
    the same result, while a convolution library may pick a transform
    algorithm (Winograd, FFT) that is not exact on these operands."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    patches = im2col_nhwc(binarize_input(x, shift, u).to(torch.float32), kh, kw, stride, pad)
    ho, wo = patches.shape[1], patches.shape[2]
    dot = patches.reshape(-1, kh * kw * c) @ wsign.reshape(o, -1).to(torch.float32).t()
    return (dot.to(x.dtype) * alpha).reshape(n, ho, wo, o)


# K1's reduction runs over int8 rows of one tap's channels, padded to a
# multiple of the 32-deep int8 MMA
FWD_C_STAGE = 32


def act_sign_int8(
    x: Tensor, shift: Optional[Tensor], cp: int, u: Optional[Tensor] = None
) -> Tensor:
    """Plain version of K1's prep pass: ``sign(x - shift)`` (sign(0) :=
    +1), or the sampled sign of the draw ``u``, as int8 ±1, NHWC with the
    channels padded with zeros to ``cp``."""
    s = binarize_input(x, shift, u).to(torch.int8)
    return torch.nn.functional.pad(s, (0, cp - int(x.shape[-1])))


def binary_conv2d(
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    u: Optional[Tensor] = None,
) -> Tensor:
    """``conv(sign(x - shift), wsign) * alpha`` — K1 on a CUDA tensor,
    the plain version on a CPU tensor. f32 NHWC in, f32 NHWC out; bf16
    in, bf16 out (the bf16 mode). With the draw ``u`` the sign is the
    sampled one (no ``shift`` then).

    K1's scratch is allocated here: the int8 sign (N, H, W, CP) and, only
    where the weight sign cannot be read as it is (C not a multiple of
    :data:`FWD_C_STAGE`, or a pointer off 16 bytes), its copy padded to
    (O, kh, kw, CP)."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    check_draw(u, x, shift)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return binary_conv2d_plain(
            x, wsign, alpha, shift=shift, strides=strides, padding=padding, u=u
        )
    from bdbnn_tpu_torch.nn.kernels import _build

    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    cp = _round_up(c, FWD_C_STAGE)
    sx = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    wpad = None
    if cp != c or wsign.data_ptr() % 16:
        wpad = torch.empty((o, kh, kw, cp), dtype=torch.int8, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((n, ho, wo, o), dtype=x.dtype, device=x.device)
    lib = _build.library("binary_conv")
    err = lib.bdbnn_binary_conv_fwd(
        x.data_ptr(), shift.data_ptr() if shift is not None else None,
        u.data_ptr() if u is not None else None, wsign.data_ptr(), alpha.data_ptr(), sx.data_ptr(),
        wpad.data_ptr() if wpad is not None else None, y.data_ptr(),
        n, h, w, c, o, kh, kw, stride, pad, ho, wo, cp, int(bf16), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "binary_conv2d")
    binary_conv2d.launches += 1
    binary_conv2d.launches_bf16 += bf16
    return y


# launches of the kernel, and of its bf16 mode alone
binary_conv2d.launches = 0
binary_conv2d.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Backward: K5 (input gradient) and K6 (weight gradient)
# ---------------------------------------------------------------------------


def _check_estimator(estimator: Estimator) -> Estimator:
    name, p0, p1 = estimator
    if name not in ESTIMATORS:
        raise ValueError(f"unknown sign estimator {name!r}; have {sorted(ESTIMATORS)}")
    if name == "prox" and not float(p0) > 0:
        raise ValueError(f"prox needs delta > 0, got {p0!r}")
    return name, float(p0), float(p1)


def estimator_slope(v: Tensor, estimator: Estimator) -> Optional[Tensor]:
    """The sign estimator's backward slope at pre-sign values ``v``, with
    the reference's order of f32 operations (``bdbnn_tpu/nn/binarize.py``
    backward rules); None for "none"."""
    name, p0, p1 = _check_estimator(estimator)
    if name == "approx":
        return torch.clamp(2.0 - 2.0 * v.abs(), min=0.0)
    if name == "ste":
        return (v.abs() <= 1.0).to(v.dtype)
    if name == "ede":
        t = torch.as_tensor(p0, dtype=v.dtype, device=v.device)
        k = torch.as_tensor(p1, dtype=v.dtype, device=v.device)
        sech = 1.0 / torch.cosh(t * v)
        return k * t * sech * sech
    if name == "prox":
        d = torch.as_tensor(p0, dtype=v.dtype, device=v.device)
        return (2.0 / d) * torch.clamp(1.0 - v.abs() / d, min=0.0)
    return None


def _check_grad(g: Tensor, n: int, ho: int, wo: int, o: int, x: Tensor) -> None:
    if g.dtype != x.dtype or tuple(g.shape) != (n, ho, wo, o):
        raise ValueError(
            f"g must be {x.dtype} {(n, ho, wo, o)}, got {g.dtype} {tuple(g.shape)}"
        )
    if g.device != x.device:
        raise ValueError("all operands must be on one device")
    if g.is_cuda and not g.is_contiguous():
        raise ValueError("the kernel takes contiguous tensors")


def binary_conv2d_dgrad_plain(
    g: Tensor,
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    estimator: Estimator = ("none", 0.0, 0.0),
) -> Tensor:
    """Plain PyTorch K5: ``ga = g·alpha``; the (M, kh·kw·C) columns
    ``ga @ sign W`` as one f32 matrix product; col2im adds them into the
    zero-padded input tap by tap (a padding position is cropped away, so
    it receives nothing); then the estimator's slope at ``x - shift``.
    In bf16 ``ga`` is the bf16 product, the sum is rounded to bf16 and
    the slope is taken in bf16 ops (:func:`estimator_slope` on bf16
    tensors rounds each op, as the reference's bf16 backward does)."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    _check_grad(g, n, ho, wo, o, x)
    ga = (g * alpha).to(torch.float32)
    cols = ga.reshape(-1, o) @ wsign.reshape(o, -1).to(torch.float32)
    cols = cols.reshape(n, ho, wo, kh, kw, c)
    xp = torch.zeros((n, h + 2 * pad, w + 2 * pad, c), dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            xp[:, i : i + stride * (ho - 1) + 1 : stride, j : j + stride * (wo - 1) + 1 : stride, :] += (
                cols[:, :, :, i, j, :]
            )
    dxb = xp[:, pad : pad + h, pad : pad + w, :].to(x.dtype)
    slope = estimator_slope(x - shift if shift is not None else x, estimator)
    return (dxb * slope) if slope is not None else dxb.contiguous()


def split_bf16x3(ga: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K5's split pass: f32 ``ga`` as three bf16 pieces
    with ``hi + mid + lo == ga`` exactly (``hi = bf16(ga)``, ``mid =
    bf16(ga - hi)``, ``lo = ga - hi - mid``; each subtraction is exact in
    f32 and ``lo`` fits bf16's 8 significand bits). Exact for |ga| from
    about 2^-100 up; far below that ``lo`` would need bf16 subnormals
    finer than 2^-133."""
    hi = ga.to(torch.bfloat16)
    r = ga - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(torch.float32)).to(torch.bfloat16)


def dgrad_parity_classes(k: int, s: int, p: int) -> List[List[Tuple[int, int]]]:
    """K5's stride-parity classes along one axis. For each residue ``a =
    h mod s`` of a dx coordinate, the taps ``(i, d)`` that reach g from
    it: ``h + p - i = ho·s`` holds iff ``i ≡ a + p (mod s)``, and then
    ``ho = h // s + d`` with ``d = (a + p - i) / s``. Every tap lands in
    exactly one class; at 3×3, s2, p1 the classes hold 1 and 2 taps."""
    return [[(i, (a + p - i) // s) for i in range(k) if (a + p - i) % s == 0] for a in range(s)]


def dgrad_tap_table(kh: int, kw: int, s: int, p: int) -> List[int]:
    """The int32 table K5 reads: ``s² + 1`` offsets into the tap list of
    class ``z = a·s + b`` (rows with h ≡ a, w ≡ b mod s), then each tap
    of the classes in order as ``(i·kw + j, di, dj)``."""
    rows, cols = dgrad_parity_classes(kh, s, p), dgrad_parity_classes(kw, s, p)
    offsets, taps = [0], []
    for a in range(s):
        for b in range(s):
            taps += [(i * kw + j, di, dj) for i, di in rows[a] for j, dj in cols[b]]
            offsets.append(len(taps))
    return offsets + [v for t in taps for v in t]


# K5's reduction is staged 32 o values deep: the split pass pads O to it
# (K6 reads the split in the same layout)
DGRAD_O_STAGE = 32
_tap_tables: Dict[Tuple, Tensor] = {}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def binary_conv2d_dgrad(
    g: Tensor,
    x: Tensor,
    wsign: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    estimator: Estimator = ("none", 0.0, 0.0),
) -> Tensor:
    """``slope(x - shift) · conv_transpose(g·alpha, sign W)`` — K5 on a
    CUDA tensor, the plain version on a CPU tensor. NHWC in ``x``'s
    dtype (bf16 ``x``, ``g``, ``shift``, ``alpha``: the bf16 mode).

    K5 allocates its scratch here: ``g·alpha`` split into three bf16
    pieces (N, Ho, Wo, 3, OP) — one piece in the bf16 mode — and the ±1
    sign as bf16 (kh·kw, OP, CP),
    OP and CP being O and C padded to the kernel's stage and 16-byte
    rows; the parity-class table lives on the card, one per conv
    geometry and device."""
    n, h, w, c, o, kh, kw = check_conv_args(x, wsign, alpha, shift)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return binary_conv2d_dgrad_plain(
            g, x, wsign, alpha, shift=shift, strides=strides, padding=padding,
            estimator=estimator,
        )
    from bdbnn_tpu_torch.nn.kernels import _build

    name, p0, p1 = _check_estimator(estimator)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    _check_grad(g, n, ho, wo, o, x)
    key = (kh, kw, stride, pad, x.device)
    taps = _tap_tables.get(key)
    if taps is None:
        taps = _tap_tables[key] = torch.tensor(
            dgrad_tap_table(kh, kw, stride, pad), dtype=torch.int32, device=x.device
        )
    bf16 = x.dtype == torch.bfloat16
    op, cp = _round_up(o, DGRAD_O_STAGE), _round_up(c, 8)
    gs = torch.empty((n, ho, wo, ga_pieces(x.dtype), op), dtype=torch.bfloat16, device=x.device)
    wb = torch.empty((kh * kw, op, cp), dtype=torch.bfloat16, device=x.device)
    dx = torch.empty_like(x)
    lib = _build.library("binary_conv_dgrad")
    err = lib.bdbnn_binary_conv_dgrad(
        g.data_ptr(), x.data_ptr(), shift.data_ptr() if shift is not None else None,
        wsign.data_ptr(), alpha.data_ptr(), taps.data_ptr(), gs.data_ptr(), wb.data_ptr(),
        dx.data_ptr(), n, h, w, c, o, kh, kw, stride, ho, wo, op, cp, ESTIMATORS[name], p0, p1,
        int(bf16), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "binary_conv2d_dgrad")
    binary_conv2d_dgrad.launches += 1
    binary_conv2d_dgrad.launches_bf16 += bf16
    return dx


# launches of the kernel, and of its bf16 mode alone
binary_conv2d_dgrad.launches = 0
binary_conv2d_dgrad.launches_bf16 = 0


def ga_pieces(dtype: torch.dtype) -> int:
    """The bf16 pieces of ``g·alpha`` K5 and K6 multiply: three exact
    pieces of the f32 product, or the bf16 mode's one bf16 product."""
    return 1 if dtype == torch.bfloat16 else 3


def _check_latent(w: Tensor, x: Tensor, alpha: Tensor) -> Tuple[int, int, int, int]:
    if w.dim() != 4 or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 HWIO, got {w.dtype} {tuple(w.shape)}")
    kh, kw, c, o = (int(d) for d in w.shape)
    if x.dim() != 4 or x.dtype not in ACT_DTYPES or int(x.shape[3]) != c:
        raise ValueError(
            f"x must be float32 or bfloat16 NHWC with {c} channels, got {x.dtype} {tuple(x.shape)}"
        )
    if alpha.shape != (o,) or alpha.dtype != x.dtype:
        raise ValueError(f"alpha must be {x.dtype} ({o},), got {alpha.dtype} {tuple(alpha.shape)}")
    if w.device != x.device or alpha.device != x.device:
        raise ValueError("all operands must be on one device")
    if x.is_cuda and not all(t.is_contiguous() for t in (w, x, alpha)):
        raise ValueError("the kernel takes contiguous tensors")
    return kh, kw, c, o


def binary_conv2d_wgrad_plain(
    g: Tensor,
    x: Tensor,
    w: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    u: Optional[Tensor] = None,
) -> Tensor:
    """Plain PyTorch K6: im2col of ``sign(x - shift)`` (or the sampled
    sign of the draw ``u``; zero padding after the sign), ``patchesᵀ @
    (g·alpha)`` as one f32 matrix product, then the STE mask ``1{|W| <=
    1}``; f32 HWIO like ``w``. In bf16 ``g·alpha`` is the bf16 product,
    the sum is rounded to bf16 and the mask reads ``bf16(W)``."""
    kh, kw, c, o = _check_latent(w, x, alpha)
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    patches = im2col_nhwc(binarize_input(x, shift, u).to(torch.float32), kh, kw, stride, pad)
    n, ho, wo = (int(d) for d in patches.shape[:3])
    _check_grad(g, n, ho, wo, o, x)
    ga = (g * alpha).to(torch.float32)
    dws = (patches.reshape(-1, kh * kw * c).t() @ ga.reshape(-1, o)).reshape(kh, kw, c, o)
    if x.dtype == torch.bfloat16:
        wb = w.to(torch.bfloat16)
        return (dws.to(torch.bfloat16) * (wb.abs() <= 1.0).to(torch.bfloat16)).to(torch.float32)
    return dws * (w.abs() <= 1.0).to(torch.float32)


def wgrad_sign_bf16(
    x: Tensor, shift: Optional[Tensor], cp: int, u: Optional[Tensor] = None
) -> Tensor:
    """Plain version of K6's sign pass: ``sign(x - shift)`` (sign(0) :=
    +1), or the sampled sign of the draw ``u``, as bf16 ±1, NHWC with the
    channels padded with zeros to ``cp``."""
    s = binarize_input(x, shift, u).to(torch.bfloat16)
    return torch.nn.functional.pad(s, (0, cp - int(x.shape[-1])))


# K6's GEMM tile: 128 dW rows ((tap, c) pairs over the padded channels)
# x 64 output channels, reduced over positions in 32-deep stages
WGRAD_ROW_TILE = 128
WGRAD_O_TILE = 64
WGRAD_M_STAGE = 32
# blocks K6's GEMM aims for: many waves of the H100's 132 SMs, so the
# last wave's tail is short, while the partial sums stay a few tens of MB
WGRAD_BLOCKS = 2048


def wgrad_splits(m: int, kd: int, o: int) -> Tuple[int, int]:
    """(splits, rows per split) of K6's reduction over M positions: about
    :data:`WGRAD_BLOCKS` blocks over the (kd, o) output tiles (``kd`` =
    kh·kw·CP, the GEMM's rows), no split under 512 rows, rows a multiple
    of the 32-deep stage. A function of the shapes alone, so a run's sum
    order is fixed."""
    tiles = math.ceil(kd / WGRAD_ROW_TILE) * math.ceil(o / WGRAD_O_TILE)
    splits = max(1, min(math.ceil(WGRAD_BLOCKS / tiles), math.ceil(m / 512)))
    rows = math.ceil(math.ceil(m / splits) / WGRAD_M_STAGE) * WGRAD_M_STAGE
    return math.ceil(m / rows), rows


def binary_conv2d_wgrad(
    g: Tensor,
    x: Tensor,
    w: Tensor,
    alpha: Tensor,
    *,
    shift: Optional[Tensor] = None,
    strides: Tuple[int, int] = (1, 1),
    padding="auto",
    u: Optional[Tensor] = None,
) -> Tensor:
    """``1{|W| <= 1} · conv(sign(x - shift)ᵀ, g·alpha)`` in HWIO — K6 on
    a CUDA tensor, the plain version on a CPU tensor. With the draw ``u``
    the sign is the sampled one (no ``shift`` then). bf16 ``x``, ``g``,
    ``shift``, ``u`` and ``alpha`` take the bf16 mode; ``w`` and dW are
    f32 in both.

    K6 allocates its scratch here: ``g·alpha`` split into three bf16
    pieces (N, Ho, Wo, 3, OP) as K5 lays it out (one piece in the bf16
    mode), the activation sign as
    bf16 (N, H, W, CP), and the f32 partial sums of the split reduction
    (splits, kh·kw·C, O)."""
    kh, kw, c, o = _check_latent(w, x, alpha)
    check_draw(u, x, shift)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return binary_conv2d_wgrad_plain(
            g, x, w, alpha, shift=shift, strides=strides, padding=padding, u=u
        )
    from bdbnn_tpu_torch.nn.kernels import _build

    if shift is not None and (shift.shape != (c,) or shift.dtype != x.dtype
                              or shift.device != x.device or not shift.is_contiguous()):
        raise ValueError(f"shift must be a contiguous {x.dtype} ({c},) on {x.device}")
    stride = _check_strides(strides)
    pad = _symmetric_pad(padding, kh, kw)
    n, h, wd = (int(d) for d in x.shape[:3])
    ho, wo = out_size(h, kh, stride, pad), out_size(wd, kw, stride, pad)
    _check_grad(g, n, ho, wo, o, x)
    if n * ho * wo >= 2**30:  # the GEMM's position ranges stay in int32
        raise ValueError(f"K6 takes under 2^30 output positions, got {n}x{ho}x{wo}")
    bf16 = x.dtype == torch.bfloat16
    op, cp = _round_up(o, DGRAD_O_STAGE), _round_up(c, 8)
    splits, rows = wgrad_splits(n * ho * wo, kh * kw * cp, o)
    gs = torch.empty((n, ho, wo, ga_pieces(x.dtype), op), dtype=torch.bfloat16, device=x.device)
    sx = torch.empty((n, h, wd, cp), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((splits, kh * kw * c, o), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    lib = _build.library("binary_conv_wgrad")
    err = lib.bdbnn_binary_conv_wgrad(
        g.data_ptr(), x.data_ptr(), shift.data_ptr() if shift is not None else None,
        u.data_ptr() if u is not None else None, w.data_ptr(), alpha.data_ptr(), gs.data_ptr(), sx.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, h, wd, c, o, kh, kw, stride, pad, ho, wo, op, cp, splits, rows,
        int(bf16), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "binary_conv2d_wgrad")
    binary_conv2d_wgrad.launches += 1
    binary_conv2d_wgrad.launches_bf16 += bf16
    return dw


# launches of the kernel, and of its bf16 mode alone
binary_conv2d_wgrad.launches = 0
binary_conv2d_wgrad.launches_bf16 = 0


class BinaryConvFn(torch.autograd.Function):
    """The binary conv the layers train through: K1 forward; K5 (dx,
    with the estimator's slope) and K6 (dW, with the STE mask) backward.
    ``shift`` (react's ``act_shift``, or None) gets ``-Σ_{n,h,w} dx``
    (in a bf16 model the shift, x, alpha and draw are bf16 and each kernel
    takes its bf16 mode; the sum of the bf16 dx is taken in f32 and
    rounded to bf16 — the reference's XLA:CPU adds a bf16 reduction in
    bf16 one term at a time, so its shift gradient is coarser);
    ``wsign``/``alpha`` come from K2 on the detached latent weight and
    get no gradient (the reference's ``stop_gradient`` on alpha).

    A stochastic layer passes its draw ``u`` (or None): K1 and K6 both
    take the sampled sign from it, K5 the estimator's slope at ``x``.

    Saved for the backward: the pre-sign f32 input (which the layer
    before keeps anyway), the shift, the latent weight, the int8 sign,
    alpha and the draw — never a ±1 activation."""

    @staticmethod
    def forward(ctx, x, shift, w, wsign, alpha, strides, padding, estimator, u=None):
        y = binary_conv2d(x, wsign, alpha, shift=shift, strides=strides, padding=padding, u=u)
        ctx.save_for_backward(x, shift, w, wsign, alpha, u)
        ctx.conv = (tuple(strides), padding, _check_estimator(estimator))
        return y

    @staticmethod
    def backward(ctx, g):
        x, shift, w, wsign, alpha, u = ctx.saved_tensors
        strides, padding, estimator = ctx.conv
        g = g.contiguous()
        dx = dshift = dw = None
        need_shift = shift is not None and ctx.needs_input_grad[1]
        if ctx.needs_input_grad[0] or need_shift:
            dx = binary_conv2d_dgrad(
                g, x, wsign, alpha, shift=shift, strides=strides, padding=padding,
                estimator=estimator,
            )
            if need_shift:
                dshift = -dx.sum(dim=(0, 1, 2))
        if ctx.needs_input_grad[2]:
            dw = binary_conv2d_wgrad(
                g, x, w, alpha, shift=shift, strides=strides, padding=padding, u=u
            )
        return dx, dshift, dw, None, None, None, None, None, None


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
    ``wb_sign`` ±1 HWIO (kh,kw,C,O), ``alpha`` per output channel (taken
    in ``xb``'s dtype, f32 or bf16). Runs through :func:`binary_conv2d`
    (sign of a ±1 input is itself)."""
    alpha = torch.as_tensor(alpha, device=xb.device).to(xb.dtype).reshape(-1)
    return binary_conv2d(
        xb.contiguous(), sign_int8_from_hwio(wb_sign), alpha.contiguous(),
        strides=strides, padding=padding,
    )


__all__ = [
    "ESTIMATORS",
    "FWD_C_STAGE",
    "BinaryConvFn",
    "act_sign_int8",
    "binary_conv2d",
    "binary_conv2d_dgrad",
    "binary_conv2d_dgrad_plain",
    "binary_conv2d_mxu",
    "binary_conv2d_plain",
    "binary_conv2d_wgrad",
    "binary_conv2d_wgrad_plain",
    "check_draw",
    "dgrad_parity_classes",
    "ga_pieces",
    "dgrad_tap_table",
    "estimator_slope",
    "im2col_nhwc",
    "sign_int8_from_hwio",
    "split_bf16x3",
    "wgrad_sign_bf16",
    "wgrad_splits",
]

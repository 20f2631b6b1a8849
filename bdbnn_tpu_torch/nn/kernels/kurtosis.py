"""K7 — the grouped kurtosis regularizer, forward and gradient.

Counterpart of ``bdbnn_tpu/losses/kurtosis.py:51-113`` (``kurtosis``,
``kurtosis_regularization``) and of ``jax.grad`` through it. One call
takes every hooked latent weight at once:

    kurt_t = (S4/n) / (S2/(n-1))²   over d = w - mean(w)  (centered, Bessel)
    loss   = avg | sum | max over t of (kurt_t - target_t)²

and, with ``with_grad``, ``d loss / d w`` for every tensor in closed form
(``csrc/kurtosis.cu`` states it). On a CUDA tensor it is the hand-written
kernel ``csrc/kurtosis.cu`` — one grid over all tensors per pass (mean,
centered moments, then the gradient with the finalize folded in, or a
one-block finalize without the gradient), its tensor table a kernel
parameter packed once per set of tensors; on a CPU tensor
:func:`kurtosis_grouped_plain`. Both sum in float64 and round once to
float32 (the mean to f32 first, so ``d = w - mean`` is the same f32 value
in both), so they agree to an ulp or two; the reference's f32 autodiff
agrees with both to the rounding of its f32 sums.

The wrapper counts one launch a call (``kurtosis_grouped.launches``),
which is three grid launches on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

MODES = {"avg": 0, "sum": 1, "max": 2}
CHUNK = 8192  # elements a block of csrc/kurtosis.cu
MAX_TENSORS = 128  # csrc/kurtosis.cu MAX_T: the table fits 4 KB of kernel parameters


def _check(weights: Sequence[Tensor], targets: Sequence[float], mode: str) -> None:
    if not weights:
        raise ValueError("kurtosis_grouped needs at least one tensor")
    if len(weights) != len(targets):
        raise ValueError(f"{len(weights)} weight tensors but {len(targets)} targets")
    if mode not in MODES:
        raise ValueError(f"unknown kurtosis mode: {mode!r}")
    dev = weights[0].device
    for w in weights:
        if w.dtype != torch.float32 or w.device != dev:
            raise ValueError("weights must be float32 tensors on one device")
        if w.numel() < 2:
            raise ValueError("kurtosis needs at least two elements a tensor")


def _reduce(losses: Tensor, mode: str) -> Tuple[Tensor, Tensor]:
    """(reduced loss, per-tensor weight of its gradient) in float64."""
    t = losses.numel()
    if mode == "avg":
        return losses.mean(), torch.full_like(losses, 1.0 / t)
    if mode == "sum":
        return losses.sum(), torch.ones_like(losses)
    top = losses.max()
    tie = (losses == top).to(losses.dtype)
    return top, tie / tie.sum()


def kurtosis_grouped_plain(
    weights: Sequence[Tensor],
    targets: Sequence[float],
    mode: str = "avg",
    *,
    with_grad: bool = True,
) -> Tuple[Tensor, Tensor, Optional[List[Tensor]]]:
    """Plain PyTorch K7: ``(loss f32 scalar, kurt f32 (T,), grads or
    None)``, the same arithmetic as the kernel (f64 sums of the f32
    ``d = w - f32(mean)``, closed-form gradient)."""
    _check(weights, targets, mode)
    moments, mus = [], []
    for w in weights:
        flat = w.detach().reshape(-1)
        n = flat.numel()
        mu = (flat.to(torch.float64).sum() / n).to(torch.float32)
        d = (flat - mu).to(torch.float64)
        d2 = d * d
        moments.append(torch.stack([d.sum(), d2.sum(), (d2 * d).sum(), (d2 * d2).sum()]))
        mus.append(mu)
    s = torch.stack(moments)  # (T, 4): S1, S2, S3, S4
    n = torch.tensor([w.numel() for w in weights], dtype=torch.float64, device=s.device)
    tgt = torch.tensor([float(v) for v in targets], dtype=torch.float32).to(s.device, torch.float64)
    var = s[:, 1] / (n - 1.0)
    kurt = (s[:, 3] / n) / (var * var)
    loss, wt = _reduce((kurt - tgt) ** 2, mode)
    grads = None
    if with_grad:
        c = (n - 1.0) * (n - 1.0) / n
        scale = wt * 2.0 * (kurt - tgt)
        a = scale * c * 4.0 / (s[:, 1] * s[:, 1])
        b = -scale * c * 4.0 * s[:, 3] / (s[:, 1] * s[:, 1] * s[:, 1])
        cc = -(a * s[:, 2] + b * s[:, 0]) / n
        grads = []
        for i, w in enumerate(weights):
            d = (w.detach() - mus[i]).to(torch.float64)
            grads.append((a[i] * d * d * d + b[i] * d + cc[i]).to(torch.float32))
    return loss.to(torch.float32), kurt.to(torch.float32), grads


class _Table(ctypes.Structure):
    """csrc/kurtosis.cu's ``Table``, the by-value tensor table: the same
    fields in the same order, so ctypes lays it out as the C compiler
    does (``MAX_TENSORS`` is the C side's ``MAX_T``)."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * MAX_TENSORS),
        ("goff", ctypes.c_longlong * MAX_TENSORS),
        ("n", ctypes.c_int * MAX_TENSORS),
        ("bstart", ctypes.c_int * (MAX_TENSORS + 1)),
        ("target", ctypes.c_float * MAX_TENSORS),
        ("T", ctypes.c_int),
        ("chunk", ctypes.c_int),
        ("vec", ctypes.c_ubyte * MAX_TENSORS),
    ]


class _Plan:
    """One set of tensors as K7 takes it: the packed table, the block
    count, and the output buffer's layout (kurt | loss | each gradient
    at a 16-byte aligned offset)."""

    def __init__(self, ptrs, shapes, targets):
        t = len(ptrs)
        ns = [math.prod(sh) for sh in shapes]
        if max(ns) >= 2**31:
            raise ValueError("K7 takes tensors of fewer than 2^31 elements")
        blocks = [-(-n // CHUNK) for n in ns]
        bstart = np.cumsum([0] + blocks)
        goff, off = [], -(-(t + 1) // 4) * 4
        for n in ns:
            goff.append(off)
            off += -(-n // 4) * 4
        tb = _Table()
        tb.ptr[:t] = ptrs
        tb.goff[:t] = goff
        tb.n[:t] = ns
        tb.bstart[: t + 1] = [int(b) for b in bstart]
        tb.target[:t] = targets
        tb.T = t
        tb.chunk = CHUNK
        tb.vec[:t] = [p % 16 == 0 for p in ptrs]
        self.table = tb
        self.table_ptr = ctypes.addressof(tb)
        self.blocks = int(bstart[-1])
        self.out_len = off
        self.t = t
        self.grads = [(tuple(sh), _contiguous_strides(sh), g) for sh, g in zip(shapes, goff)]


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


# plans by (addresses, shapes, dtypes and devices, targets, mode): the
# latent weights are updated in place, so a training run's key holds from
# step to step; a plan is a pure function of its key, so a reused address
# is safe, and a key is checked by _check once, when its plan is made
_plans: Dict[tuple, _Plan] = {}
_MAX_PLANS = 64


def _plan(weights: Sequence[Tensor], targets: Sequence[float], mode: str) -> _Plan:
    ptrs, shapes, kinds = [], [], []
    for w in weights:
        if not w.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        ptrs.append(w.data_ptr())
        shapes.append(w.shape)
        kinds.append((w.dtype, w.device))
    targets = tuple(map(float, targets))
    key = (tuple(ptrs), tuple(shapes), tuple(kinds), targets, mode)
    plan = _plans.get(key)
    if plan is None:
        _check(weights, targets, mode)
        if len(weights) > MAX_TENSORS:
            raise ValueError(f"at most {MAX_TENSORS} tensors a call, got {len(weights)}")
        if len(_plans) >= _MAX_PLANS:
            _plans.clear()
        plan = _plans[key] = _Plan(ptrs, shapes, targets)
    return plan


def kurtosis_grouped(
    weights: Sequence[Tensor],
    targets: Sequence[float],
    mode: str = "avg",
    *,
    with_grad: bool = True,
) -> Tuple[Tensor, Tensor, Optional[List[Tensor]]]:
    """``(loss f32 scalar, kurt f32 (T,), grads or None)`` of the grouped
    kurtosis regularizer — K7 on CUDA tensors (one call covers every
    tensor), the plain version on CPU tensors. The results are views of
    one output buffer, each gradient shaped like its weight.

    On the card the call builds nothing on the device: the tensor table
    (a kernel parameter) is packed once per set of tensors and reused
    while their addresses, shapes and the targets hold."""
    dev = weights[0].device if weights else torch.device("cpu")
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return kurtosis_grouped_plain(weights, targets, mode, with_grad=with_grad)
    from bdbnn_tpu_torch.nn.kernels import _build

    plan = _plan(weights, targets, mode)
    lib = _build.library("kurtosis")
    t = plan.t
    out = torch.empty((plan.out_len if with_grad else t + 1,), dtype=torch.float32, device=dev)
    partial = torch.empty((5 * plan.blocks,), dtype=torch.float64, device=dev)
    err = lib.bdbnn_kurtosis_grouped(
        plan.table_ptr, MODES[mode], int(with_grad), partial.data_ptr(),
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(lib, err, "kurtosis_grouped")
    _build.count_launch(kurtosis_grouped)
    grads = None
    if with_grad:
        grads = [out.as_strided(sh, st, off) for sh, st, off in plan.grads]
    return out.as_strided((), (), t), out.as_strided((t,), (1,), 0), grads


kurtosis_grouped.launches = 0


__all__ = ["MODES", "kurtosis_grouped", "kurtosis_grouped_plain"]

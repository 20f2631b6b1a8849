"""K7 — the grouped kurtosis regularizer, forward and gradient.

Counterpart of ``bdbnn_tpu/losses/kurtosis.py:51-113`` (``kurtosis``,
``kurtosis_regularization``) and of ``jax.grad`` through it. One call
takes every hooked latent weight at once:

    kurt_t = (S4/n) / (S2/(n-1))²   over d = w - mean(w)  (centered, Bessel)
    loss   = avg | sum | max over t of (kurt_t - target_t)²

and, with ``with_grad``, ``d loss / d w`` for every tensor in closed form
(``csrc/kurtosis.cu`` states it). On a CUDA tensor it is the hand-written
kernel ``csrc/kurtosis.cu`` — one grid over all tensors per pass (mean,
centered moments, a one-block finalize, gradient); on a CPU tensor
:func:`kurtosis_grouped_plain`. Both sum in float64 and round once to
float32 (the mean to f32 first, so ``d = w - mean`` is the same f32 value
in both), so they agree to an ulp or two; the reference's f32 autodiff
agrees with both to the rounding of its f32 sums.

The wrapper counts one launch a call (``kurtosis_grouped.launches``),
which is four grid launches on the card with the gradient, three without.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

MODES = {"avg": 0, "sum": 1, "max": 2}
CHUNK = 8192  # elements a block of csrc/kurtosis.cu
MAX_TENSORS = 256


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


def _table(weights: Sequence[Tensor], targets: Sequence[float]):
    """(meta, targets, blocks, total): the kernel's tensor table on the
    device. Both tables go through pinned memory, so the copy does not
    wait for the stream (the caching host allocator keeps the pinned
    block until the copy is done)."""
    dev = weights[0].device
    ns = [w.numel() for w in weights]
    blocks = [-(-n // CHUNK) for n in ns]
    goff, bstart = [0], [0]
    for n, b in zip(ns, blocks):
        goff.append(goff[-1] + n)
        bstart.append(bstart[-1] + b)
    meta = [w.data_ptr() for w in weights] + ns + goff[:-1] + bstart
    tgt = [float(v) for v in targets]
    return (
        torch.tensor(meta, dtype=torch.int64).pin_memory().to(dev, non_blocking=True),
        torch.tensor(tgt, dtype=torch.float32).pin_memory().to(dev, non_blocking=True),
        bstart[-1],
        goff[-1],
    )


def kurtosis_grouped(
    weights: Sequence[Tensor],
    targets: Sequence[float],
    mode: str = "avg",
    *,
    with_grad: bool = True,
) -> Tuple[Tensor, Tensor, Optional[List[Tensor]]]:
    """``(loss f32 scalar, kurt f32 (T,), grads or None)`` of the grouped
    kurtosis regularizer — K7 on CUDA tensors (one call covers every
    tensor), the plain version on CPU tensors. The gradients are views
    of one flat buffer, each shaped like its weight."""
    _check(weights, targets, mode)
    dev = weights[0].device
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return kurtosis_grouped_plain(weights, targets, mode, with_grad=with_grad)
    from bdbnn_tpu_torch.nn.kernels import _build

    if len(weights) > MAX_TENSORS:
        raise ValueError(f"at most {MAX_TENSORS} tensors a call, got {len(weights)}")
    if not all(w.is_contiguous() for w in weights):
        raise ValueError("the kernel takes contiguous tensors")
    lib = _build.library("kurtosis")
    meta, tgt, blocks, total = _table(weights, targets)
    t = len(weights)
    partial = torch.empty((blocks, 5), dtype=torch.float64, device=dev)
    coef = torch.empty((t, 4), dtype=torch.float64, device=dev)
    kurt = torch.empty((t,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    flat = torch.empty((total if with_grad else 0,), dtype=torch.float32, device=dev)
    err = lib.bdbnn_kurtosis_grouped(
        meta.data_ptr(), tgt.data_ptr(), t, blocks, CHUNK, MODES[mode], int(with_grad),
        partial.data_ptr(), coef.data_ptr(), kurt.data_ptr(), loss.data_ptr(),
        flat.data_ptr() if with_grad else None, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "kurtosis_grouped")
    kurtosis_grouped.launches += 1
    grads = None
    if with_grad:
        grads, off = [], 0
        for w in weights:
            grads.append(flat[off : off + w.numel()].view(w.shape))
            off += w.numel()
    return loss, kurt, grads


kurtosis_grouped.launches = 0


__all__ = ["MODES", "kurtosis_grouped", "kurtosis_grouped_plain"]

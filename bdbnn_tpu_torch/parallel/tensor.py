"""Tensor parallelism over the mesh's ``model`` axis: the collectives
GSPMD inserts for the reference's output-channel shards, written out.

The reference places a parameter that :func:`~bdbnn_tpu_torch.parallel.
mesh.param_spec` shards with its output channels split over ``model``
and lets GSPMD partition the arithmetic. The port runs one process a
card, so a sharded layer does it by hand:

- :func:`copy_to_model` on each replicated input of the layer (the
  activation, react's ``act_shift``): the identity forward; the backward
  sums the cotangent over ``model``, since each rank's cotangent is the
  part its own output channels contribute;
- the layer's arithmetic on the rank's ``O/N`` channels (the binary
  convs' K2 → K1, K5 and K6, a ``FloatConv``, the classifier's product);
- :func:`gather_from_model` on the output: the forward all-gathers the
  channel dim in rank order; the backward takes the rank's own slice.

Everything after the gather runs replicated on whole tensors, so every
model rank computes the same values. The ±1 product and a binary conv's
per-channel alpha of one output channel read nothing of the others,
which makes a sharded binary conv's output bitwise the whole one. A
replicated parameter's gradient is computed on every model rank from the
same tensors, but a GPU kernel that accumulates with atomics (cuDNN's
weight gradient of the stem conv) can leave the ranks' last bits apart,
and the replicas, and then the inputs each rank's shard reads, would
drift: :func:`agree_replicated_grads` hands every model rank the first
one's before the update.

:func:`shard_model` cuts a model's parameters to the rank's slices and
marks each sharded ``Parameter`` (``model_axis``, ``shard_dim``) and the
module that owns it (``model_axis``); :func:`whole` gathers a sharded
parameter inside autograd (the regularizers see whole weights, and each
rank's gradient is its slice of theirs); :func:`full_state_dict`,
:func:`full_optimizer_state`, :func:`shard_state_dict` and
:func:`shard_optimizer_state` move a model's or optimizer's state
between the whole layout of a checkpoint and the rank's.

Only ``all_gather``, ``all_reduce`` and ``broadcast`` are used: gloo and
NCCL both run them on CUDA tensors. Every rank of a ``model`` group must make each of
these calls in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A rank's place on the ``model`` axis: the group, its size and the
    rank's index in it."""

    group: Any
    size: int
    rank: int
    # the global rank of the group's first member
    root: int = 0


def model_axis(mesh) -> ModelAxis:
    return ModelAxis(mesh.model_group, mesh.model, mesh.model_rank,
                     mesh.data_rank * mesh.model)


def _gather(t: Tensor, axis: ModelAxis, dim: int) -> Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def shard_slice(t: Tensor, axis: ModelAxis, dim: int) -> Tensor:
    """The rank's slice of a whole tensor along ``dim`` (a copy)."""
    k = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * k, k).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, axis: ModelAxis) -> Tensor:
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, axis: ModelAxis, dim: int) -> Tensor:
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g: Tensor):
        return shard_slice(g, ctx.axis, ctx.dim), None, None


def copy_to_model(x: Tensor, axis: ModelAxis) -> Tensor:
    """``x`` as it is; its cotangent summed over ``model``."""
    return _CopyToModel.apply(x, axis)


def gather_from_model(x: Tensor, axis: ModelAxis, dim: int = -1) -> Tensor:
    """The ranks' slices of ``x`` concatenated along ``dim`` in rank
    order; the cotangent's slice of this rank goes back."""
    return _GatherFromModel.apply(x, axis, dim % x.dim())


def sharded(p: Tensor) -> bool:
    return getattr(p, "model_axis", None) is not None


def whole(p: Tensor) -> Tensor:
    """A parameter whole: a sharded one gathered (in autograd: its
    gradient is this rank's slice of the whole tensor's), any other as it
    is."""
    if not sharded(p):
        return p
    return gather_from_model(p, p.model_axis, p.shard_dim)


def sum_over_model(t: Tensor, axis: Optional[ModelAxis]) -> Tensor:
    """``t`` summed over the ``model`` axis (a new tensor; ``t`` itself
    without an axis)."""
    if axis is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=axis.group)
    return t


def agree_replicated_grads(params: Iterable[Tensor]) -> None:
    """When some of ``params`` are sharded over ``model``: the gradients
    of the others (the replicated parameters) become the model group's
    first rank's on every rank, in one broadcast of their concatenation,
    in place. Every model rank must call it with the same parameters.
    Nothing happens for a model that is not sharded."""
    params = list(params)
    axis = next((p.model_axis for p in params if sharded(p)), None)
    if axis is None:
        return
    grads = [p.grad for p in params if not sharded(p) and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.broadcast(flat, src=axis.root, group=axis.group)
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(parts, grads)])


def shard_model(model: torch.nn.Module, mesh) -> List[str]:
    """Cut every parameter of ``model`` that the reference's rule shards
    (:func:`~bdbnn_tpu_torch.parallel.mesh.params_shardings`) to this
    rank's slice, in place (``Parameter.data``: an optimizer that holds
    the parameter keeps it), and mark it and its module. Returns the
    sharded names. A model already sharded is left as it is."""
    from bdbnn_tpu_torch.parallel.mesh import params_shardings

    if any(sharded(p) for p in model.parameters()):
        return [n for n, p in model.named_parameters() if sharded(p)]
    axis = model_axis(mesh)
    specs = params_shardings(model, mesh.model)
    modules = dict(model.named_modules())
    names = []
    for name, dim in specs.items():
        if dim is None:
            continue
        p = model.get_parameter(name)
        with torch.no_grad():
            p.data = shard_slice(p.data, axis, dim)
        p.model_axis, p.shard_dim = axis, dim
        modules[name.rpartition(".")[0]].model_axis = axis
        names.append(name)
    return names


def full_state_dict(model: torch.nn.Module) -> Dict[str, Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered whole
    (a collective over ``model`` when the model is sharded)."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        if sharded(p):
            sd[name] = _gather(p.detach(), p.model_axis, p.shard_dim)
    return sd


def shard_state_dict(model: torch.nn.Module, sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A whole ``state_dict`` (a checkpoint's) cut to ``model``'s shards:
    the identity for a model that is not sharded."""
    out = dict(sd)
    for name, p in model.named_parameters():
        if sharded(p) and name in out and out[name].shape != p.shape:
            out[name] = shard_slice(out[name], p.model_axis, p.shard_dim)
    return out


def _opt_params(optimizer: torch.optim.Optimizer) -> Iterable[Tensor]:
    for group in optimizer.param_groups:
        yield from group["params"]


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with the state of each sharded parameter
    (its moments or momentum, the tensors of its shape) gathered whole (a
    collective over ``model`` when the model is sharded)."""
    sd = optimizer.state_dict()
    for i, p in enumerate(_opt_params(optimizer)):
        st = sd["state"].get(i)
        if st is None or not sharded(p):
            continue
        sd["state"][i] = {k: (_gather(v, p.model_axis, p.shard_dim)
                              if torch.is_tensor(v) and v.shape == p.shape else v)
                          for k, v in st.items()}
    return sd


def shard_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Cut the state the optimizer already holds for each sharded
    parameter (a restored checkpoint's whole moments) to the parameter's
    slice, in place; state already of the slice's shape stays."""
    for p in _opt_params(optimizer):
        st = optimizer.state.get(p)
        if not st or not sharded(p):
            continue
        for k, v in list(st.items()):
            if torch.is_tensor(v) and v.dim() == p.dim() and v.shape != p.shape:
                st[k] = shard_slice(v, p.model_axis, p.shard_dim)


__all__ = [
    "ModelAxis",
    "agree_replicated_grads",
    "copy_to_model",
    "full_optimizer_state",
    "full_state_dict",
    "gather_from_model",
    "model_axis",
    "shard_model",
    "shard_optimizer_state",
    "shard_slice",
    "shard_state_dict",
    "sharded",
    "sum_over_model",
    "whole",
]

"""Data and tensor parallelism across processes — the port's counterpart
of ``bdbnn_tpu/parallel/mesh.py``, on ``torch.distributed``.

A W-process job runs one process per card, started by torchrun (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) with ``--distributed-init``. Its
numbers are those of the reference's ``('data', 'model')`` mesh with
``model = --model-parallel N`` and ``data = W / N``, in the reference's
device order (the ranks reshaped ``(data, model)``): rank r sits at
``data_rank = r // N``, ``model_rank = r % N``.

- one global batch over the ``data`` axis: each data rank feeds
  ``batch_size // data`` rows, rows ``[d·B, (d+1)·B)`` of the global
  batch, and every model rank of it feeds the same rows;
- global BatchNorm statistics: a train-mode ``BatchNorm`` sums its f32
  ``[Σx, Σx²]`` over the data group in one all-reduce (GSPMD inserts the
  same all-reduce over the sharded batch axis of flax's ``BatchNorm``);
- one averaged gradient: :func:`create_sharded_state` wraps the student
  in ``DistributedDataParallel`` over the data group;
- output-channel shards over the ``model`` axis (:func:`param_spec`, the
  reference's rule): a sharded conv or classifier computes its rank's
  ``O/N`` output channels and gathers them (``parallel/tensor.py``);
- global metrics and one agreement on the step-boundary flags
  (:func:`coordinate_flags`), over gloo groups that carry host values
  only and never touch the card's stream.

Without a process group (or with W = 1) :func:`make_mesh` gives a mesh of
one and nothing here issues a collective: the single-process path is the
one it always was, as the reference's single-process runs skip the
all-reduce entirely. With N = 1 the job makes the groups it always made
(the data group is the world).

:func:`replica_devices` names the cards a serving replica pool places
its engines on, one engine per card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the reference's rule: a parameter is sharded over ``model`` only when
# its output channels number at least this many
MIN_SHARD_SIZE = 256
# a collective (the rendezvous included) that waits longer than this
# fails the run: a rank that never joins, or one that died, must not
# leave the others waiting forever
DEFAULT_TIMEOUT_S = 600.0
# what torchrun sets for each process
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(backend: Optional[str] = None, device: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group that torchrun's environment describes (the
    counterpart of ``jax.distributed.initialize``) and return this rank's
    device: ``device`` when given, else ``cuda:LOCAL_RANK``.

    The backend is ``nccl`` on a CUDA device and ``gloo`` on the CPU;
    ``backend`` overrides it (gloo ranks sharing one card). Raises
    ``RuntimeError`` when the environment is incomplete, and whatever
    ``init_process_group`` raises when a rank does not join within
    ``timeout_s``: a run that asked for a group never goes on as one
    process."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed-init needs torchrun's environment; {', '.join(missing)} not set "
            "(start the job with torchrun --nproc-per-node N -m bdbnn_tpu_torch.cli ... "
            "--distributed-init)"
        )
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device if device else f"cuda:{local_rank}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for rank {os.environ['RANK']} ({dev}); pass "
                               "--device cpu to train on the CPU over gloo")
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://",
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` layout of the job: ``data`` × ``model``
    ranks, this process's ``rank``, and its groups (None for a mesh of
    one): ``host_group`` (gloo, every rank: flags, barriers, the run
    dir's stamp), ``data_group`` (the ranks that share this rank's model
    shard: BatchNorm's sums and the gradient average; the world when
    ``model`` is 1), ``data_host_group`` (gloo over the same ranks: the
    drained metric sums) and ``model_group`` (the ranks that share this
    rank's rows: the gathers and sums of the ``model`` axis)."""

    data: int = 1
    rank: int = 0
    host_group: Any = None
    model: int = 1
    data_group: Any = None
    data_host_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def collective(self) -> bool:
        """True when the job has more than one rank (every agreement then
        goes through a collective)."""
        return self.world > 1

    @property
    def primary(self) -> bool:
        return self.rank == 0


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of the process group that is up (a mesh of one without
    one), with ``model = model_parallel`` and ``data = W / model``. Every
    rank must call it: it makes the job's groups, each with every rank
    taking part in every ``new_group`` in one order. A world that
    ``model_parallel`` does not divide raises the reference's
    ``ValueError`` (one process counts as a world of 1)."""
    if model_parallel < 1:
        raise ValueError(f"--model-parallel must be >= 1, got {model_parallel}")
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model={model_parallel}")
    if world == 1:
        return Mesh()
    host = dist.new_group(backend="gloo")
    n, d = model_parallel, world // model_parallel
    if n == 1:
        return Mesh(data=world, rank=rank, host_group=host, data_group=dist.group.WORLD,
                    data_host_group=host)
    groups = {}
    if d > 1:
        for m in range(n):
            members = [i * n + m for i in range(d)]
            device_group = dist.new_group(ranks=members)
            host_group = dist.new_group(ranks=members, backend="gloo")
            if rank in members:
                groups.update(data_group=device_group, data_host_group=host_group)
    for i in range(d):
        members = [i * n + m for m in range(n)]
        device_group = dist.new_group(ranks=members)
        if rank in members:
            groups["model_group"] = device_group
    return Mesh(data=d, rank=rank, host_group=host, model=n, **groups)


def param_spec(shape: Sequence[int], *, model_parallel: int,
               min_shard_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The reference's ``param_spec`` on the shape of a flax-layout leaf
    (HWIO conv kernels, ``(in, out)`` Dense kernels; the rule reads no
    path): the dim sharded over ``model`` — the last (output-channel)
    one, for a leaf of 2 or more dims whose output channels
    ``model_parallel`` divides and number at least ``min_shard_size`` —
    or None (replicated)."""
    if model_parallel > 1 and len(shape) >= 2:
        out = shape[-1]
        if out % model_parallel == 0 and out >= min_shard_size:
            return len(shape) - 1
    return None


def _flax_layout(name: str, shape: Sequence[int]):
    """A port parameter's flax-layout shape and the port dim that holds
    the flax leaf's last axis: a ``FloatConv.weight`` is OIHW (HWIO in
    flax: O is dim 0), an ``nn.Linear.weight`` is ``(out, in)`` (flax's
    kernel is ``(in, out)``: dim 0); every other leaf (a binary conv's
    HWIO ``float_weight``, the 1-D ones) has flax's layout."""
    shape = tuple(shape)
    if name.rpartition(".")[2] == "weight" and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0]), 0
    if name.rpartition(".")[2] == "weight" and len(shape) == 2:
        return (shape[1], shape[0]), 0
    return shape, len(shape) - 1


def params_shardings(model: torch.nn.Module, model_parallel: int) -> Dict[str, Optional[int]]:
    """Every parameter of ``model`` (whole, as built) by name: the port
    dim sharded over ``model`` under :func:`param_spec`, or None."""
    out = {}
    for name, p in model.named_parameters():
        flax_shape, dim = _flax_layout(name, p.shape)
        spec = param_spec(flax_shape, model_parallel=model_parallel)
        out[name] = None if spec is None else dim
    return out


def topology(mesh: Mesh) -> dict:
    """The job's layout as the reference records it (``resume.json``, the
    ``restore`` event): one process and one device a rank."""
    return {"processes": mesh.world, "devices": mesh.world, "mesh": dict(mesh.shape)}


def resharded(topo_from: Optional[dict], topo_to: dict) -> Optional[bool]:
    """Whether a checkpoint written on ``topo_from`` is restored onto
    another layout (the reference's comparison: processes, devices, and
    the mesh where the writer recorded one); None when the checkpoint
    records no topology."""
    if not topo_from:
        return None
    return (int(topo_from.get("processes", -1)) != topo_to["processes"]
            or int(topo_from.get("devices", -1)) != topo_to["devices"]
            or (topo_from.get("mesh") or topo_to["mesh"]) != topo_to["mesh"])


def _host_all_reduce(values: Sequence[float], op, group) -> np.ndarray:
    t = torch.tensor(np.asarray(values, np.float64).reshape(-1), dtype=torch.float64)
    dist.all_reduce(t, op=op, group=group)
    return t.numpy()


def coordinate_flags(values: Sequence[float], mesh: Mesh) -> np.ndarray:
    """Every rank's step-boundary trigger vector, agreed: the elementwise
    MAX over the ranks (a signal latched on any rank, rank 0's wallclock
    cadence). A mesh of one returns the local vector without a
    collective. Every rank must call it at the same point of its step
    sequence, with a vector of the same length."""
    local = np.asarray(values, np.float64)
    if not mesh.collective:
        return local
    return _host_all_reduce(local, dist.ReduceOp.MAX, mesh.host_group)


def sum_host_values(values: Sequence[float], mesh: Mesh) -> np.ndarray:
    """The elementwise float64 SUM of a host vector over the ``data``
    axis (the identity with one data rank): drained metric sums and eval
    totals, which every model rank of a data rank holds alike. Every rank
    must call it."""
    local = np.asarray(values, np.float64)
    if mesh.data == 1:
        return local
    return _host_all_reduce(local, dist.ReduceOp.SUM, mesh.data_host_group)


def broadcast_host_int(value: int, mesh: Mesh) -> int:
    """Rank 0's ``value`` on every rank (the identity on a mesh of one):
    one run-dir timestamp for the job."""
    if not mesh.collective:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=mesh.host_group)
    return int(t.item())


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (over the host group; a no-op on a mesh of
    one)."""
    if mesh.collective:
        dist.barrier(group=mesh.host_group)


def create_sharded_state(mesh: Mesh, state, teacher: Optional[torch.nn.Module] = None):
    """``state`` (a :class:`~bdbnn_tpu_torch.train.state.TrainState`) laid
    out on the mesh, in place: on a mesh of one it is returned as it is.
    With ``model`` > 1 every parameter :func:`param_spec` shards (and
    ``teacher``'s, which the reference shards too) is cut to this rank's
    slice, and so is any optimizer state it already has (a restored
    checkpoint's), before the update first runs, so the moments follow
    the shards (``parallel/tensor.py``). With ``data`` > 1 every
    ``BatchNorm`` of the student takes global-batch statistics over the
    data group and ``state.ddp`` is the student wrapped in
    ``DistributedDataParallel`` over it, which averages the gradient
    over the data ranks. The optimizer holds the student's parameter
    tensors, which the slicing and the wrapper keep (neither copies a
    ``Parameter``); the wrapper broadcasts the data group's first
    parameters and buffers once, as it is built.

    ``broadcast_buffers=False``: the running statistics are updated from
    global statistics, so they stay equal on every rank without a
    broadcast each step. Every student parameter takes a gradient in
    every step (the plain, teacher–student and remat steps), so
    ``find_unused_parameters`` stays off."""
    if not mesh.collective:
        return state
    if mesh.model > 1:
        from bdbnn_tpu_torch.parallel.tensor import shard_model, shard_optimizer_state

        shard_model(state.model, mesh)
        shard_optimizer_state(state.optimizer)
        if teacher is not None:
            shard_model(teacher, mesh)
    if mesh.data == 1:
        return state
    from torch.nn.parallel import DistributedDataParallel

    from bdbnn_tpu_torch.nn.layers import BatchNorm

    group = mesh.data_group
    for m in state.model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    with warnings.catch_warnings():
        # newer releases rename the option; its meaning here (no buffer
        # broadcast in the forward) is the one wanted
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*", category=FutureWarning)
        state.ddp = DistributedDataParallel(state.model, device_ids=None,
                                            broadcast_buffers=False, process_group=group)
    return state


def replica_devices(n: int, device: Optional[Any] = None) -> Sequence[torch.device]:
    """The ``n`` devices a serving replica pool places its engines on,
    one engine per device (the counterpart of the reference's
    ``replica_devices`` over ``jax.devices()``): the CUDA cards in index
    order, or the one CPU device when ``device`` is the CPU. ``n``
    beyond the device count raises: two replicas contending for one
    card is a silent perf lie, not a bigger pool. Like every entry
    point, it asks for the card unless ``device`` says otherwise, and
    raises without one."""
    from bdbnn_tpu_torch import resolve_device

    if n <= 0:
        raise ValueError(f"need n >= 1 replicas, got {n}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        flat = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        flat = [dev]
    if n > len(flat):
        raise ValueError(
            f"{n} replicas over {len(flat)} devices: one engine per "
            "device is the contract (shrink --replicas or grow the mesh)"
        )
    return flat[:n]


__all__ = [
    "DATA_AXIS",
    "DEFAULT_TIMEOUT_S",
    "MIN_SHARD_SIZE",
    "MODEL_AXIS",
    "Mesh",
    "barrier",
    "broadcast_host_int",
    "coordinate_flags",
    "create_sharded_state",
    "initialize_distributed",
    "make_mesh",
    "param_spec",
    "params_shardings",
    "replica_devices",
    "resharded",
    "sum_host_values",
    "topology",
]

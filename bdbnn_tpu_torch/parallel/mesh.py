"""Data parallelism across processes — the port's counterpart of
``bdbnn_tpu/parallel/mesh.py``, on ``torch.distributed``.

A W-process job runs one process per card, started by torchrun (or any
launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) with ``--distributed-init``. Its
numbers are those of the reference's mesh run over a ``data`` axis of W:

- one global batch: each rank feeds ``batch_size // W`` rows, and the
  rows of rank r are rows ``[r·B, (r+1)·B)`` of the global batch;
- global BatchNorm statistics: a train-mode ``BatchNorm`` sums its f32
  ``[Σx, Σx²]`` over the ranks in one all-reduce (GSPMD inserts the same
  all-reduce over the sharded batch axis of flax's ``BatchNorm``);
- one averaged gradient: :func:`create_sharded_state` wraps the student
  in ``DistributedDataParallel``;
- global metrics and one agreement on the step-boundary flags
  (:func:`coordinate_flags`), over a second, gloo, group that carries
  host values only and never touches the card's stream.

Without a process group (or with W = 1) :func:`make_mesh` gives a mesh of
one and nothing here issues a collective: the single-process path is the
one it always was, as the reference's single-process runs skip the
all-reduce entirely.

:func:`replica_devices` names the cards a serving replica pool places
its engines on, one engine per card. Tensor parallelism over the
``model`` axis (``param_spec``, ``params_shardings``) is ROADMAP A
"Later" item 9.
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
# the ROADMAP A item that brings the ``model`` axis
TENSOR_PARALLEL = "item 9: tensor parallelism over 'model'"
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
    """A ``('data', 'model')`` layout of the job: ``data`` ranks (the
    ``model`` axis is 1: tensor parallelism is not ported), this
    process's ``rank``, and the gloo group for host values (None for a
    mesh of one)."""

    data: int = 1
    rank: int = 0
    host_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: 1}

    @property
    def collective(self) -> bool:
        """True when the job has more than one rank (every agreement and
        metric then goes through a collective)."""
        return self.data > 1

    @property
    def primary(self) -> bool:
        return self.rank == 0


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of the process group that is up (a mesh of one without
    one). Every rank must call it: a job of more than one rank makes its
    host group here. ``model_parallel > 1`` raises
    ``NotImplementedError`` (ROADMAP A 'Later' item 9)."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {model_parallel} is not ported yet: ROADMAP A 'Later' "
            f"{TENSOR_PARALLEL}"
        )
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world == 1:
        return Mesh()
    return Mesh(data=world, rank=rank, host_group=dist.new_group(backend="gloo"))


def topology(mesh: Mesh) -> dict:
    """The job's layout as the reference records it (``resume.json``, the
    ``restore`` event): one process and one device a rank."""
    return {"processes": mesh.data, "devices": mesh.data, "mesh": dict(mesh.shape)}


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


def _host_all_reduce(values: Sequence[float], op, mesh: Mesh) -> np.ndarray:
    t = torch.tensor(np.asarray(values, np.float64).reshape(-1), dtype=torch.float64)
    dist.all_reduce(t, op=op, group=mesh.host_group)
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
    return _host_all_reduce(local, dist.ReduceOp.MAX, mesh)


def sum_host_values(values: Sequence[float], mesh: Mesh) -> np.ndarray:
    """The elementwise float64 SUM of a host vector over the ranks (the
    identity on a mesh of one): drained metric sums and eval totals."""
    local = np.asarray(values, np.float64)
    if not mesh.collective:
        return local
    return _host_all_reduce(local, dist.ReduceOp.SUM, mesh)


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


def create_sharded_state(mesh: Mesh, state):
    """``state`` (a :class:`~bdbnn_tpu_torch.train.state.TrainState`) laid
    out on the mesh, in place: on a mesh of one it is returned as it is;
    otherwise every ``BatchNorm`` of the student takes global-batch
    statistics over the default group and ``state.ddp`` is the student
    wrapped in ``DistributedDataParallel``, which averages the gradient
    over the ranks. The optimizer already holds the student's parameter
    tensors, which the wrapper shares (it copies none); the wrapper
    broadcasts rank 0's parameters and buffers once, as it is built.

    ``broadcast_buffers=False``: the running statistics are updated from
    global statistics, so they stay equal on every rank without a
    broadcast each step. Every student parameter takes a gradient in
    every step (the plain, teacher–student and remat steps), so
    ``find_unused_parameters`` stays off."""
    if not mesh.collective:
        return state
    from torch.nn.parallel import DistributedDataParallel

    from bdbnn_tpu_torch.nn.layers import BatchNorm

    group = dist.group.WORLD
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
    "MODEL_AXIS",
    "Mesh",
    "TENSOR_PARALLEL",
    "barrier",
    "broadcast_host_int",
    "coordinate_flags",
    "create_sharded_state",
    "initialize_distributed",
    "make_mesh",
    "replica_devices",
    "resharded",
    "sum_host_values",
    "topology",
]

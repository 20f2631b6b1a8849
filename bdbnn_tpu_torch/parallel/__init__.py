"""Data parallelism across processes (``torch.distributed``), the
counterpart of ``bdbnn_tpu/parallel``."""

from bdbnn_tpu_torch.parallel import mesh
from bdbnn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DEFAULT_TIMEOUT_S,
    MODEL_AXIS,
    TENSOR_PARALLEL,
    Mesh,
    barrier,
    broadcast_host_int,
    coordinate_flags,
    create_sharded_state,
    initialize_distributed,
    make_mesh,
    resharded,
    sum_host_values,
    topology,
)

__all__ = [
    "mesh",
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
    "resharded",
    "sum_host_values",
    "topology",
]

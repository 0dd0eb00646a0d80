from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    mesh_from_environment,
    pad_batch_rows,
    shard_batch,
    shard_dataset,
    shard_rows,
)
from .multihost import (
    all_gather_host_arrays,
    barrier,
    broadcast_scalar,
    initialize_distributed,
    process_count,
    process_index,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "all_gather_host_arrays",
    "barrier",
    "broadcast_scalar",
    "initialize_distributed",
    "make_mesh",
    "mesh_from_environment",
    "pad_batch_rows",
    "process_count",
    "process_index",
    "shard_batch",
    "shard_dataset",
    "shard_rows",
]

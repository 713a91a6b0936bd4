"""Data parallelism over torch.distributed (upnerf/parallel/): rays sharded
across ranks, parameters replicated, one all-reduce-mean a step.

Exports the names of `upnerf/parallel/__init__.py` but `batch_sharding` and
`replicated_sharding`, which have no torch meaning (mesh.py says why), and
the torch side's own: `DataMesh`, `launch`, `shutdown`, `local_ranks`,
`all_gather_rows`, `all_reduce_mean`, `all_reduce_grads`,
`assert_replicated`.
"""

from .distributed import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_mean,
    assert_replicated,
    fetch,
    initialize,
    is_main_process,
    is_multiprocess,
    launch,
    local_ranks,
    put_local_shards,
    put_replicated,
    shutdown,
    sync,
)
from .mesh import DATA_AXIS, DataMesh, make_mesh, shard_batch

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "make_mesh",
    "shard_batch",
    "initialize",
    "launch",
    "shutdown",
    "is_multiprocess",
    "is_main_process",
    "local_ranks",
    "put_replicated",
    "put_local_shards",
    "fetch",
    "all_gather_rows",
    "all_reduce_mean",
    "all_reduce_grads",
    "assert_replicated",
    "sync",
]

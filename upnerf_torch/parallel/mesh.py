"""The 1-D data mesh (upnerf/parallel/mesh.py) as ranks of a torch process group.

UP-NeRF's only shardable axis is the ray batch: the model is a ~2 M-parameter
MLP (one gradient all-reduce is ~8 MB of f32) and the embeddings are tiny.
Rays are sharded across the mesh, parameters and embeddings are replicated,
and one all-reduce-mean a step combines the gradients. In torch a rank is one
process driving one device, so the JAX package's "data" mesh of n devices is
n ranks of one process group (`distributed.initialize`, `distributed.launch`).

JAX's `batch_sharding` / `replicated_sharding` are left out: a torch tensor
lives on one device, so a sharding is only which rows of a global batch a rank
holds, and `shard_batch` takes them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import distributed

DATA_AXIS = "data"


class DataMesh(NamedTuple):
    """This rank's place in the data mesh. `group` is the group the mesh's
    collectives run on (None: torch's default group); a mesh of size 1 runs no
    collective, and `DataMesh()` is this process alone."""

    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None
    group: Optional[Any] = None


def make_mesh(n_devices: int = 0, device="cuda") -> DataMesh:
    """The data mesh over every rank of the process group, or this process
    alone when there is no group.

    n_devices is `tpu.n_devices`, the ranks each process drives
    (`distributed.local_ranks` clamps it). Without a group 0 means this
    process's one device, and more than one rank raises; under a group it
    must be 0 or the local ranks the group was started with: a process
    cannot sub-slice its host."""
    device = torch.device(device)
    n_local = distributed.local_ranks(n_devices, device)
    if not dist.is_initialized():
        if n_local > 1:
            raise RuntimeError(f"tpu.n_devices {n_devices} asks for {n_local} ranks, but this process has no process"
                               " group: start the ranks with upnerf_torch.parallel.launch (cli.train and cli.tto do)")
        return DataMesh(0, 1, device, None)
    if n_devices and n_local != distributed.local_size():
        raise ValueError(f"tpu.n_devices cannot sub-slice a host in multi-process runs: every local rank joins the"
                         f" mesh (got {n_devices}, this process drives {distributed.local_size()})")
    return DataMesh(dist.get_rank(), dist.get_world_size(), distributed.local_device(), distributed.data_group())


def shard_batch(mesh: DataMesh, batch: Any, axis: int = 0) -> Any:
    """This rank's rows [r B / n, (r + 1) B / n) of a global batch along
    `axis`, for a tensor or a dict of them: the rows JAX's P(DATA_AXIS) gives
    device r. B must divide by the mesh's size."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if mesh.size == 1:
        return batch
    n = batch.shape[axis]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over a mesh of {mesh.size}")
    m = n // mesh.size
    return batch.narrow(axis, mesh.rank * m, m)

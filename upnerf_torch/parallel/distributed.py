"""Process groups for data-parallel runs (upnerf/parallel/distributed.py).

The JAX package runs one process per host over one global device mesh. In
torch a rank is one process driving one device (the NCCL rule too), so a
mesh of n devices is n ranks:

- `launch(fn, ...)` starts this process's local ranks with the spawn start
  method (CUDA cannot be forked once initialised), each on its own device, and
  runs `fn` in each; `initialize(...)` joins one rank to the group (what
  `launch` does in each rank, and what a process that is one rank calls
  itself). A process that is one host of `num_processes` starts `local_size`
  ranks: world size num_processes x local_size, global rank
  process_id x local_size + local rank.
- The default group is gloo over TCP at the coordinator (`torchrun`'s env://
  variables when no coordinator, process count or id is given). The data
  mesh's collectives run on NCCL when every rank has a card of its own, and
  on gloo when ranks share a card (NCCL refuses two ranks on one device) or
  run on the CPU. Gloo reduces and broadcasts CUDA tensors through host
  memory; it has no all-gather of them, so `all_gather_rows` copies to the
  host first.
- `put_replicated` (a broadcast from rank 0), `put_local_shards`, `fetch`
  (rows gathered in rank order, or a plain copy of a replicated value),
  `all_reduce_mean` (one collective over a flat buffer), `all_reduce_grads`
  (the gradients' mean, in place), `sync` (a barrier, a no-op for one rank)
  and `assert_replicated` (every rank's bytes equal).

A group that fails to form raises, and so does a rank that fails: its peers
are terminated. Filesystem side effects are gated to rank 0 by the callers
(`upnerf_torch.train.loop.Trainer`, the CLIs).
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
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

# This process's rank, as `initialize` set it up (torch.distributed keeps the group itself per process).
_RANK: Dict[str, Any] = {"device": None, "local_size": 1, "group": None}


def local_ranks(n_devices, device, every_card: bool = False) -> int:
    """The ranks a process starts for `tpu.n_devices` (the JAX mesh's local
    devices): on CUDA, n_devices clamped to the local cards; on the CPU,
    n_devices ranks. 0 is one rank, this process's own device, unless
    `every_card` (a host of a multi-process run): then every local card."""
    n = int(n_devices or 0)
    cuda = torch.device(device).type == "cuda"
    if n <= 0:
        n = torch.cuda.device_count() if every_card and cuda else 1
    return max(1, min(n, torch.cuda.device_count()) if cuda else n)


def _card_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, initialization_timeout: Optional[int] = None, *,
               local_rank: int = 0, local_size: int = 1, device="cpu") -> None:
    """Join this process to the group as local rank `local_rank` of
    `local_size` of process `process_id` (of `num_processes`), on `device`,
    with the coordinator at `coordinator_address` ("host:port"). With none of
    the three, torchrun's RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT say it (the counterpart of JAX's discovery from
    the TPU metadata). Ends with a first `sync` and a first collective on the
    data group."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        init_method = "env://"
    elif any(v is None for v in given):
        raise ValueError("dist.coordinator, dist.num_processes and dist.process_id go together (or none of them,"
                         " with torchrun's variables)")
    else:
        rank, world = int(process_id) * local_size + local_rank, int(num_processes) * local_size
        init_method = "tcp://" + str(coordinator_address).split("://")[-1]
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kwargs = {}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=int(initialization_timeout))
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world, **kwargs)
    group, backend = None, "gloo"
    if device.type == "cuda":
        cards: List[Optional[str]] = [None] * world
        dist.all_gather_object(cards, _card_id(device))
        if len(set(cards)) == world:  # a card each: NCCL; ranks that share a card stay on gloo
            group, backend = dist.new_group(backend="nccl"), "nccl"
    _RANK.update(device=device, local_size=local_size, group=group)
    if rank == 0:
        print(f"[upnerf_torch] process group of {world} ranks ({world // local_size} processes x {local_size}) at"
              f" {init_method}; the data mesh's collectives on {backend}", flush=True)
    # Join the collectives now, while the ranks are in step: NCCL's communicator and gloo's pairs form at their first
    # collective, and the next one comes only after the scene is loaded and the state built.
    sync("upnerf_torch:init")
    warm = torch.zeros(1, device=device)
    dist.all_reduce(warm, group=group)


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK.update(device=None, local_size=1, group=None)


def local_device() -> Optional[torch.device]:
    return _RANK["device"]


def local_size() -> int:
    return _RANK["local_size"]


def data_group():
    return _RANK["group"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, fn: Callable, args: tuple, spec: dict, devices: Sequence, threads: int,
               results) -> None:
    torch.set_num_threads(threads)
    initialize(**spec, local_rank=local_rank, local_size=len(devices), device=devices[local_rank])
    try:
        results.put((local_rank, fn(*args)))
    finally:
        shutdown()


def launch(fn: Callable, args: tuple = (), *, n_local: int, device="cuda", devices: Optional[Sequence] = None,
           coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
           process_id: Optional[int] = None, initialization_timeout: Optional[int] = None) -> list:
    """Start `n_local` ranks of this process, run fn(*args) in each inside
    the group, and return their results (picklable) in local-rank order.

    Each rank drives devices[i] (default: cuda:i, or the CPU), with
    torch.cuda.set_device. Without a coordinator, process count or id the
    ranks are the whole group, on a free localhost port. On CUDA the kernels
    are built here first, so the ranks load them and no rank runs nvcc. A
    rank that raises fails the launch; the others are terminated."""
    device = torch.device(device)
    if devices is None:
        devices = [torch.device("cuda", i) if device.type == "cuda" else device for i in range(n_local)]
    if len(devices) != n_local:
        raise ValueError(f"{len(devices)} devices for {n_local} ranks")
    if device.type == "cuda":
        from upnerf_torch.ops import _build

        _build.build()
    if coordinator_address is None and num_processes is None and process_id is None:
        coordinator_address, num_processes, process_id = f"127.0.0.1:{_free_port()}", 1, 0
    spec = dict(coordinator_address=coordinator_address, num_processes=num_processes, process_id=process_id,
                initialization_timeout=initialization_timeout)
    threads = max(1, torch.get_num_threads() // n_local)
    results = torch.multiprocessing.get_context("spawn").SimpleQueue()
    ctx = torch.multiprocessing.start_processes(_rank_main, args=(fn, args, spec, list(devices), threads, results),
                                                nprocs=n_local, join=False, start_method="spawn")
    out = {}

    def drain():
        while not results.empty():
            i, value = results.get()
            out[i] = value

    while not ctx.join(timeout=0.5):  # raises, and terminates the other ranks, when a rank fails
        drain()
    drain()
    return [out[i] for i in range(n_local)]


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def sync(name: str = "sync") -> None:
    """A barrier of every rank (a no-op for one). `name` labels the call site."""
    if is_multiprocess():
        dist.barrier()


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def put_replicated(tree: Any, mesh) -> Any:
    """Make every tensor of `tree` (a tensor, a module's parameters and
    buffers, or a dict / list / tuple of them) equal to rank 0's, in place, by
    a broadcast over the mesh; returns the tree. One rank: left as it is."""
    if mesh.size == 1:
        return tree
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.detach(), src=0, group=mesh.group)
    return tree


def put_local_shards(tree: Any, mesh) -> Any:
    """This rank's rows of a global batch (a tensor or a dict of them) on the
    mesh's device. The rows stay this rank's: global row i of a batch of B
    lives on rank i // (B / n), and `fetch(..., mesh)` gathers them back."""
    if isinstance(tree, dict):
        return {k: put_local_shards(v, mesh) for k, v in tree.items()}
    return torch.as_tensor(tree).to(mesh.device, non_blocking=True)


def all_gather_rows(x: torch.Tensor, mesh, n_chunks: int = 1) -> torch.Tensor:
    """Every rank's rows of x in global order, on x's device. x holds this
    rank's part of each of `n_chunks` equal chunks (`shard_batch` of each
    chunk, concatenated); the result puts each chunk's parts in rank order."""
    if mesh.size == 1:
        return x
    stage = x.is_cuda and dist.get_backend(mesh.group) == "gloo"
    src = (x.cpu() if stage else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts)  # (ranks, n_chunks * m, ...)
    out = out.reshape(mesh.size, n_chunks, -1, *x.shape[1:]).transpose(0, 1).reshape(-1, *x.shape[1:])
    return out.to(x.device) if stage else out


def fetch(tree: Any, mesh=None, n_chunks: int = 1) -> Any:
    """Tensors -> host numpy on every rank (bf16 as float32). With a mesh of
    several ranks each tensor holds this rank's rows and the result is every
    rank's (`all_gather_rows`); without one, a replicated tensor is copied as
    it is, so no duplicates are concatenated."""
    if isinstance(tree, dict):
        return {k: fetch(v, mesh, n_chunks) for k, v in tree.items()}
    x = tree.detach()
    if mesh is not None and mesh.size > 1:
        x = all_gather_rows(x, mesh, n_chunks)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The mean over the mesh's ranks of each tensor (JAX's pmean), in one
    collective over a flat buffer; new tensors, every rank the same bits."""
    tensors = list(tensors)
    if mesh.size == 1 or not tensors:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all_reduce_mean takes one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.size
    return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_grads(params: Sequence[torch.Tensor], mesh, extra: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Average every parameter's gradient over the mesh in place, with the
    `extra` tensors in the same collective; returns extra's means. A
    parameter without a gradient gets zeros first (as the optimizers step
    it), so every rank reduces the same buffer. One rank: left as they are."""
    if mesh.size == 1:
        return list(extra)
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    means = all_reduce_mean([p.grad for p in params] + list(extra), mesh)
    for p, g in zip(params, means):
        p.grad.copy_(g)
    return means[len(params):]


def assert_replicated(tree: Any, mesh, what: str = "state") -> None:
    """Raise unless every rank holds the same bytes in every tensor of `tree`
    (a digest of each rank's bytes, compared on every rank)."""
    if mesh.size == 1:
        return
    h = hashlib.sha256()
    for t in _tensors(tree):
        h.update(np.ascontiguousarray(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()).tobytes())
    digests: List[Optional[str]] = [None] * mesh.size
    dist.all_gather_object(digests, h.hexdigest())
    if len(set(digests)) != 1:
        differ = [r for r, d in enumerate(digests) if d != digests[0]]
        raise RuntimeError(f"the ranks' {what} differ: ranks {differ} against rank 0")

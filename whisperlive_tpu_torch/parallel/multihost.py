"""Multi-host worlds: data parallelism across hosts, tensor parallelism
inside one host.

Port of whisperlive_tpu/parallel/multihost.py. The JAX package runs one
process per host over a global mesh; here every rank of the [dp, tp] grid
is a process of its own (parallel/mesh.py), and a host runs `local_ranks`
of them. The same entry point serves one host and many: only the
rendezvous differs.

    WL_COORDINATOR   "host:port" of rank 0's rendezvous
    WL_NUM_PROCS     launched processes (one per host for the server CLI,
                     which spawns its host's local ranks itself; one per
                     rank for a script run once per rank)
    WL_PROC_ID       this process's index among them

Rank = WL_PROC_ID * local_ranks + local_rank. tp must divide local_ranks,
so the per-layer all-reduces of a tp group never leave a host; dp spans
hosts, where one gradient (training) or one status plane (serving) a step
crosses.

Usage (the same script on every rank):

    from whisperlive_tpu_torch.parallel import multihost
    multihost.init_multihost()            # or WL_COORDINATOR/... env vars
    sh = multihost.multihost_shardings(tp=2)
    state = training.init_train_state(cfg, opt, shardings=sh, ...)
    step = training.make_train_step(cfg, opt, shardings=sh)
    batch = {k: multihost.local_batch_to_global(v, sh) for k, v in global_batch.items()}
    state, loss = step(state, batch)      # the same loss on every rank
    multihost.save_checkpoint(path, state, cfg, sh)   # rank 0 writes
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from whisperlive_tpu_torch.parallel import mesh
from whisperlive_tpu_torch.parallel.mesh import EngineShardings

logger = logging.getLogger(__name__)

# ranks this process's host runs (set by init_multihost)
_LOCAL_RANKS = 1
# the backend and device init_multihost chose
_BACKEND: Optional[str] = None
_DEVICE: Optional[torch.device] = None


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
    local_ranks: int = 1,
    local_rank: int = 0,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join this process to the world as rank process_id * local_ranks +
    local_rank of num_processes * local_ranks. Arguments fall back to
    WL_COORDINATOR, WL_NUM_PROCS and WL_PROC_ID; a one-rank world (or no
    coordinator) is a no-op returning False, so the same entry point
    serves one card and many. The backend (NCCL, or gloo when ranks share
    a card or run on the CPU) is logged and read back with backend();
    timeout_s bounds a collective's wait for a missing rank."""
    global _LOCAL_RANKS, _BACKEND, _DEVICE
    coordinator = coordinator or os.environ.get("WL_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("WL_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("WL_PROC_ID", "0"))
    world = num_processes * local_ranks
    if not coordinator or world <= 1:
        return False
    rank = process_id * local_ranks + local_rank
    _BACKEND, _DEVICE = mesh.init_process_group(rank, world, coordinator, device,
                                                local_ranks, local_rank, timeout_s)
    _LOCAL_RANKS = local_ranks
    logger.info("multihost: rank %d/%d (process %d/%d, local rank %d/%d) via %s over %s",
                rank, world, process_id, num_processes, local_rank, local_ranks,
                coordinator, _BACKEND)
    return True


def backend() -> Optional[str]:
    """The backend init_multihost chose (None before it ran)."""
    return _BACKEND


def device() -> Optional[torch.device]:
    """This rank's device as init_multihost set it (None before it ran)."""
    return _DEVICE


def is_primary() -> bool:
    """True on the one rank that writes checkpoints and logs and serves."""
    return not dist.is_initialized() or dist.get_rank() == 0


def multihost_shardings(tp: int = 1, dp: Optional[int] = None) -> EngineShardings:
    """The [dp, tp] grid over every host's ranks with host-local tp
    groups: tp must divide the host's local rank count, or a tp group
    would run its per-layer all-reduces across hosts. dp defaults to
    world // tp and spans hosts."""
    if dist.is_initialized() and dist.get_world_size() > 1 and _LOCAL_RANKS % tp:
        raise ValueError(
            f"tp={tp} must divide the host's local rank count ({_LOCAL_RANKS}): a "
            "cross-host tp group would run per-layer collectives between hosts"
        )
    return mesh.make_mesh(tp=tp, dp=dp)


def local_batch_to_global(global_arr, shardings: EngineShardings) -> torch.Tensor:
    """This rank's shard of a global batch (axis 0 over the data group):
    rows [dp_index * b / dp, (dp_index + 1) * b / dp). The JAX function
    assembles a global array from per-host shards; here no rank ever holds
    more than its own shard, and the train step reduces the gradients of
    the data group."""
    arr = global_arr if isinstance(global_arr, torch.Tensor) else torch.as_tensor(
        np.asarray(global_arr))
    if arr.shape[0] % shardings.dp:
        raise ValueError(f"batch of {arr.shape[0]} does not divide dp={shardings.dp}")
    rows = shardings.owned_rows(arr.shape[0])
    return arr[rows.start:rows.stop]


def barrier(name: str = "wl") -> None:
    """Block until every rank reaches this point."""
    if dist.is_initialized():
        logger.debug("barrier %s", name)
        dist.barrier()


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """Device-to-host copy of a value replicated on every rank, gathered
    from all of them ([world, ...], the JAX process_allgather's shape)."""
    if not dist.is_initialized():
        return x.detach().cpu().numpy()[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts).cpu().numpy()


def save_checkpoint(path: str, state, cfg, shardings: EngineShardings) -> None:
    """Collective checkpoint: EVERY rank calls it with its state. The
    model groups gather their tp shards (parameters and both moments), the
    primary writes the training checkpoint format of training.py (one
    process loads it whole), and the call ends at a barrier so no rank
    reads a directory another is still writing."""
    from whisperlive_tpu_torch import training

    full = training.gather_state(state, shardings)
    if is_primary():
        training.save_checkpoint(path, full, cfg)
    barrier("ckpt-end")

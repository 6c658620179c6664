"""Multi-process runtime on torch.distributed, port of
`helmnet_tpu/distributed/multihost.py`.

The reference scales with PyTorch-Lightning DDP over NCCL (train.py:14-25);
the JAX package with `jax.distributed.initialize` and a mesh whose data
axis spans hosts. Here each process is one rank with one device, and the
process group is made explicitly:

    from helmnet_tpu_torch.distributed import multihost
    multihost.initialize(coordinator="10.0.0.1:8476", num_processes=2,
                         process_id=rank, device="cuda:0")
    mesh = make_mesh(ParallelConfig(data=2))   # one rank a card

The backend is NCCL for a card and gloo for the CPU. With no coordinator
the rendezvous comes from the environment (`env://`: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """`init_process_group` (idempotent): NCCL when `device` is a card
    (its default, `cuda`, made this process's current card), gloo for the
    CPU; at `tcp://coordinator` with the given world size and rank, or
    from the environment without a coordinator."""
    if is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints."""
    return process_index() == 0


def put_global(arr, sharding) -> torch.Tensor:
    """This rank's shard of a global host array, on the mesh's device.
    Every process passes the SAME full global array (replicated host data:
    the training loop's RNG is seeded alike on every process)."""
    return sharding(torch.as_tensor(arr)).contiguous().to(sharding.mesh.device)


def all_gather_dim(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The shards of `t` of the `n` ranks of `group`, concatenated along
    `dim` in group order."""
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out.movedim(0, dim)


def fetch_global(arr, sharding=None) -> np.ndarray:
    """Host copy of a global tensor, valid on every process: with its
    `sharding`, the shards are all-gathered along each split dimension
    first (the training loop's metric and write-back fetches)."""
    if not isinstance(arr, torch.Tensor):
        return np.asarray(arr)
    t = arr.detach()
    if sharding is not None:
        for dim, name in reversed(list(enumerate(sharding.spec))):
            if name is not None:
                t = all_gather_dim(t, sharding.mesh.group(name),
                                   sharding.mesh.size(name), dim)
    return t.cpu().numpy()


def barrier(name: str = "sync") -> None:
    """Wait for every process (a no-op for one process)."""
    if process_count() > 1:
        dist.barrier()

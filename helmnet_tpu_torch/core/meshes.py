"""Device meshes on torch.distributed, port of `helmnet_tpu/core/meshes.py`.

Axes convention (the JAX package's):
  data — data parallelism over the replay/eval batch (the reference's DDP)
  y, x — spatial domain decomposition of the grid's H and W axes
  z    — the 3D mesh's depth slabs (`make_mesh3d`, distributed/slab3d.py).

Where the JAX package lays devices out in a `jax.sharding.Mesh`, the port
lays out the ranks of the default process group, one device each, row-major
over the axes (rank = (d * ny + iy) * nx + ix), and makes one process group
per axis: the ranks that share every other coordinate. A collective over a
mesh axis (`psum`, `ppermute`, `all_to_all`, `psum_scatter` there) is the
torch collective over that axis's group (`all_reduce`, `batch_isend_irecv`,
`all_to_all_single`, `reduce_scatter_tensor`). The backend is the one the
process group was made with: NCCL on cards, gloo on the CPU
(distributed/multihost.initialize).

A tensor lives on each rank as its shard: `Sharding(mesh, spec)` (the
JAX package's `NamedSharding` with a `PartitionSpec`) names the mesh axis
that splits each leading dimension, and calling it on a global tensor
takes this rank's shard; `multihost.fetch_global` gathers the shards back.

Without an initialised process group the mesh is this process alone: one
rank, no groups, every axis of size 1, and every sharded function works
on the whole tensor.
"""

from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .config import ParallelConfig
from .device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A layout of ranks over named axes, with one process group per axis
    (None without a process group). `device` is this rank's device."""

    axis_names: tuple
    sizes: tuple
    rank: int
    groups: tuple  # per axis: the group of this rank's line along it, or None
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def size(self, name: str) -> int:
        """The number of ranks along axis `name` (`psum(1, name)`)."""
        return self.sizes[self._axis(name)]

    def coords(self) -> tuple:
        """This rank's mesh coordinates, row-major."""
        rank, out = self.rank, []
        for s in reversed(self.sizes):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def index(self, name: str) -> int:
        """This rank's coordinate along axis `name` (`axis_index`)."""
        return self.coords()[self._axis(name)]

    def group(self, name: str):
        return self.groups[self._axis(name)]

    def rank_at(self, coords) -> int:
        return _rank_of(coords, self.sizes)

    def neighbor(self, name: str, step: int) -> int:
        """The global rank `step` places along axis `name`, periodic."""
        a = self._axis(name)
        c = list(self.coords())
        c[a] = (c[a] + step) % self.sizes[a]
        return self.rank_at(c)


def _rank_of(coords, sizes) -> int:
    """The row-major rank at `coords` of a mesh of `sizes`."""
    rank = 0
    for c, s in zip(coords, sizes):
        rank = rank * s + c
    return rank


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device(device):
    """This rank's device: `device` if given; with NCCL the card of its
    local rank (LOCAL_RANK, else the rank modulo the card count); with
    gloo the CPU; without a process group `resolve_device()` (cuda)."""
    if device is not None:
        return resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            local = int(os.environ.get("LOCAL_RANK",
                                       dist.get_rank() % torch.cuda.device_count()))
            return resolve_device(f"cuda:{local}")
        return torch.device("cpu")
    return resolve_device(None)


def _build(names, sizes, device, ranks_per_host=None, data_axis="data") -> Mesh:
    rank, world = _world()
    n = math.prod(sizes)
    if n > world:
        raise ValueError(f"mesh needs {n} devices, only {world} available")
    if n < world:
        raise ValueError(
            f"a mesh of {n} devices on {world} ranks: every rank holds one "
            f"device of the mesh")
    if ranks_per_host is None:
        ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(world // max(ranks_per_host, 1), 1)
    data = sizes[names.index(data_axis)]
    if hosts > 1 and data % hosts:
        # the data axis strides across hosts, so the other axes' groups
        # stay within one host (the JAX package's hybrid mesh)
        raise ValueError(
            f"data axis ({data}) must be divisible by the process count "
            f"({hosts} hosts)")
    groups = [None] * len(sizes)
    if dist.is_available() and dist.is_initialized():
        # every rank makes every group, in one order
        for a in range(len(sizes)):
            others = [range(s) for i, s in enumerate(sizes) if i != a]
            for rest in itertools.product(*others):
                ranks = [_rank_of(rest[:a] + (c,) + rest[a:], sizes)
                         for c in range(sizes[a])]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[a] = g
    return Mesh(tuple(names), tuple(sizes), rank, tuple(groups),
                _default_device(device))


def make_mesh(parallel: Optional[ParallelConfig] = None, device=None,
              ranks_per_host: Optional[int] = None) -> Mesh:
    """The (data, y, x) mesh over the ranks of the default process group.

    Every rank of the group holds one device of the mesh. Across hosts
    (`ranks_per_host`, default LOCAL_WORLD_SIZE or the whole group) the
    data axis strides across them and y, x stay within each host, so the
    data axis must be divisible by the host count, as the JAX package
    requires it to be divisible by the process count."""
    parallel = parallel or ParallelConfig()
    return _build(("data", "y", "x"), (parallel.data, parallel.y, parallel.x),
                  device, ranks_per_host)


def make_mesh3d(data: int = 1, z: int = 1, device=None) -> Mesh:
    """(data, z) mesh for 3D z-slab decomposition (distributed/slab3d.py):
    H and W stay local, so the 3D mesh is batch x depth slabs."""
    return _build(("data", "z"), (data, z), device)


@dataclass(frozen=True)
class Sharding:
    """Which mesh axis splits each leading dimension of a tensor (None:
    not split; dimensions past `spec` are not split either). Calling it
    on a global tensor returns this rank's shard."""

    mesh: Mesh
    spec: tuple

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            n = self.mesh.size(name)
            if t.shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} ({t.shape[dim]}) is not divisible by "
                    f"mesh axis {name!r} ({n})")
            step = t.shape[dim] // n
            t = t.narrow(dim, self.mesh.index(name) * step, step)
        return t


def data_sharding(mesh: Mesh) -> Sharding:
    """Batch-axis sharding for [B, ...] tensors."""
    return Sharding(mesh, ("data",))


def spatial_sharding(mesh: Mesh) -> Sharding:
    """[B, H, W, C] tensors: batch over data, H over y, W over x."""
    return Sharding(mesh, ("data", "y", "x", None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def map_tree(fn, tree):
    """`fn` on every leaf of a tree of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Optional[Mesh], tree):
    """This rank's batch shard of every [B, ...] array of a tree, on the
    mesh's device. Every rank passes the full (replicated) batch."""
    if mesh is None:
        return tree
    from ..distributed.multihost import put_global

    s = data_sharding(mesh)
    return map_tree(lambda a: put_global(a, s), tree)

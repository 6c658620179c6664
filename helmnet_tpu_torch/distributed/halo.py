"""Spatial domain decomposition: halo exchange and sharded residual, port
of `helmnet_tpu/distributed/halo.py`.

The H x W grid is sharded over the mesh axes 'y' and 'x'
(core/meshes.spatial_sharding); a stencil needs r halo cells from each
neighbour, exchanged with `batch_isend_irecv` along the axis's group (the
JAX package's `ppermute`); residual norms reduce with `all_reduce` (its
`psum`). The wrap is periodic, the spectral operator's topology, and one
shard along an axis wraps locally.

Every function takes and returns this rank's shard: [B_loc, H_loc,
W_loc, 2] fields and [B_loc, H_loc, W_loc] k^2.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.meshes import Mesh, Sharding, map_tree
from ..ops.stencil import StencilPML, laplacian_stencil_local
from .multihost import put_global


def _halo_exchange_axis(block: torch.Tensor, radius: int, mesh: Mesh,
                        axis_name: str, axis: int) -> torch.Tensor:
    """`block` with `radius` cells of its neighbours' edges appended on
    both sides of `axis` (periodic ring along mesh axis `axis_name`)."""
    n = mesh.size(axis_name)
    lo = block.narrow(axis, 0, radius)
    hi = block.narrow(axis, block.shape[axis] - radius, radius)
    if n == 1:
        # single shard: periodic wrap is local
        return torch.cat([hi, block, lo], dim=axis)
    group = mesh.group(axis_name)
    right, left = mesh.neighbor(axis_name, 1), mesh.neighbor(axis_name, -1)
    from_left, from_right = torch.empty_like(hi), torch.empty_like(lo)
    # our high rows become the right neighbour's left halo and our low rows
    # the left neighbour's right halo; with two shards both neighbours are
    # one rank, and the tags (gloo) and the issue order (NCCL) pair them
    ops = [
        dist.P2POp(dist.isend, hi.contiguous(), right, group, tag=0),
        dist.P2POp(dist.isend, lo.contiguous(), left, group, tag=1),
        dist.P2POp(dist.irecv, from_left, left, group, tag=0),
        dist.P2POp(dist.irecv, from_right, right, group, tag=1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([from_left, block, from_right], dim=axis)


def _local_taps(table: torch.Tensor, mesh: Mesh, axis_name: str,
                n_local: int) -> torch.Tensor:
    """Slice a [2r+1, N] coefficient table to this shard's span."""
    return table.narrow(1, mesh.index(axis_name) * n_local, n_local)


def make_sharded_stencil_residual(mesh: Mesh, op: StencilPML):
    """Returns residual(u, k_sq, source) on (data, y, x) shards:
    r = L u + k^2 u - s from local data and 2r halo cells per axis, no
    all-gathers."""
    r = op.radius
    op = op.to(mesh.device)

    def residual(u, k_sq, src):
        h_loc, w_loc = u.shape[-3], u.shape[-2]
        cxr = _local_taps(op.cx_r, mesh, "x", w_loc)
        cxi = _local_taps(op.cx_i, mesh, "x", w_loc)
        cyr = _local_taps(op.cy_r, mesh, "y", h_loc)
        cyi = _local_taps(op.cy_i, mesh, "y", h_loc)
        padded = _halo_exchange_axis(u, r, mesh, "y", u.dim() - 3)
        padded = _halo_exchange_axis(padded, r, mesh, "x", u.dim() - 2)
        lap = laplacian_stencil_local(cxr, cxi, cyr, cyi, padded, r)
        return lap + k_sq[..., None] * u - src

    return residual


def all_reduce_axes(t: torch.Tensor, mesh: Mesh, names,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`psum` (with `op` MAX, `pmax`) over the named mesh axes, in place."""
    for name in names:
        group = mesh.group(name)
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
    return t


def make_sharded_residual_norm(mesh: Mesh):
    """Per-sample residual RMSE [B_loc] from (data, y, x) shards, with the
    sums all-reduced over the spatial shards."""

    def norm(res):
        s = all_reduce_axes(torch.sum(res**2, dim=(1, 2, 3)), mesh, ("y", "x"))
        count = res.shape[1] * res.shape[2] * res.shape[3]
        total = count * mesh.size("y") * mesh.size("x")
        return torch.sqrt(s / total)

    return norm


def spatial_put(mesh: Mesh, tree):
    """This rank's (data, y, x) shard of every [B, H, W, (C)] array."""

    def put(a):
        nd = a.ndim
        spec = {4: ("data", "y", "x", None), 3: ("data", "y", "x")}.get(nd, ("data",))
        return put_global(a, Sharding(mesh, spec))

    return map_tree(put, tree)

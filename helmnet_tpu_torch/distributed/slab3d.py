"""Distributed 3D spectral PML residual via z-slab decomposition, port of
`helmnet_tpu/distributed/slab3d.py`.

The 3D Laplacian is three per-axis dense complex matmuls
(ops/spectral3d.laplacian3d_matmul). Under a z-slab sharding ('data', 'z')
of [B, D, H, W, 2] fields:

  * the y- and x-axis matmuls contract over unsharded axes: fully local;
  * the z-axis matmul contracts over the sharded axis. Three methods:

    - 'transpose' (default): an all-to-all re-shards the field from
      z-slabs to y-slabs (full z becomes local), the z GEMM runs locally,
      and a second all-to-all transposes back. Traffic: 2 (d-1)/d of the
      local shard per apply.
    - 'scatter': each rank multiplies its slab by the matching column
      block of A_z, giving a full-depth partial sum, and one
      `reduce_scatter_tensor` both reduces and deals out the output slabs
      (the JAX package's `psum_scatter`). Traffic: (d-1)/d of the full
      field per apply, in one collective with no re-layout.
    - 'overlap': 'transpose' cut into `overlap_chunks` independent
      W-chunks, each chunk's all-to-all issued asynchronously so it runs
      under the GEMMs of the chunks before it.

Every function takes and returns this rank's shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.meshes import Mesh, Sharding, map_tree
from ..ops.spectral3d import SpectralPML3D, _complex_axis_matmul
from .dfft import all_to_all
from .halo import all_reduce_axes
from .multihost import put_global


def _reduce_scatter_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int):
    """`psum_scatter(t, axis, scatter_dimension=dim, tiled=True)`."""
    group = mesh.group(axis)
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // mesh.size(axis),) + tuple(src.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, src, group=group)
    return out.movedim(0, dim)


def make_sharded_residual3d(mesh: Mesh, op: SpectralPML3D, axis: str = "z",
                            method: str = "transpose", overlap_chunks: int = 4):
    """Returns residual(u, k_sq, source) for z-slab shards: u, source
    [B_loc, D / nz, H, W, 2], k_sq [B_loc, D / nz, H, W]. D and H must be
    divisible by the axis size; `method` picks the z-contraction's
    collective ('transpose', 'scatter' or 'overlap', above)."""
    if method not in ("transpose", "scatter", "overlap"):
        raise ValueError(f"unknown slab3d method {method!r}")
    op = op.to(mesh.device)
    spec = "dj,bjhwc->bdhwc"

    def lz_scatter(u):
        dz_loc = u.shape[1]
        start = mesh.index(axis) * dz_loc
        col = lambda m: m.narrow(1, start, dz_loc)
        # full-depth partial rows from the local slab's A_z columns ...
        lz_full = _complex_axis_matmul(col(op.az_r), col(op.az_i), u, spec)
        # ... one reduce-scatter sums the partials AND deals out row slabs
        return _reduce_scatter_dim(lz_full, mesh, axis, 1)

    def lz_transpose(u):
        # z-slabs -> y-slabs: [B, Dz_loc, H, W, 2] -> [B, D, H_loc, W, 2]
        t = all_to_all(u, mesh, axis, split_dim=2, concat_dim=1)
        lz_t = _complex_axis_matmul(op.az_r, op.az_i, t, spec)
        return all_to_all(lz_t, mesh, axis, split_dim=1, concat_dim=2)

    def lz_overlap(u):
        """W split into `overlap_chunks` chains of all-to-all -> GEMM ->
        all-to-all: every chunk's first all-to-all is issued at once, and
        each chunk's GEMM runs while the later chunks' transfers are in
        flight."""
        w = u.shape[3]
        nc = min(overlap_chunks, w)
        if w % nc:
            raise ValueError(f"W={w} not divisible by {nc} chunks")
        if w >= 512 and (w // nc) % 128:
            raise ValueError(f"W/chunks = {w // nc} breaks 128-lane alignment")
        step = w // nc
        there = [all_to_all(u.narrow(3, i * step, step), mesh, axis, 2, 1,
                            async_op=True)[1] for i in range(nc)]
        back = []
        for finish in there:
            lz_t = _complex_axis_matmul(op.az_r, op.az_i, finish(), spec)
            back.append(all_to_all(lz_t, mesh, axis, 1, 2, async_op=True)[1])
        return torch.cat([finish() for finish in back], dim=3)

    lz_fn = {"transpose": lz_transpose, "scatter": lz_scatter,
             "overlap": lz_overlap}[method]

    def residual(u, k_sq, src):
        lz = lz_fn(u)
        ly = _complex_axis_matmul(op.ay_r, op.ay_i, u, "hj,bdjwc->bdhwc")
        lx = _complex_axis_matmul(op.ax_r, op.ax_i, u, "wj,bdhjc->bdhwc")
        return lz + ly + lx + k_sq[..., None] * u - src

    return residual


def make_sharded_residual_norm3d(mesh: Mesh, axis: str = "z"):
    """Per-sample residual RMSE [B_loc] with the sums all-reduced over the
    slab axis."""

    def norm(res):
        s = all_reduce_axes(torch.sum(res**2, dim=(1, 2, 3, 4)), mesh, (axis,))
        count = res.shape[1] * res.shape[2] * res.shape[3] * res.shape[4]
        return torch.sqrt(s / (count * mesh.size(axis)))

    return norm


def slab_put(mesh: Mesh, tree, axis: str = "z"):
    """This rank's ('data', axis) shard of every [B, D, H, W, (2)] array."""

    def put(a):
        spec = {5: ("data", axis, None, None, None),
                4: ("data", axis, None, None)}.get(a.ndim, ("data",))
        return put_global(a, Sharding(mesh, spec))

    return map_tree(put, tree)

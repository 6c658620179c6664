"""Spatial partition of the UNet and of the operator over the mesh axes y
and x: the port's counterpart of what GSPMD does for the JAX package's
`Trainer(mesh=)` and sharded `rollout`.

Each rank holds the tile `[B, H/y, W/x, C]` of every field and, at UNet
level d, the tile `[B, H/(y 2^d), W/(x 2^d), C]` of every activation and
hidden state. The communication is explicit:

* a convolution's zero padding becomes a halo exchange (`Spatial.pad`):
  rows of the neighbouring tiles, zeros only at the true domain edge,
  then the same cuDNN call with padding 0. The exchange runs along y,
  then along x on the widened tile, so the corners arrive. A halo wider
  than a tile (the deep levels of a small grid) takes rows from as many
  tiles as it spans. Its backward is the adjoint: each halo's gradient
  goes back to the rank that owns those rows and is added there.
* the per-axis operator GEMMs (`laplacian_matmul`): `A_y u` contracts
  over H, so each rank all-gathers u along y and multiplies its own rows
  of `A_y`; `u A_x^T` likewise along x. The adjoint of the gather is a
  sum over the axis's ranks, of which each keeps its own slice.
* global means: local sums all-reduced over y and x (`Spatial.sum`).

A level must split evenly: H and W divisible by (y 2^depth) and
(x 2^depth). GSPMD pads a level that does not; the port refuses it with a
ValueError, before any step.

Communication is point to point along each axis's group
(`batch_isend_irecv`) and collectives on those groups: NCCL on cards,
gloo on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.meshes import Mesh
from .halo import all_reduce_axes
from .multihost import all_gather_dim


def halo_plan(i: int, n: int, t: int, lo: int, hi: int):
    """The messages of a halo of `lo` rows before and `hi` after each tile of
    `t` rows along an axis of `n` tiles, for the tile at index `i`. Returns
    (sends, recvs): sends (peer, first row of this tile, rows), recvs (peer,
    offset in the padded tile, rows). Halo rows outside the domain have no
    sender and stay zero."""
    sends, recvs = [], []
    for k in range(1, n):
        before = min(t, lo - (k - 1) * t)  # rows tile j + k needs from tile j
        after = min(t, hi - (k - 1) * t)  # rows tile j - k needs from tile j
        if before > 0:
            if i + k < n:
                sends.append((i + k, t - before, before))
            if i - k >= 0:
                recvs.append((i - k, lo - (k - 1) * t - before, before))
        if after > 0:
            if i - k >= 0:
                sends.append((i - k, 0, after))
            if i + k < n:
                recvs.append((i + k, lo + k * t, after))
    return sends, recvs


def _p2p(sends, recvs, group):
    """Post every send (global rank, tensor) and receive (global rank,
    buffer) at once and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, group) for peer, t in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, group) for peer, buf in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _AxisHalo(torch.autograd.Function):
    """Zero-padded halo of `lo` / `hi` rows along `dim`, filled from the
    tiles of the other ranks along one mesh axis."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi, axis):
        index, ranks, group = axis
        t = x.shape[dim]
        sends, recvs = halo_plan(index, len(ranks), t, lo, hi)
        ctx.meta = (dim, lo, t, sends, recvs, ranks, group)
        shape = list(x.shape)
        shape[dim] = lo + t + hi
        out = x.new_zeros(shape)
        out.narrow(dim, lo, t).copy_(x)
        bufs = [(off, x.new_empty(_rows(x.shape, dim, n))) for _, off, n in recvs]
        _p2p([(ranks[p], x.narrow(dim, s, n)) for p, s, n in sends],
             [(ranks[p], buf) for (p, _, _), (_, buf) in zip(recvs, bufs)], group)
        for off, buf in bufs:
            out.narrow(dim, off, buf.shape[dim]).copy_(buf)
        return out

    @staticmethod
    def backward(ctx, g):
        dim, lo, t, sends, recvs, ranks, group = ctx.meta
        gx = g.narrow(dim, lo, t).clone()
        bufs = [(s, g.new_empty(_rows(gx.shape, dim, n))) for _, s, n in sends]
        # each received halo's gradient goes back to its sender, which adds
        # it into the rows it sent
        _p2p([(ranks[p], g.narrow(dim, off, n)) for p, off, n in recvs],
             [(ranks[p], buf) for (p, _, _), (_, buf) in zip(sends, bufs)], group)
        for s, buf in bufs:
            gx.narrow(dim, s, buf.shape[dim]).add_(buf)
        return gx, None, None, None, None


def _rows(shape, dim, n):
    shape = list(shape)
    shape[dim] = n
    return shape


class _AxisGather(torch.autograd.Function):
    """All-gather along `dim` over one mesh axis; the backward sums the
    gathered tensor's gradient over the axis and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.meta = (dim, index, x.shape[dim], group)
        return all_gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        dim, index, t, group = ctx.meta
        g = g.contiguous()
        dist.all_reduce(g, group=group)
        return g.narrow(dim, index * t, t), None, None, None, None


class Spatial:
    """This rank's tile of an H x W grid split over the mesh axes y and x,
    and the communication that convolutions, the operator and global means
    need across tiles. `depth`: the UNet depth, whose levels must all split
    evenly."""

    def __init__(self, mesh: Mesh, height: int, width: int, depth: int):
        self.mesh = mesh
        self.ny, self.nx = mesh.size("y"), mesh.size("x")
        self.iy, self.ix = mesh.index("y"), mesh.index("x")
        self.height, self.width = height, width
        for name, size, n in (("H", height, self.ny), ("W", width, self.nx)):
            for d in range(depth + 1):
                level = size // 2**d
                if size % 2**d or level % n:
                    raise ValueError(
                        f"UNet level {d} of the {height}x{width} grid has "
                        f"{name} = {size / 2**d:g}, which does not split "
                        f"evenly over {n} ranks: the spatial partition needs "
                        f"{name} divisible by {n} * 2^{depth}")
        self.tile_h, self.tile_w = height // self.ny, width // self.nx
        coords = list(mesh.coords())
        self._axes = {}
        for name in ("y", "x"):
            a = mesh.axis_names.index(name)
            ranks = [mesh.rank_at(coords[:a] + [j] + coords[a + 1:])
                     for j in range(mesh.size(name))]
            self._axes[name] = (mesh.index(name), ranks, mesh.group(name))

    @property
    def rows(self) -> slice:
        """This rank's rows of the level-0 grid."""
        return slice(self.iy * self.tile_h, (self.iy + 1) * self.tile_h)

    @property
    def cols(self) -> slice:
        return slice(self.ix * self.tile_w, (self.ix + 1) * self.tile_w)

    def tile(self, t: torch.Tensor, hdim: int = 1) -> torch.Tensor:
        """This rank's tile of a global tensor whose H, W are dims `hdim`,
        `hdim` + 1 (at any level: the tile is the same fraction)."""
        h, w = t.shape[hdim] // self.ny, t.shape[hdim + 1] // self.nx
        return (t.narrow(hdim, self.iy * h, h)
                .narrow(hdim + 1, self.ix * w, w))

    def gather(self, t: torch.Tensor, hdim: int = 1) -> torch.Tensor:
        """The global tensor from every rank's tile (dims `hdim`, `hdim`+1),
        on every rank; no gradient."""
        t = all_gather_dim(t, self.mesh.group("x"), self.nx, hdim + 1)
        return all_gather_dim(t, self.mesh.group("y"), self.ny, hdim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the y and x ranks (a partial sum of each tile
        made global); no gradient."""
        return all_reduce_axes(t.detach().clone(), self.mesh, ("y", "x"))

    def pad(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """NHWC tile `x` with `lo` halo rows and columns before and `hi`
        after: the neighbouring tiles' cells, zeros beyond the domain."""
        if lo == 0 and hi == 0:
            return x
        for name, dim in (("y", 1), ("x", 2)):
            axis = self._axes[name]
            if len(axis[1]) == 1:
                pads = [0, 0] * (x.dim() - dim - 1) + [lo, hi]
                x = F.pad(x, pads)
            else:
                x = _AxisHalo.apply(x, dim, lo, hi, axis)
        return x

    def gather_axis(self, u: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        """All-gather `u` along `dim` over mesh axis `name`, with the
        adjoint (sum and slice) as its backward."""
        index, ranks, group = self._axes[name]
        if len(ranks) == 1:
            return u
        return _AxisGather.apply(u, dim, index, len(ranks), group)

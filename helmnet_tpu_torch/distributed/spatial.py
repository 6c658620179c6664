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
* the fft operator (`laplacian_fft`) transforms along one axis at a time
  on pencils (`Spatial.whole_along`): an all-to-all over the axis's group
  makes the axis whole on a slice of the other axis, the 1D transforms
  run there, and the inverse all-to-all goes back. Its backward is the
  inverse all-to-all. Where the other axis's tile does not split over
  the group, the axis is all-gathered instead and the rank keeps its own
  slice of the result. The pencil's function is told which part of the
  other axis's tile it holds, so that it can take the matching block of a
  table (the CSLP inverse's symbol, solvers/precond.py).
* global means and maxima: local sums (maxima) all-reduced over y and x
  (`Spatial.sum`, `Spatial.max`).

A UNet level whose H (or W) is not a multiple of the y (or x) axis size
runs whole along that axis on every rank of it, as does every deeper
level (`Spatial.level`): GSPMD pads such a level instead, and the
function computed is the same. The way in is an all-gather along the
axis (`Spatial.enter`, before the strided conv), whose adjoint sums the
ranks' gradients and keeps the rank's slice; the way out is the rank's
own slice of the transposed conv's output (`Spatial.leave`). The hidden
states of such levels are whole along that axis on each rank. Level 0,
the fields, must split evenly, and H and W must be multiples of 2^depth,
as the UNet needs on one device.

Communication is point to point along each axis's group
(`batch_isend_irecv`) and collectives on those groups: NCCL on cards,
gloo on the CPU.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.meshes import Mesh
from .dfft import all_to_all
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


class _AxisAllToAll(torch.autograd.Function):
    """`dfft.all_to_all` over one mesh axis: `x` cut into the axis's n
    blocks along `split`, block j sent to its j-th rank, the received
    blocks concatenated along `concat`; the backward is the inverse
    all-to-all (`concat` and `split` swapped)."""

    @staticmethod
    def forward(ctx, x, mesh, name, split, concat):
        ctx.meta = (mesh, name, split, concat)
        return all_to_all(x, mesh, name, split, concat)

    @staticmethod
    def backward(ctx, g):
        mesh, name, split, concat = ctx.meta
        return all_to_all(g, mesh, name, concat, split), None, None, None, None


class Spatial:
    """This rank's tile of an H x W grid split over the mesh axes y and x,
    and the communication that convolutions, the operator and global means
    need across tiles. `depth`: the UNet depth (0 for a network without
    levels); H and W must be multiples of 2^depth."""

    def __init__(self, mesh: Mesh, height: int, width: int, depth: int):
        self.mesh = mesh
        self.ny, self.nx = mesh.size("y"), mesh.size("x")
        self.iy, self.ix = mesh.index("y"), mesh.index("x")
        self.height, self.width = height, width
        for name, size, n in (("H", height, self.ny), ("W", width, self.nx)):
            if size % 2**depth:
                raise ValueError(
                    f"the {height}x{width} grid has {name} = {size}, not a "
                    f"multiple of 2^{depth}: the UNet's levels need it")
            if size % n:
                raise ValueError(
                    f"the {height}x{width} grid has {name} = {size}, which "
                    f"does not split evenly over {n} ranks")
        self.tile_h, self.tile_w = height // self.ny, width // self.nx
        coords = list(mesh.coords())
        self._axes = {}
        for name in ("y", "x"):
            a = mesh.axis_names.index(name)
            ranks = [mesh.rank_at(coords[:a] + [j] + coords[a + 1:])
                     for j in range(mesh.size(name))]
            self._axes[name] = (mesh.index(name), ranks, mesh.group(name))
        self._levels = {0: self}

    def level(self, d: int) -> "Spatial":
        """This partition at UNet level d (the grid halved d times): an
        axis whose level-d size is not a multiple of its rank count is
        whole there, on each of its ranks (no halo, no gather along it)."""
        if d not in self._levels:
            root = self._levels[0]
            v = copy.copy(root)
            v.height, v.width = root.height >> d, root.width >> d
            v._axes = dict(root._axes)
            for name, size in (("y", v.height), ("x", v.width)):
                if size % len(root._axes[name][1]):
                    v._axes[name] = (0, [self.mesh.rank], None)
            (v.iy, ranks_y, _), (v.ix, ranks_x, _) = v._axes["y"], v._axes["x"]
            v.ny, v.nx = len(ranks_y), len(ranks_x)
            v.tile_h, v.tile_w = v.height // v.ny, v.width // v.nx
            self._levels[d] = v
        return self._levels[d]

    def _whole_at(self, d: int):
        """The mesh axes split at level d - 1 and whole at level d, with
        their (H, W) dimension offset."""
        prev, cur = self.level(d - 1), self.level(d)
        return [(name, off) for off, name in enumerate(("y", "x"))
                if len(cur._axes[name][1]) < len(prev._axes[name][1])]

    def enter(self, t: torch.Tensor, d: int, hdim: int = 1) -> torch.Tensor:
        """A level d - 1 tile made the input of the conv into level d:
        all-gathered along each axis that is whole at level d."""
        prev = self.level(d - 1)
        for name, off in self._whole_at(d):
            t = prev.gather_axis(t, name, hdim + off)
        return t

    def leave(self, t: torch.Tensor, d: int, hdim: int = 1) -> torch.Tensor:
        """The level d - 1 output of a transposed conv run on level d's
        partition, cut to this rank's level d - 1 tile along each axis
        that is whole at level d."""
        prev = self.level(d - 1)
        for name, off in self._whole_at(d):
            size = (prev.tile_h, prev.tile_w)[off]
            t = t.narrow(hdim + off, prev._axes[name][0] * size, size)
        return t

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
        for name, dim in (("x", hdim + 1), ("y", hdim)):
            _, ranks, group = self._axes[name]
            t = all_gather_dim(t, group, len(ranks), dim)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the y and x ranks (a partial sum of each
        level-0 tile made global); no gradient."""
        return all_reduce_axes(t.detach().clone(), self.mesh, ("y", "x"))

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of `t` over the y and x ranks; no gradient."""
        return all_reduce_axes(t.detach().clone(), self.mesh, ("y", "x"),
                               dist.ReduceOp.MAX)

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

    def whole_along(self, u: torch.Tensor, name: str, dim: int, other: int, fn):
        """`fn(t, held)` applied to `u` made whole along `dim` (mesh axis
        `name`), and this rank's tile of its result: an all-to-all over the
        axis's group trades the split of `dim` for a split of `other`, and
        the inverse one comes back; both have their inverse as backward.
        When `other`'s tile does not split over the group, `u` is
        all-gathered along `dim` instead and the rank keeps its slice.
        `held` is the slice of this rank's tile along `other` that `t`
        holds. `fn` must keep the shape and act along `dim` only."""
        index, ranks, _ = self._axes[name]
        n, size = len(ranks), u.shape[other]
        if n == 1:
            return fn(u, slice(0, size))
        if size % n == 0:
            t = _AxisAllToAll.apply(u, self.mesh, name, other, dim)
            held = slice(index * size // n, (index + 1) * size // n)
            return _AxisAllToAll.apply(fn(t, held), self.mesh, name, dim, other)
        rows = u.shape[dim]
        return (fn(self.gather_axis(u, name, dim), slice(0, size))
                .narrow(dim, index * rows, rows))

"""Distributed spectral PML Laplacian via transpose-based FFTs, port of
`helmnet_tpu/distributed/dfft.py`.

Slab decomposition over the mesh 'y' axis:

  rows sharded -> fft along x is LOCAL
  -> all_to_all transposes the grid so full columns become local
  -> fft along y LOCAL, apply (ik, -k^2) multipliers + PML combine
  -> all_to_all back.

Two all-to-alls of the field (`all_to_all_single` over the y group) per
application, the textbook slab-FFT pattern. Fields are channel pairs at
the boundary; complex values exist only inside.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.meshes import Mesh
from ..ops.spectral import SpectralPML


def all_to_all(x: torch.Tensor, mesh: Mesh, axis_name: str, split_dim: int,
               concat_dim: int, async_op: bool = False):
    """`jax.lax.all_to_all(x, axis_name, split_dim, concat_dim, tiled=True)`:
    `x` cut into n blocks along `split_dim`, block j sent to the j-th rank
    of the axis, the blocks received concatenated along `concat_dim` in
    rank order. With `async_op`, returns (work, finish): `finish()` waits
    and returns the result."""
    group = mesh.group(axis_name)
    if group is None:
        return (None, lambda: x) if async_op else x
    n = mesh.size(axis_name)
    cplx = x.is_complex()
    src = torch.view_as_real(x) if cplx else x
    blocks = src.unflatten(split_dim, (n, src.shape[split_dim] // n))
    blocks = blocks.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(blocks)
    work = dist.all_to_all_single(out, blocks, group=group, async_op=async_op)

    def finish():
        if work is not None:
            work.wait()
        y = out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)
        return torch.view_as_complex(y.contiguous()) if cplx else y

    return (work, finish) if async_op else finish()


def make_sharded_laplacian_fft(mesh: Mesh, op: SpectralPML):
    """Returns lap(u) for u: [B_loc, H / ny, W, 2], rows sharded over 'y'.
    H and W must be divisible by the 'y' axis size."""
    op = op.to(mesh.device)
    cplx = lambda p: torch.complex(p[..., 0], p[..., 1])
    ikx = torch.complex(torch.zeros_like(op.kx), op.kx)
    iky = torch.complex(torch.zeros_like(op.ky), op.ky)[:, None]

    def lap(u):
        uc = torch.complex(u[..., 0], u[..., 1])
        # ---- x direction: fully local (rows are complete) ----
        fx = torch.fft.fft(uc, dim=-1)
        dx, ddx = torch.fft.ifft(torch.stack([ikx * fx, (ikx**2) * fx]), dim=-1)
        lx = cplx(op.ax1d) * dx + cplx(op.bx1d) * ddx
        # ---- y direction: transpose so full columns become local ----
        # [B, H_loc, W] -> [B, H, W / ny]
        t = all_to_all(uc, mesh, "y", split_dim=2, concat_dim=1)
        fy = torch.fft.fft(t, dim=-2)
        dy, ddy = torch.fft.ifft(torch.stack([iky * fy, (iky**2) * fy]), dim=-2)
        ly_full = cplx(op.ay1d)[:, None] * dy + cplx(op.by1d)[:, None] * ddy
        # back: [B, H, W / ny] -> [B, H_loc, W]
        ly = all_to_all(ly_full, mesh, "y", split_dim=1, concat_dim=2)
        out = lx + ly
        return torch.stack([out.real, out.imag], dim=-1)

    return lap


def make_sharded_residual_fft(mesh: Mesh, op: SpectralPML):
    """r = L u + k^2 u - s with the distributed-FFT Laplacian; every input
    sharded over ('data', 'y')."""
    lap = make_sharded_laplacian_fft(mesh, op)

    def residual(u, k_sq, source):
        return lap(u) + k_sq[..., None] * u - source

    return residual

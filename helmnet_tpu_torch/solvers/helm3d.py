"""3D Helmholtz GMRES front end, port of `helmnet_tpu/solvers/helm3d.py`.

The port's batched restarted GMRES (solvers/gmres.py: masked fixed-count
cycles, a true residual norm and a solution checkpoint after each) with
the 3D spectral PML operator (ops/spectral3d.py) and the 3D complex
shifted-Laplace preconditioner. The CSLP symbol is diagonal in Fourier
space in any dimension, so M^{-1} is one fftn, a pointwise divide and one
ifftn. `solve_helmholtz3d_batch` is one batched solve, where the JAX
package vmaps single solves: every Arnoldi step applies the operator to
the whole batch, and each problem is masked once it converges.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.device import resolve_device
from ..ops.spectral3d import SpectralPML3D, laplacian3d
from .gmres import GMRESResult, _on, _rhs, gmres_restarted_batch

_AXES = (-3, -2, -1)


def make_helmholtz_matvec3d(
    op: SpectralPML3D, k_sq: torch.Tensor, mode: str = "matmul"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Complex matvec u -> L u + k^2 u on [..., D, H, W] complex grids."""

    def mv(u: torch.Tensor) -> torch.Tensor:
        lap = laplacian3d(op, torch.view_as_real(u), mode)
        return torch.view_as_complex(lap.contiguous()) + k_sq.to(u.real.dtype) * u

    return mv


def make_shifted_laplace_inverse3d(
    op: SpectralPML3D,
    k_sq: torch.Tensor,
    shift: Tuple[float, float] = (1.0, 0.5),
    kref: str = "mean",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact inverse of M = nabla^2 + (b1 + i b2) kref^2 via fftn/ifftn.
    `k_sq` [..., D, H, W] sets each problem's kref^2 (its mean, or with
    kref='max' its max, over the last three axes)."""
    b1, b2 = shift
    if kref == "mean":
        kref2 = k_sq.mean(dim=_AXES, keepdim=True)
    else:
        kref2 = k_sq.amax(dim=_AXES, keepdim=True)
    sym = -(op.kz[:, None, None] ** 2 + op.ky[None, :, None] ** 2
            + op.kx[None, None, :] ** 2)
    re = sym + b1 * kref2
    denom = torch.complex(re, (b2 * kref2).expand_as(re))

    def minv(v: torch.Tensor) -> torch.Tensor:
        return torch.fft.ifftn(torch.fft.fftn(v, dim=_AXES) / denom, dim=_AXES)

    return minv


def _solve3d(op, k_sq, b, *, mode="matmul", restart=20, max_restarts=50,
             tol=1e-10, precond="none", shift=(1.0, 0.5)) -> GMRESResult:
    """Batched GMRES on b [B, D, H, W] complex; complex fields in the result."""
    if precond not in ("none", "shifted_laplace"):
        raise ValueError(f"unknown precond {precond!r} (use 'none' or "
                         f"'shifted_laplace')")
    mv = make_helmholtz_matvec3d(op, k_sq, mode)
    opts = dict(restart=restart, max_restarts=max_restarts, tol=tol)
    if precond == "none":
        return gmres_restarted_batch(mv, b, **opts)
    minv = make_shifted_laplace_inverse3d(op, k_sq, shift)
    res = gmres_restarted_batch(lambda v: mv(minv(v)), b, **opts)
    # right preconditioning: x = M^-1 y, per problem and per cycle
    cps = minv(res.checkpoints.transpose(0, 1)).transpose(0, 1)
    return res._replace(x=minv(res.x), checkpoints=cps)


def solve_helmholtz3d(
    op: SpectralPML3D,
    k_sq,
    source,
    *,
    mode: str = "matmul",
    restart: int = 20,
    max_restarts: int = 50,
    tol: float = 1e-10,
    precond: str = "none",
    shift: tuple = (1.0, 0.5),
    device=None,
) -> GMRESResult:
    """Solve (L + k^2) u = s for one 3D problem.

    k_sq: [D, H, W] real; source: [D, H, W, 2] channel pair (or complex
    [D, H, W]). Returns channel-pair fields x [D, H, W, 2] and checkpoints
    [max_restarts, D, H, W, 2]. precond='shifted_laplace' right-
    preconditions with the 3D CSLP; the residual norms stay TRUE residuals
    of the original system. Runs on the card unless `device` says otherwise."""
    dev = resolve_device(device)
    op = op.to(dev)
    k_sq = _on(k_sq, dev, torch.float32)
    b = _rhs(source, dev, batched=False, dims=3)[None]
    res = _solve3d(op, k_sq, b, mode=mode, restart=restart, max_restarts=max_restarts,
                   tol=tol, precond=precond, shift=shift)
    return GMRESResult(torch.view_as_real(res.x[0]), res.residual_norms[0],
                       torch.view_as_real(res.checkpoints[0]), res.iterations[0])


def solve_helmholtz3d_batch(op: SpectralPML3D, k_sq_batch, source_batch,
                            **kw) -> GMRESResult:
    """A batch of 3D problems as one batched solve: k_sq_batch
    [B, D, H, W], source_batch [B, D, H, W, 2]. The same fields as the JAX
    package's vmap of `solve_helmholtz3d`: x [B, D, H, W, 2],
    residual_norms [B, max_restarts + 1], checkpoints
    [B, max_restarts, D, H, W, 2], iterations [B]."""
    dev = resolve_device(kw.pop("device", None))
    op = op.to(dev)
    k_sq = _on(k_sq_batch, dev, torch.float32)
    res = _solve3d(op, k_sq, _rhs(source_batch, dev, batched=True, dims=3), **kw)
    return res._replace(x=torch.view_as_real(res.x),
                        checkpoints=torch.view_as_real(res.checkpoints))

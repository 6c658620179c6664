"""Preconditioning for the Helmholtz GMRES solver, port of
`helmnet_tpu/solvers/precond.py`: the complex shifted-Laplace
preconditioner (CSLP) and mixed-precision iterative refinement.

The constant-coefficient shifted operator

    M = nabla^2 + (b1 + i b2) kref^2,     (b1, b2) = (1, 0.5) default,

is diagonal in Fourier space, so M^{-1} v is one fft2, one pointwise
divide and one ifft2. GMRES applies it as a RIGHT preconditioner (solve
A M^{-1} y = b, x = M^{-1} y), so its residual norms stay the true
residuals of the original system.

On a grid split over the mesh axes y and x (`spatial=`, a
distributed/spatial.Spatial), kref^2 is the whole grid's mean or max,
completed over the ranks, and the 2D transform runs one axis at a time on
pencils, as `laplacian_fft(..., spatial=)` does: the fft along x on
x-pencils; on y-pencils the fft along y, the divide by the symbol's block
of (ky, kx) that the pencil holds, and the ifft along y; the ifft along x
on x-pencils. The symbol does not separate into an x and a y part, so the
divide runs where a rank holds every ky of a known set of kx.

Mixed-precision iterative refinement (`solve_helmholtz_refined`) reaches
the MATLAB script's tol 1e-10 with an f32 inner solver: the outer loop
keeps the iterate and the defect r = b - A x in float64 numpy on the host
(`_HostOperator`, the dense per-axis operators in complex128), the inner
GMRES solves A d = r / ||r|| in complex64 on the device, and x += d in
float64. The defect crosses to the device as complex64 (each of re and im
rounded to f32, as the JAX package's f32 channel pair rounds them) and the
correction comes back as f32 pairs, widened to float64.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.spectral import SpectralPML, axis_operator


def reference_k2(k_sq: torch.Tensor, kref: str = "mean", spatial=None) -> torch.Tensor:
    """kref^2 of each problem, [..., 1, 1]: mean(k_sq) ('mean') or max(k_sq)
    ('max') over its last two axes. With `spatial`, `k_sq` is this rank's
    tile and kref^2 is the whole grid's (the mean summed in float64)."""
    if spatial is None:
        if kref == "mean":
            return k_sq.mean(dim=(-2, -1), keepdim=True)
        return k_sq.amax(dim=(-2, -1), keepdim=True)
    if kref == "mean":
        total = spatial.sum(k_sq.sum(dim=(-2, -1), keepdim=True, dtype=torch.float64))
        return (total / (spatial.height * spatial.width)).to(k_sq.dtype)
    return spatial.max(k_sq.amax(dim=(-2, -1), keepdim=True))


def _denominator(ky, kx, kref2, b1: float, b2: float) -> torch.Tensor:
    """The symbol of M on the ky x kx block: -(ky^2 + kx^2) (the Fourier
    symbol of nabla^2) + (b1 + i b2) kref^2."""
    re = -(ky[:, None] ** 2 + kx[None, :] ** 2) + b1 * kref2
    return torch.complex(re, (b2 * kref2).expand_as(re))


def make_shifted_laplace_inverse(
    op: SpectralPML,
    k_sq: torch.Tensor,
    shift: Tuple[float, float] = (1.0, 0.5),
    kref: str = "mean",
    spatial=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact inverse of M = nabla^2 + (b1 + i b2) kref^2 via fft2/ifft2.

    `k_sq` [..., H, W] real sets the reference wavenumber of each problem
    (`reference_k2`): kref^2 = mean(k_sq) ('mean', robust default for sos
    in [1, 2]) or max(k_sq) ('max'). Returns a closure mapping complex
    [..., H, W] -> complex [..., H, W]. With `spatial`, `k_sq` and what
    the closure maps are this rank's tiles [..., H/y, W/x] (module
    docstring)."""
    b1, b2 = shift
    kref2 = reference_k2(k_sq, kref, spatial)
    if spatial is None:
        denom = _denominator(op.ky, op.kx, kref2, b1, b2)

        def minv(v: torch.Tensor) -> torch.Tensor:
            return torch.fft.ifft2(torch.fft.fft2(v) / denom)

        return minv

    kx = op.kx[spatial.cols]

    def along_x(transform):
        return lambda p, _held: torch.view_as_real(
            transform(torch.view_as_complex(p.contiguous()), dim=-1))

    def along_y(p, held):
        denom = _denominator(op.ky, kx[held], kref2, b1, b2)
        f = torch.fft.fft(torch.view_as_complex(p.contiguous()), dim=-2)
        return torch.view_as_real(torch.fft.ifft(f / denom, dim=-2))

    def minv(v: torch.Tensor) -> torch.Tensor:
        # the exchanges move channel pairs, as laplacian_fft's do
        p = torch.view_as_real(v)
        hd, wd = p.dim() - 3, p.dim() - 2
        p = spatial.whole_along(p, "x", wd, hd, along_x(torch.fft.fft))
        p = spatial.whole_along(p, "y", hd, wd, along_y)
        p = spatial.whole_along(p, "x", wd, hd, along_x(torch.fft.ifft))
        return torch.view_as_complex(p.contiguous())

    return minv


class _HostOperator:
    """float64 host-side application of the PML Helmholtz operator: the
    dense per-axis complex matrices of the matmul path
    (ops/spectral.axis_operator) kept in complex128."""

    def __init__(self, height, width, pml_size, sigma_max, k0, k_sq):
        self.Ax = axis_operator(width, pml_size, sigma_max, k0)  # [W, W] c128
        self.Ay = axis_operator(height, pml_size, sigma_max, k0)  # [H, H]
        self.k_sq = np.asarray(k_sq, np.float64)

    def __call__(self, u: np.ndarray) -> np.ndarray:
        u = np.asarray(u, np.complex128)
        return self.Ay @ u + u @ self.Ax.T + self.k_sq * u


def solve_helmholtz_refined(
    op: SpectralPML,
    geometry,
    k0: float,
    k_sq,
    source,
    *,
    tol: float = 1e-10,
    max_outer: int = 8,
    inner_restart: int = 50,
    inner_max_restarts: int = 20,
    inner_tol: float = 1e-7,
    precond: str = "shifted_laplace",
    mode: str = "auto",
    device=None,
):
    """Solve (L + k^2) u = s to `tol` RELATIVE residual in float64.

    Returns (x complex128 [H, W] numpy, outer residual norms list). The
    inner f32 correction solves run on the card unless `device` says
    otherwise; only the [H, W] defect and correction cross per outer
    iteration."""
    from .gmres import solve_helmholtz

    h, w = op.height, op.width
    host_op = _HostOperator(h, w, geometry.pml_size, geometry.sigma_max, k0, k_sq)
    b = np.asarray(source)
    if b.ndim == 3 and b.shape[-1] == 2:
        b = b[..., 0].astype(np.complex128) + 1j * b[..., 1]
    else:
        b = np.asarray(b, np.complex128)
    bnorm = np.linalg.norm(b)
    k_sq32 = np.asarray(k_sq, np.float32)

    x = np.zeros((h, w), np.complex128)
    r = b.copy()
    norms = [float(np.linalg.norm(r))]
    for _ in range(max_outer):
        if norms[-1] <= tol * bnorm:
            break
        # scale the defect to O(1) so the f32 inner solve keeps relative
        # accuracy however small the residual has become
        scale = np.linalg.norm(r)
        res = solve_helmholtz(
            op, k_sq32, (r / scale).astype(np.complex64), mode=mode,
            restart=inner_restart, max_restarts=inner_max_restarts,
            tol=inner_tol, precond=precond, device=device,
        )
        d_pair = res.x.cpu().numpy().astype(np.float64)
        x = x + (d_pair[..., 0] + 1j * d_pair[..., 1]) * scale
        r = b - host_op(x)
        norms.append(float(np.linalg.norm(r)))
    return x, norms

"""Preconditioning for the Helmholtz GMRES solver, port of
`helmnet_tpu/solvers/precond.py`: the complex shifted-Laplace
preconditioner (CSLP) and mixed-precision iterative refinement.

The constant-coefficient shifted operator

    M = nabla^2 + (b1 + i b2) kref^2,     (b1, b2) = (1, 0.5) default,

is diagonal in Fourier space, so M^{-1} v is one fft2, one pointwise
divide and one ifft2. GMRES applies it as a RIGHT preconditioner (solve
A M^{-1} y = b, x = M^{-1} y), so its residual norms stay the true
residuals of the original system.

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


def make_shifted_laplace_inverse(
    op: SpectralPML,
    k_sq: torch.Tensor,
    shift: Tuple[float, float] = (1.0, 0.5),
    kref: str = "mean",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact inverse of M = nabla^2 + (b1 + i b2) kref^2 via fft2/ifft2.

    `k_sq` [..., H, W] real sets the reference wavenumber of each problem:
    kref^2 = mean(k_sq) ('mean', robust default for sos in [1, 2]) or
    max(k_sq) ('max'), over its last two axes. Returns a closure mapping
    complex [..., H, W] -> complex [..., H, W]."""
    b1, b2 = shift
    if kref == "mean":
        kref2 = k_sq.mean(dim=(-2, -1), keepdim=True)
    else:
        kref2 = k_sq.amax(dim=(-2, -1), keepdim=True)
    # -(kx^2 + ky^2) is the Fourier symbol of nabla^2
    sym = -(op.ky[:, None] ** 2 + op.kx[None, :] ** 2)
    re = sym + b1 * kref2
    denom = torch.complex(re, (b2 * kref2).expand_as(re))

    def minv(v: torch.Tensor) -> torch.Tensor:
        return torch.fft.ifft2(torch.fft.fft2(v) / denom)

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

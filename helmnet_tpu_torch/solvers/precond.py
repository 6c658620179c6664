"""Preconditioning for the Helmholtz GMRES solver, port of the first half
of `helmnet_tpu/solvers/precond.py`: the complex shifted-Laplace
preconditioner (CSLP).

The constant-coefficient shifted operator

    M = nabla^2 + (b1 + i b2) kref^2,     (b1, b2) = (1, 0.5) default,

is diagonal in Fourier space, so M^{-1} v is one fft2, one pointwise
divide and one ifft2. GMRES applies it as a RIGHT preconditioner (solve
A M^{-1} y = b, x = M^{-1} y), so its residual norms stay the true
residuals of the original system.

The mixed-precision iterative refinement of the JAX module
(`_HostOperator`, `solve_helmholtz_refined`) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.spectral import SpectralPML


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

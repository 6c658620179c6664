"""The PML-modified Helmholtz operator, worked out from its definition.

Along each axis the PML Laplacian is L_1d u = a u' + b u'' with
gamma = 1 + (i/k0) sigma, a = -gamma'/gamma^3, b = 1/gamma^2 and the
quadratic profile sigma = sigma_max (1 - j/P)^2 in the P cells at each
end. The spectral derivatives are written with the explicit DFT matrix
F[j, m] = exp(-2 pi i j m / n): D1 = F^-1 diag(i k) F and
D2 = F^-1 diag(-k^2) F, k the angular wavenumbers in FFT order. The
operator on a grid is the sum over axes of A_axis applied along it, and
the residual is r = L u + k^2 u - s, all in complex channel pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from .rounding import product_out, round_to


def sigma(n: int, pml: int, sigma_max: float) -> tuple[np.ndarray, np.ndarray]:
    """The profile and its derivative along one axis of n cells (float64)."""
    s, ds = np.zeros(n), np.zeros(n)
    if pml:
        j = np.arange(pml)
        s[:pml] = sigma_max * (1.0 - j / pml) ** 2
        s[n - pml:] = s[:pml][::-1]
        ds[:pml] = -2.0 * sigma_max * (1.0 - j / pml) / pml
        ds[n - pml:] = -ds[:pml][::-1]
    return s, ds


def axis_matrix(n: int, pml: int, sigma_max: float, k0: float) -> np.ndarray:
    """A = diag(a) D1 + diag(b) D2, complex128 [n, n]."""
    s, ds = sigma(n, pml, sigma_max)
    gamma = 1.0 + 1j * s / k0
    a = -(1j * ds / k0) / gamma**3
    b = 1.0 / gamma**2
    idx = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(idx, idx) / n)
    inv = np.conj(dft) / n
    m = np.where(idx <= (n - 1) // 2, idx, idx - n)  # FFT order
    k = 2.0 * np.pi * m / n
    d1 = inv @ np.diag(1j * k) @ dft
    d2 = inv @ np.diag(-(k**2)) @ dft
    return a[:, None] * d1 + b[:, None] * d2


class Operator:
    """The dense axis operators of an `ndim`-D grid, real and imaginary
    parts in f32 on `device`, and the sigma input channels."""

    def __init__(self, shape, pml: int, sigma_max: float, k0: float, device):
        self.shape = tuple(shape)
        mats = [axis_matrix(n, pml, sigma_max, k0) for n in self.shape]
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        self.mats = [(f32(m.real), f32(m.imag)) for m in mats]
        # sigma channels in the order (sigma_x, sigma_y[, sigma_z]): the last
        # grid axis first
        nd = len(self.shape)
        chans = []
        for axis in reversed(range(nd)):
            prof = sigma(self.shape[axis], pml, sigma_max)[0]
            view = [1] * nd
            view[axis] = -1
            chans.append(np.broadcast_to(prof.reshape(view), self.shape))
        self.sigmas = f32(np.stack(chans))  # [nd, *grid]

    def laplacian(self, u: torch.Tensor, precision: str = "f32") -> torch.Tensor:
        """L u for u [B, *grid, 2] (re, im)."""
        rnd = lambda t: round_to(t, precision)
        ur, ui = rnd(u[..., 0]), rnd(u[..., 1])
        out_r = torch.zeros_like(ur)
        out_i = torch.zeros_like(ui)
        for axis, (mr, mi) in enumerate(self.mats):
            mr, mi = rnd(mr), rnd(mi)
            dim = 1 + axis  # the grid axis in [B, *grid]
            # move the axis last, apply M along it, move it back
            vr, vi = ur.movedim(dim, -1), ui.movedim(dim, -1)
            mm = lambda a, m: product_out(a @ m.T, precision)
            pr = mm(vr, mr) - mm(vi, mi)
            pi = mm(vr, mi) + mm(vi, mr)
            out_r = out_r + pr.movedim(-1, dim)
            out_i = out_i + pi.movedim(-1, dim)
        return torch.stack([out_r, out_i], dim=-1)

    def residual(self, u, k_sq, source, precision: str = "f32") -> torch.Tensor:
        return self.laplacian(u, precision) + k_sq[..., None] * u - source


def rmse(residual: torch.Tensor) -> torch.Tensor:
    """Per-sample root mean square over every other axis."""
    return torch.sqrt(torch.mean(residual**2, dim=tuple(range(1, residual.dim()))))

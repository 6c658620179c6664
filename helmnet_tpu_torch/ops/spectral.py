"""Spectral Helmholtz operator with PML, in PyTorch.

Port of `helmnet_tpu/ops/spectral.py`. The operator is separable and its
PML coefficients depend only on the coordinate of their own axis:

    L u = a_x(x) du/dx + b_x(x) d2u/dx2 + a_y(y) du/dy + b_y(y) d2u/dy2

so each axis collapses to one dense [N, N] complex matrix

    A = diag(a) . D1 + diag(b) . D2,   D1 = F^-1 diag(ik) F,  D2 = F^-1 diag(-k^2) F

and the operator is two matmuls: L u = A_y @ u + u @ A_x^T, each a split
re/im complex product of real f32 matrices. The JAX package runs them at
HIGHEST precision; here they are `torch.matmul` in full f32 (TF32 off on
the card, core/device.py). The FFT mode uses 1D transforms only, for very
large grids and as a cross-check.

Wavefields are channel pairs `[..., H, W, 2]` (re/im, NHWC).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from .pml import pml_coefficients_1d, sigma_maps


def wavenumbers(n: int) -> np.ndarray:
    """1D angular wavenumbers in FFT order: 2*pi*fftfreq(n) (float64)."""
    return 2.0 * np.pi * np.fft.fftfreq(n)


def dft_derivative_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense spectral derivative matrices (complex128 [n, n]).

    D1 = F^-1 diag(ik) F   (first derivative)
    D2 = F^-1 diag(-k^2) F (second derivative)
    """
    k = wavenumbers(n)
    eye = np.eye(n)
    F = np.fft.fft(eye, axis=0)
    D1 = np.fft.ifft((1j * k)[:, None] * F, axis=0)
    D2 = np.fft.ifft((-(k**2))[:, None] * F, axis=0)
    return D1, D2


def axis_operator(n: int, pml_size: int, sigma_max: float, k0: float) -> np.ndarray:
    """Dense 1D PML-modified Laplacian A = diag(a) D1 + diag(b) D2 (complex128)."""
    a, b = pml_coefficients_1d(n, pml_size, sigma_max, k0)
    D1, D2 = dft_derivative_matrices(n)
    return a[:, None] * D1 + b[:, None] * D2


class SpectralPML(NamedTuple):
    """Precomputed operator tensors, real f32 on one device.

    Matmul mode reads the split re/im dense matrices; fft mode reads the
    wavenumbers and the split PML coefficient vectors. Built with
    `make_operator(dense=False)`, the dense fields are [0, 0] placeholders.
    """

    ay_r: torch.Tensor  # [H, H]
    ay_i: torch.Tensor
    ax_r: torch.Tensor  # [W, W]
    ax_i: torch.Tensor
    kx: torch.Tensor  # [W]
    ky: torch.Tensor  # [H]
    ax1d: torch.Tensor  # [W, 2] (re, im)
    bx1d: torch.Tensor
    ay1d: torch.Tensor  # [H, 2]
    by1d: torch.Tensor
    # network input channels [2, H, W] (sigma_x, sigma_y)
    sigmas: torch.Tensor

    @property
    def height(self) -> int:
        return self.ky.shape[0]

    @property
    def width(self) -> int:
        return self.kx.shape[0]

    @property
    def has_dense(self) -> bool:
        return self.ay_r.numel() > 0

    def to(self, device) -> "SpectralPML":
        return SpectralPML(*(t.to(device) for t in self))


def make_operator(
    height: int,
    width: int,
    pml_size: int,
    sigma_max: float,
    k0: float,
    dtype=torch.float32,
    dense: bool = True,
    device=None,
) -> SpectralPML:
    """Build the operator tensors for an HxW grid (numpy f64 precompute)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    if dense:
        Ax = axis_operator(width, pml_size, sigma_max, k0)
        Ay = axis_operator(height, pml_size, sigma_max, k0)
        dense_tables = dict(ay_r=t(Ay.real), ay_i=t(Ay.imag),
                            ax_r=t(Ax.real), ax_i=t(Ax.imag))
    else:
        empty = torch.zeros((0, 0), dtype=dtype, device=dev)
        dense_tables = dict(ay_r=empty, ay_i=empty, ax_r=empty, ax_i=empty)
    ax1d, bx1d = pml_coefficients_1d(width, pml_size, sigma_max, k0)
    ay1d, by1d = pml_coefficients_1d(height, pml_size, sigma_max, k0)
    sx, sy = sigma_maps(height, width, pml_size, sigma_max)
    pair = lambda c: t(np.stack([c.real, c.imag], -1))
    return SpectralPML(
        **dense_tables,
        kx=t(wavenumbers(width)),
        ky=t(wavenumbers(height)),
        ax1d=pair(ax1d),
        bx1d=pair(bx1d),
        ay1d=pair(ay1d),
        by1d=pair(by1d),
        sigmas=t(np.stack([sx, sy])),
    )


# ---------------------------------------------------------------------------
# Laplacian application
# ---------------------------------------------------------------------------


def _complex_matmul_left(m_r, m_i, u):
    """(M_r + i M_i) [R, H] applied along axis -3 of channel-pair u
    [..., H, W, 2]; [..., R, W, 2]."""
    flat = u.reshape(*u.shape[:-2], -1)  # [..., H, W*2]
    shape = u.shape[:-3] + (m_r.shape[0],) + u.shape[-2:]
    pr = torch.matmul(m_r, flat).reshape(shape)
    pi = torch.matmul(m_i, flat).reshape(shape)
    re = pr[..., 0] - pi[..., 1]
    im = pr[..., 1] + pi[..., 0]
    return torch.stack([re, im], dim=-1)


def _complex_matmul_right(m_r, m_i, u):
    """(M_r + i M_i) [R, W] applied along axis -2 of channel-pair u
    [..., H, W, 2]; [..., H, R, 2]."""
    ut = u.transpose(-1, -2)  # [..., H, 2, W]
    pr = torch.matmul(ut, m_r.T)
    pi = torch.matmul(ut, m_i.T)
    re = pr[..., 0, :] - pi[..., 1, :]
    im = pr[..., 1, :] + pi[..., 0, :]
    return torch.stack([re, im], dim=-1)


def laplacian_matmul(op: SpectralPML, u: torch.Tensor, spatial=None) -> torch.Tensor:
    """PML Laplacian via two dense complex matmuls. u: [..., H, W, 2], or
    with `spatial` (distributed/spatial.Spatial) this rank's tile of it:
    u is all-gathered along the contracted axis, and each rank multiplies
    its own rows of A_y and A_x."""
    if spatial is None:
        lx = _complex_matmul_right(op.ax_r, op.ax_i, u)
        ly = _complex_matmul_left(op.ay_r, op.ay_i, u)
        return lx + ly
    rows, cols = spatial.rows, spatial.cols
    ux = spatial.gather_axis(u, "x", u.dim() - 2)
    uy = spatial.gather_axis(u, "y", u.dim() - 3)
    lx = _complex_matmul_right(op.ax_r[cols], op.ax_i[cols], ux)
    ly = _complex_matmul_left(op.ay_r[rows], op.ay_i[rows], uy)
    return lx + ly


def _cplx(p: torch.Tensor) -> torch.Tensor:
    return torch.complex(p[..., 0], p[..., 1])


def _fft_term(uc: torch.Tensor, k, a, b, dim: int) -> torch.Tensor:
    """a du/dz + b d2u/dz2 along `dim` (-1: x, -2: y) of complex uc, whole
    along it, by one fft and two iffts; k, a, b are the axis's wavenumbers
    and PML coefficient pairs."""
    col = (lambda t: t[:, None]) if dim == -2 else (lambda t: t)
    ik = torch.complex(torch.zeros_like(k), k)
    f = torch.fft.fft(uc, dim=dim)
    d1, d2 = torch.fft.ifft(torch.stack([col(ik) * f, col(ik**2) * f]), dim=dim)
    return col(_cplx(a)) * d1 + col(_cplx(b)) * d2


def laplacian_fft(op: SpectralPML, u: torch.Tensor, spatial=None) -> torch.Tensor:
    """PML Laplacian via 1D FFTs: fft_x, two ifft_x, fft_y, two ifft_y.
    With `spatial` (distributed/spatial.Spatial), u is this rank's tile and
    each axis's transforms run on pencils whole along it
    (`Spatial.whole_along`); autograd runs through the exchanges."""
    x = (op.kx, op.ax1d, op.bx1d, -1)
    y = (op.ky, op.ay1d, op.by1d, -2)
    if spatial is None:
        uc = _cplx(u)
        out = _fft_term(uc, *x) + _fft_term(uc, *y)
        return torch.stack([out.real, out.imag], dim=-1)

    def term(axis):
        def fn(p, _held):
            t = _fft_term(_cplx(p), *axis)
            return torch.stack([t.real, t.imag], dim=-1)
        return fn

    hd, wd = u.dim() - 3, u.dim() - 2
    return (spatial.whole_along(u, "x", wd, hd, term(x))
            + spatial.whole_along(u, "y", hd, wd, term(y)))


# The JAX package's crossover: the O(N^3) matmul operator below 1024^2,
# the O(N^2 log N) fft mode from there up.
AUTO_FFT_MIN_SIZE = 1024


def resolve_mode(mode: str, height: int, width: int) -> str:
    """Resolve operator_mode='auto' to a concrete mode for an HxW grid."""
    if mode != "auto":
        return mode
    return "fft" if max(height, width) >= AUTO_FFT_MIN_SIZE else "matmul"


def laplacian(op: SpectralPML, u: torch.Tensor, mode: str = "matmul",
              spatial=None) -> torch.Tensor:
    """`spatial`: u is this rank's tile of a grid split over the mesh axes
    y and x (distributed/spatial.py); 'auto' resolves on the whole grid."""
    if mode == "auto" and not op.has_dense:
        mode = "fft"  # a dense-free operator only carries the fft tables
    mode = resolve_mode(mode, u.shape[-3] * (spatial.ny if spatial else 1),
                        u.shape[-2] * (spatial.nx if spatial else 1))
    if mode == "matmul":
        if not op.has_dense:
            raise ValueError(
                "operator was built with make_operator(dense=False); "
                "matmul mode needs the dense per-axis tables — rebuild with "
                "dense=True or use mode='fft'"
            )
        return laplacian_matmul(op, u, spatial)
    elif mode == "fft":
        return laplacian_fft(op, u, spatial)
    raise ValueError(f"unknown operator mode {mode!r}")


def helmholtz_residual(
    op: SpectralPML,
    u: torch.Tensor,
    k_sq: torch.Tensor,
    source: torch.Tensor,
    mode: str = "matmul",
    spatial=None,
) -> torch.Tensor:
    """r = L u + k^2 u - s.

    u, source: [..., H, W, 2]; k_sq: [..., H, W] (real, broadcast over re/im);
    with `spatial`, this rank's tiles of them (`laplacian`).
    """
    return laplacian(op, u, mode, spatial) + k_sq[..., None] * u - source


# ---------------------------------------------------------------------------
# Dense assembly (for GMRES cross-checks and small-system direct solves)
# ---------------------------------------------------------------------------


def assemble_dense(
    height: int, width: int, pml_size: int, sigma_max: float, k0: float,
    k_sq: np.ndarray | None = None,
) -> np.ndarray:
    """The full dense complex128 system matrix on the host (numpy).

    Row-major vectorization u.reshape(H*W): M = kron(Ay, I_W) + kron(I_H, Ax)
    [+ diag(k_sq.ravel()) if k_sq given], the construction the reference's
    MATLAB script assembles from sparse krons. Only for small grids
    (O((HW)^2) memory)."""
    Ax = axis_operator(width, pml_size, sigma_max, k0)
    Ay = axis_operator(height, pml_size, sigma_max, k0)
    M = np.kron(Ay, np.eye(width)) + np.kron(np.eye(height), Ax)
    if k_sq is not None:
        M = M + np.diag(np.asarray(k_sq, np.complex128).ravel())
    return M

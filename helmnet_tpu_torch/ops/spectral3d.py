"""3D spectral Helmholtz operator with PML, port of
`helmnet_tpu/ops/spectral3d.py`.

The PML-modified Laplacian is separable in 3D as in 2D (ops/spectral.py):

    L u = sum_axis  a(x_i) du/dx_i + b(x_i) d2u/dx_i2,

so each axis collapses to one dense [N, N] complex matrix
A = diag(a) D1 + diag(b) D2, and the operator is three complex axis
products (`torch.einsum`, f32; TF32 is off on the card, core/device.py)
over a `[..., D, H, W, 2]` channel-pair field. The FFT mode (nine 1D
transform passes in complex64) is the cross-check. 'auto' resolves to the
matmul mode at every size, as in the JAX package.

Volumes are NDHWC channel pairs `[..., D, H, W, 2]`; sos maps `[..., D, H, W]`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from .pml import pml_coefficients_1d, sigma_profile
from .spectral import axis_operator, wavenumbers


class SpectralPML3D(NamedTuple):
    """Precomputed 3D operator tensors, real f32 on one device."""

    # dense per-axis operators, split re/im
    az_r: torch.Tensor  # [D, D]
    az_i: torch.Tensor
    ay_r: torch.Tensor  # [H, H]
    ay_i: torch.Tensor
    ax_r: torch.Tensor  # [W, W]
    ax_i: torch.Tensor
    # fft-mode data: wavenumbers and split PML coefficient vectors
    kz: torch.Tensor  # [D]
    ky: torch.Tensor  # [H]
    kx: torch.Tensor  # [W]
    az1d: torch.Tensor  # [D, 2] (re, im)
    bz1d: torch.Tensor
    ay1d: torch.Tensor  # [H, 2]
    by1d: torch.Tensor
    ax1d: torch.Tensor  # [W, 2]
    bx1d: torch.Tensor
    # network input channels [3, D, H, W] (sigma_x, sigma_y, sigma_z)
    sigmas: torch.Tensor

    @property
    def depth(self) -> int:
        return self.kz.shape[0]

    @property
    def height(self) -> int:
        return self.ky.shape[0]

    @property
    def width(self) -> int:
        return self.kx.shape[0]

    def to(self, device) -> "SpectralPML3D":
        return SpectralPML3D(*(t.to(device) for t in self))


def sigma_maps_3d(
    depth: int, height: int, width: int, pml_size: int, sigma_max: float
) -> np.ndarray:
    """[3, D, H, W] float32 (sigma_x, sigma_y, sigma_z) absorption maps."""
    sx = sigma_profile(width, pml_size, sigma_max)
    sy = sigma_profile(height, pml_size, sigma_max)
    sz = sigma_profile(depth, pml_size, sigma_max)
    shape = (depth, height, width)
    return np.stack([
        np.broadcast_to(sx[None, None, :], shape),
        np.broadcast_to(sy[None, :, None], shape),
        np.broadcast_to(sz[:, None, None], shape),
    ]).astype(np.float32)


def make_operator3d(
    depth: int,
    height: int,
    width: int,
    pml_size: int,
    sigma_max: float,
    k0: float,
    dtype=torch.float32,
    device=None,
) -> SpectralPML3D:
    """Build the operator tensors for a DxHxW grid (numpy f64 precompute)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    pair = lambda c: t(np.stack([c.real, c.imag], -1))
    Az = axis_operator(depth, pml_size, sigma_max, k0)
    Ay = axis_operator(height, pml_size, sigma_max, k0)
    Ax = axis_operator(width, pml_size, sigma_max, k0)
    az1d, bz1d = pml_coefficients_1d(depth, pml_size, sigma_max, k0)
    ay1d, by1d = pml_coefficients_1d(height, pml_size, sigma_max, k0)
    ax1d, bx1d = pml_coefficients_1d(width, pml_size, sigma_max, k0)
    return SpectralPML3D(
        az_r=t(Az.real), az_i=t(Az.imag),
        ay_r=t(Ay.real), ay_i=t(Ay.imag),
        ax_r=t(Ax.real), ax_i=t(Ax.imag),
        kz=t(wavenumbers(depth)), ky=t(wavenumbers(height)),
        kx=t(wavenumbers(width)),
        az1d=pair(az1d), bz1d=pair(bz1d),
        ay1d=pair(ay1d), by1d=pair(by1d),
        ax1d=pair(ax1d), bx1d=pair(bx1d),
        sigmas=t(sigma_maps_3d(depth, height, width, pml_size, sigma_max)),
    )


# ---------------------------------------------------------------------------
# Laplacian application
# ---------------------------------------------------------------------------


def _complex_axis_matmul(m_r, m_i, u, spec: str):
    """(M_r + i M_i) applied along one grid axis of channel-pair u."""
    pr = torch.einsum(spec, m_r, u)
    pi = torch.einsum(spec, m_i, u)
    re = pr[..., 0] - pi[..., 1]
    im = pr[..., 1] + pi[..., 0]
    return torch.stack([re, im], dim=-1)


def laplacian3d_matmul(op: SpectralPML3D, u: torch.Tensor) -> torch.Tensor:
    """PML Laplacian via three dense complex axis products. u: [..., D, H, W, 2]."""
    lz = _complex_axis_matmul(op.az_r, op.az_i, u, "dj,...jhwc->...dhwc")
    ly = _complex_axis_matmul(op.ay_r, op.ay_i, u, "hj,...djwc->...dhwc")
    lx = _complex_axis_matmul(op.ax_r, op.ax_i, u, "wj,...dhjc->...dhwc")
    return lz + ly + lx


def laplacian3d_fft(op: SpectralPML3D, u: torch.Tensor) -> torch.Tensor:
    """PML Laplacian via 1D FFTs in complex64: per axis one fft and one
    batched ifft of the stacked (d, d2) pair, nine passes in all."""
    uc = torch.complex(u[..., 0], u[..., 1])
    cplx = lambda p: torch.complex(p[..., 0], p[..., 1])

    def axis_term(k, a1d, b1d, axis):
        shape = [1] * uc.dim()
        shape[axis] = k.shape[0]
        ik = torch.complex(torch.zeros_like(k), k).reshape(shape)
        f = torch.fft.fft(uc, dim=axis)
        d, dd = torch.fft.ifft(torch.stack([ik * f, (ik**2) * f]), dim=axis)
        return cplx(a1d).reshape(shape) * d + cplx(b1d).reshape(shape) * dd

    out = (axis_term(op.kx, op.ax1d, op.bx1d, -1)
           + axis_term(op.ky, op.ay1d, op.by1d, -2)
           + axis_term(op.kz, op.az1d, op.bz1d, -3))
    return torch.stack([out.real, out.imag], dim=-1)


def laplacian3d(op: SpectralPML3D, u: torch.Tensor, mode: str = "matmul") -> torch.Tensor:
    # 'auto' is the matmul mode at every size, as in the JAX package (its
    # 3D crossover was not reached at any size it measured)
    if mode in ("auto", "matmul"):
        return laplacian3d_matmul(op, u)
    if mode == "fft":
        return laplacian3d_fft(op, u)
    raise ValueError(f"unknown operator mode {mode!r}")


def helmholtz_residual3d(
    op: SpectralPML3D,
    u: torch.Tensor,
    k_sq: torch.Tensor,
    source: torch.Tensor,
    mode: str = "matmul",
) -> torch.Tensor:
    """r = L u + k^2 u - s on [..., D, H, W, 2] channel pairs."""
    return laplacian3d(op, u, mode) + k_sq[..., None] * u - source


# ---------------------------------------------------------------------------
# Dense assembly (tiny-grid cross-checks only) and point sources (numpy)
# ---------------------------------------------------------------------------


def assemble_dense3d(
    depth: int,
    height: int,
    width: int,
    pml_size: int,
    sigma_max: float,
    k0: float,
    k_sq: np.ndarray | None = None,
) -> np.ndarray:
    """Dense complex128 system matrix for u.reshape(D*H*W) (row-major):

        M = kron(Az, I_H x I_W) + kron(I_D, kron(Ay, I_W)) + kron(I_DH, Ax)

    [+ diag(k_sq.ravel())]. O((DHW)^2) memory: tests only."""
    Az = axis_operator(depth, pml_size, sigma_max, k0)
    Ay = axis_operator(height, pml_size, sigma_max, k0)
    Ax = axis_operator(width, pml_size, sigma_max, k0)
    M = (np.kron(Az, np.eye(height * width))
         + np.kron(np.eye(depth), np.kron(Ay, np.eye(width)))
         + np.kron(np.eye(depth * height), Ax))
    if k_sq is not None:
        M = M + np.diag(np.asarray(k_sq, np.complex128).ravel())
    return M


def point_source_map3d(
    depth: int,
    height: int,
    width: int,
    location: tuple[int, int, int],
    amplitude: float = 1.0,
    phase: float = 0.0,
    omega: float = 1.0,
    t: float = 0.0,
) -> np.ndarray:
    """Complex 3D point source as channel-pair float32 [D, H, W, 2]."""
    z, r, c = (int(v) for v in location)
    if not (0 <= z < depth and 0 <= r < height and 0 <= c < width):
        raise ValueError(
            f"source location {location} outside the {depth}x{height}x{width} grid"
        )
    amp = np.zeros((depth, height, width), dtype=np.float64)
    amp[z, r, c] = amplitude
    val = amp * np.exp(1j * (omega * t + phase))
    return np.stack([val.real, val.imag], axis=-1).astype(np.float32)

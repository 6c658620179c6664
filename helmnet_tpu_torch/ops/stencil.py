"""Finite-difference stencil form of the PML Helmholtz operator, in
PyTorch. Port of `helmnet_tpu/ops/stencil.py`.

Central finite differences of order 2 (3 taps per axis) or 4 (5 taps per
axis), with periodic wrap to match the spectral operator's topology:

    L u = a_x(x) D1_x u + b_x(x) D2_x u + a_y(y) D1_y u + b_y(y) D2_y u

Per axis this is a (2r+1)-tap stencil whose complex coefficients
c_t(x) = a(x) d1[t] + b(x) d2[t] vary only along that axis, kept as
[2r+1, N] tables split re/im. With `off = t - r` and periodic indices:

    (L u)[y, x] = sum_t cx[t, x] u[y, x + off] + cy[t, y] u[y + off, x]

(complex products), which is `jnp.roll(u, -off)` in the JAX package and
`torch.roll(u, -off)` here. The tables are built in float64 numpy and cast
to f32, as the JAX package does, so they are the same bits.

Wavefields are channel pairs `[..., H, W, 2]`. The fused residual
`r = L u + k^2 u - s` as a CUDA kernel, and the operator's sparse and
banded forms, are in ops/stencil_residual.py.

A note on the JAX package's users of this operator: its GMRES stencil path
(`helmnet_tpu/solvers/gmres.py:135`) calls the XLA `laplacian_stencil`
below, not the Pallas kernels of `ops/pallas_stencil.py`, whatever that
module's docstring says; the port's GMRES runs the CUDA kernel on the card
(solvers/gmres.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device
from .pml import pml_coefficients_1d, sigma_maps

# central-difference weights (unit spacing): offsets [-r..r]
_D1 = {
    2: np.array([-0.5, 0.0, 0.5]),
    4: np.array([1 / 12, -8 / 12, 0.0, 8 / 12, -1 / 12]),
}
_D2 = {
    2: np.array([1.0, -2.0, 1.0]),
    4: np.array([-1 / 12, 16 / 12, -30 / 12, 16 / 12, -1 / 12]),
}


@dataclass(frozen=True, eq=False)
class StencilPML:
    """Per-axis complex tap tables, split re/im, f32 on one device.

    `cache` holds what is derived from the tables once per operator (the
    banded x-tap matrices of ops/stencil_residual.banded_matrices); it is
    not carried over by `.to` to another device."""

    cx_r: torch.Tensor  # [2r+1, W]
    cx_i: torch.Tensor
    cy_r: torch.Tensor  # [2r+1, H]
    cy_i: torch.Tensor
    sigmas: torch.Tensor  # [2, H, W] network input channels
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def radius(self) -> int:
        return (self.cx_r.shape[0] - 1) // 2

    @property
    def height(self) -> int:
        return self.cy_r.shape[1]

    @property
    def width(self) -> int:
        return self.cx_r.shape[1]

    @property
    def device(self) -> torch.device:
        return self.cx_r.device

    def tables(self) -> tuple:
        return (self.cx_r, self.cx_i, self.cy_r, self.cy_i, self.sigmas)

    def to(self, device) -> "StencilPML":
        device = torch.device(device)
        if self.device == device or (device.index is None
                                     and self.device.type == device.type):
            return self
        return StencilPML(*(t.to(device) for t in self.tables()))


def _axis_taps(n: int, pml: int, sigma_max: float, k0: float, order: int):
    a, b = pml_coefficients_1d(n, pml, sigma_max, k0)
    d1, d2 = _D1[order], _D2[order]
    return a[None, :] * d1[:, None] + b[None, :] * d2[:, None]  # [2r+1, n]


def make_stencil_operator(
    height: int,
    width: int,
    pml_size: int,
    sigma_max: float,
    k0: float,
    order: int = 4,
    dtype=torch.float32,
    device=None,
) -> StencilPML:
    if order not in _D1:
        raise ValueError(f"unsupported stencil order {order} (use 2 or 4)")
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    tx = _axis_taps(width, pml_size, sigma_max, k0, order)
    ty = _axis_taps(height, pml_size, sigma_max, k0, order)
    sx, sy = sigma_maps(height, width, pml_size, sigma_max)
    return StencilPML(
        cx_r=t(tx.real), cx_i=t(tx.imag), cy_r=t(ty.real), cy_i=t(ty.imag),
        sigmas=t(np.stack([sx, sy])),
    )


def _cmul_taps(c_r, c_i, u):
    """(c_r + i c_i) * u for channel-pair u; c broadcastable to u[..., 0]."""
    re = c_r * u[..., 0] - c_i * u[..., 1]
    im = c_r * u[..., 1] + c_i * u[..., 0]
    return torch.stack([re, im], dim=-1)


def laplacian_stencil(op: StencilPML, u: torch.Tensor) -> torch.Tensor:
    """Periodic stencil Laplacian. u: [..., H, W, 2]."""
    r = op.radius
    out = torch.zeros_like(u)
    for t in range(2 * r + 1):
        off = t - r
        # x axis (last spatial): coefficient varies along W
        ux = torch.roll(u, -off, dims=-2)
        out = out + _cmul_taps(op.cx_r[t], op.cx_i[t], ux)
        # y axis: coefficient varies along H -> broadcast over W
        uy = torch.roll(u, -off, dims=-3)
        out = out + _cmul_taps(op.cy_r[t][:, None], op.cy_i[t][:, None], uy)
    return out


def helmholtz_residual_stencil(
    op: StencilPML, u: torch.Tensor, k_sq: torch.Tensor, source: torch.Tensor
) -> torch.Tensor:
    """r = L u + k^2 u - s with the stencil operator."""
    return laplacian_stencil(op, u) + k_sq[..., None] * u - source


def laplacian_stencil_local(
    cx_r, cx_i, cy_r, cy_i, u_padded: torch.Tensor, radius: int
) -> torch.Tensor:
    """Stencil on a halo-padded block. u_padded: [..., H+2r, W+2r, 2];
    coefficient tables [2r+1, W] / [2r+1, H] for the OUTPUT block (the
    building block of a domain-decomposed residual)."""
    r = radius
    h = u_padded.shape[-3] - 2 * r
    w = u_padded.shape[-2] - 2 * r
    out = None
    for t in range(2 * r + 1):
        sx = u_padded[..., r : r + h, t : t + w, :]
        sy = u_padded[..., t : t + h, r : r + w, :]
        term = _cmul_taps(cx_r[t], cx_i[t], sx) + _cmul_taps(
            cy_r[t][:, None], cy_i[t][:, None], sy
        )
        out = term if out is None else out + term
    return out

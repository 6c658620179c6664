"""PML (perfectly matched layer) absorption profiles and coefficients.

Quadratic sigma profile as in the reference (helmnet/spectral.py:298-338) and
Bermudez et al. 2007. The modified 1D Laplacian along an axis is

    L_1d u = a(x) u' + b(x) u''      with  a = -gamma'/gamma^3,  b = 1/gamma^2,
    gamma(x) = 1 + (i/k0) sigma(x)

where sigma is nonzero only inside the PML bands of width `pml_size` at both
ends of the axis. All profiles here are 1D; the 2D maps are outer broadcasts
(sigma_x varies along the LAST grid axis, sigma_y along the second-to-last,
matching the reference layout where grids are [batch, y, x]).

The port's own copy of `helmnet_tpu/ops/pml.py` (numpy only).
"""

from __future__ import annotations

import numpy as np


def sigma_profile(n: int, pml_size: int, sigma_max: float) -> np.ndarray:
    """Quadratic absorption profile sigma(x) of length n (float64).

    Matches reference helmnet/spectral.py:306-311: sigma_max * (1 - j/P)^2 for
    j in [0, P) at the low end, mirrored at the high end.
    """
    _validate_pml(n, pml_size)
    sigma = np.zeros(n, dtype=np.float64)
    if pml_size == 0:
        return sigma
    j = np.arange(pml_size)
    outer = sigma_max * np.abs(1.0 - j / pml_size) ** 2
    sigma[:pml_size] = outer
    sigma[-pml_size:] = outer[::-1]
    return sigma


def _validate_pml(n: int, pml_size: int) -> None:
    if pml_size < 0:
        raise ValueError(f"pml_size must be >= 0, got {pml_size}")
    if 2 * pml_size > n:
        raise ValueError(
            f"PML bands overlap: 2*pml_size={2*pml_size} > grid size {n}"
        )


def sigma_prime_profile(n: int, pml_size: int, sigma_max: float) -> np.ndarray:
    """d(sigma)/dx of the quadratic profile (helmnet/spectral.py:322-328)."""
    _validate_pml(n, pml_size)
    sp = np.zeros(n, dtype=np.float64)
    if pml_size == 0:
        return sp
    j = np.arange(pml_size)
    prime = -2.0 * sigma_max * (1.0 - j / pml_size) / pml_size
    sp[:pml_size] = prime
    sp[-pml_size:] = -prime[::-1]
    return sp


def gamma_1d(n: int, pml_size: int, sigma_max: float, k0: float) -> np.ndarray:
    """gamma(x) = 1 + (i/k0) sigma(x), complex128 [n]."""
    return 1.0 + (1j / k0) * sigma_profile(n, pml_size, sigma_max)


def pml_coefficients_1d(
    n: int, pml_size: int, sigma_max: float, k0: float
) -> tuple[np.ndarray, np.ndarray]:
    """Coefficients (a, b) of the modified Laplacian L = a u' + b u''.

    a = -gamma'/gamma^3 and b = 1/gamma^2 with gamma' = (i/k0) sigma'
    (helmnet/spectral.py:330-338). Complex128 arrays of shape [n].
    """
    inv_gamma = 1.0 / gamma_1d(n, pml_size, sigma_max, k0)
    gamma_prime = (1j / k0) * sigma_prime_profile(n, pml_size, sigma_max)
    a = -gamma_prime * inv_gamma**3
    b = inv_gamma**2
    return a, b


def sigma_maps(
    height: int, width: int, pml_size: int, sigma_max: float
) -> tuple[np.ndarray, np.ndarray]:
    """2D (sigma_x, sigma_y) maps of shape [height, width], float32.

    sigma_x varies along the last (x) axis, sigma_y along the first (y) axis —
    same convention as np.meshgrid(sigma, sigma) in the reference
    (helmnet/spectral.py:312-314). These are fed to the network as the two
    extra input channels.
    """
    sx = sigma_profile(width, pml_size, sigma_max)
    sy = sigma_profile(height, pml_size, sigma_max)
    sigma_x = np.broadcast_to(sx[None, :], (height, width)).astype(np.float32)
    sigma_y = np.broadcast_to(sy[:, None], (height, width)).astype(np.float32)
    return sigma_x, sigma_y

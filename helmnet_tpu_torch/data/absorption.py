"""Power-law absorption parameter fitting (k-Wave compatibility); the
port's own copy of `helmnet_tpu/data/absorption.py` (numpy only).

Counterpart of matlab/fitPowerLawParamsMulti.m (used by the skull pipeline,
skull2medium.m:449-467, to set medium.alpha_coeff for the time-domain
ground-truth run). The fractional-Laplacian wave equation solved by k-Wave
exhibits second-order deviations from the desired power law
a = a0 * f^y at high absorption/frequency (Treeby & Cox, JASA 136(4), 2014,
Eq. 40), and supports only a single global exponent y_ref; this module
computes the prefactor a0_fit to request so the *actual* absorption at the
reference frequency matches the desired power law.

All functions are plain numpy over arrays (element-wise, any shape); units
follow the k-Wave conventions: a0 in dB/(MHz^y cm), c0 in m/s, f in Hz.
"""

from __future__ import annotations

import numpy as np

_NEPER_DB = 20.0 * np.log10(np.e)  # dB per neper


def db2neper(alpha: np.ndarray, y) -> np.ndarray:
    """dB/(MHz^y cm) -> Np/((rad/s)^y m) (k-Wave convention)."""
    alpha = np.asarray(alpha, np.float64)
    y = np.asarray(y, np.float64)
    return 100.0 * alpha * (1e-6 / (2.0 * np.pi)) ** y / _NEPER_DB


def neper2db(alpha: np.ndarray, y) -> np.ndarray:
    """Np/((rad/s)^y m) -> dB/(MHz^y cm) (inverse of db2neper)."""
    alpha = np.asarray(alpha, np.float64)
    y = np.asarray(y, np.float64)
    return _NEPER_DB * alpha / (100.0 * (1e-6 / (2.0 * np.pi)) ** y)


def absorbed_power_law(a0_np, y_ref, c0, w):
    """Actual absorption [Np/m] of the fractional-Laplacian equation run
    with prefactor `a0_np` (Np/((rad/s)^y_ref m)) and exponent y_ref at
    angular frequency w — the second-order model being corrected for
    (Treeby & Cox 2014, Eq. 40)."""
    a0_np = np.asarray(a0_np, np.float64)
    c0 = np.asarray(c0, np.float64)
    return (
        a0_np * w**y_ref
        / (1.0 - (y_ref + 1.0) * a0_np * c0 * np.tan(np.pi * y_ref / 2.0)
           * w ** (y_ref - 1.0))
    )


def fit_power_law_params(
    a0: np.ndarray,
    y: np.ndarray,
    c0: np.ndarray,
    f_ref: float,
    y_ref: float,
) -> np.ndarray:
    """Prefactor a0_fit [dB/(MHz^y_ref cm)] to pass to the simulation so the
    actual absorption at f_ref equals the desired a0 * f^y.

    Mirrors fitPowerLawParamsMulti.m: invert Eq. 40 at w = 2*pi*f_ref for
    the element-wise desired absorption. y_ref must not be 1 (tan(pi/2)
    singularity of the fractional-Laplacian dispersion relation).
    """
    y = np.asarray(y, np.float64)
    if np.any(y < 0) or np.any(y > 3):
        raise ValueError("power-law exponent y must be in [0, 3]")
    if y_ref == 1:
        raise ValueError("y_ref cannot be 1")
    w = 2.0 * np.pi * float(f_ref)
    desired = db2neper(a0, y) * w**y  # Np/m at f_ref
    c0 = np.asarray(c0, np.float64)
    a0_fit_np = desired / (
        w**y_ref
        + desired * (y_ref + 1.0) * c0 * np.tan(np.pi * y_ref / 2.0)
        * w ** (y_ref - 1.0)
    )
    return neper2db(a0_fit_np, y_ref)

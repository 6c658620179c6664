"""Transcranial skull pipeline: CT (Hounsfield) -> acoustic medium; the
port's own copy of `helmnet_tpu/data/skull.py` (numpy and scipy only).

Python/scipy re-implementation of the reference MATLAB pipeline
(matlab/skull2medium.m + skull_example.m):

  1. threshold HU into skull / head / air masks;
  2. clean the skull mask: largest connected component + hole filling
     (skull2medium.m:383-440 morphology);
  3. HU -> mass density via a piecewise-linear CT calibration curve
     (k-Wave's hounsfield2density shape);
  4. density -> sound speed  c = rho * slope + intercept
     (skull2medium.m:449-467);
  5. rescale to the solver's nondimensional sos range [1, 2]
     (skull_example.m rescale before saving problem_setup.mat).

CT input: HU arrays directly, or DICOM via data/dicom.py (the reference's
dicomread step, skull_example.m:11-13) — `medium_from_dicom` goes straight
from a .dcm slice to the acoustic medium. `synthetic_skull_ct` builds a
realistic two-layer phantom for examples/tests. `make_arc_source` is the
k-Wave makeArc equivalent (skull_example.m:80) for transducer sources.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import ndimage


@dataclass
class MediumConversion:
    sos: np.ndarray  # nondimensional [1, 2] sound-speed map
    sos_mps: np.ndarray  # physical m/s map
    density: np.ndarray  # kg/m^3
    skull_mask: np.ndarray
    head_mask: np.ndarray


def hounsfield_to_density(hu: np.ndarray) -> np.ndarray:
    """Piecewise-linear CT calibration (k-Wave hounsfield2density shape):
    air ~ 1.2, water 1000, soft tissue ~1060, cortical bone up to ~2000."""
    hu = np.asarray(hu, np.float64)
    rho = np.empty_like(hu)
    lo = hu < -98  # air/lung ramp
    rho[lo] = np.clip(1000.0 + hu[lo], 1.2, 1000.0)
    mid = (hu >= -98) & (hu < 880)  # soft tissue ramp
    rho[mid] = 1018.0 + 0.893 * hu[mid]
    hi = hu >= 880  # bone ramp
    rho[hi] = 1338.0 + 0.505 * hu[hi]
    return rho


def density_to_sos(rho: np.ndarray, slope: float = 1.33,
                   intercept: float = 167.0) -> np.ndarray:
    """c = rho*slope + intercept [m/s] (skull2medium.m:449-467)."""
    return rho * slope + intercept


def clean_mask(mask: np.ndarray) -> np.ndarray:
    """Largest connected component + hole filling
    (skull2medium.m:388-440: bwconncomp + imfill)."""
    labels, n = ndimage.label(mask)
    if n == 0:
        return mask.astype(bool)
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, np.arange(1, n + 1))
    largest = (labels == (1 + int(np.argmax(sizes))))
    return ndimage.binary_fill_holes(largest)


def ct_to_medium(
    hu: np.ndarray,
    skull_threshold: float = 300.0,
    head_threshold: float = -200.0,
    background_sos: float = 1500.0,
    sos_range: tuple[float, float] = (1.0, 2.0),
) -> MediumConversion:
    """Full conversion of a 2D HU slice into a solver-ready sos map."""
    hu = np.asarray(hu, np.float64)
    skull = clean_mask(hu > skull_threshold)
    head = clean_mask(hu > head_threshold)

    rho = hounsfield_to_density(hu)
    c = density_to_sos(rho)
    # outside the head: water/background; inside non-skull: soft tissue
    c = np.where(head, c, background_sos)
    c = np.where(head & ~skull, np.clip(c, 1400.0, 1600.0), c)

    lo, hi = sos_range
    c_min, c_max = float(background_sos), float(c.max())
    denom = max(c_max - c_min, 1.0)
    sos = lo + (np.clip(c, c_min, c_max) - c_min) / denom * (hi - lo)
    return MediumConversion(
        sos=sos.astype(np.float32),
        sos_mps=c.astype(np.float32),
        density=rho.astype(np.float32),
        skull_mask=skull,
        head_mask=head,
    )


def medium_from_dicom(path: str, **kw) -> MediumConversion:
    """DICOM CT slice -> acoustic medium (the skull_example.m:11-17 flow:
    dicomread + rescale -> skull2medium)."""
    from .dicom import read_dicom_hu

    return ct_to_medium(read_dicom_hu(path), **kw)


def synthetic_skull_ct(size: int = 512, seed: int = 0) -> np.ndarray:
    """Synthetic 2D head CT phantom in HU: elliptical skull annulus
    (~1400 HU) around brain tissue (~40 HU) in air (-1000 HU)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy, cx = size / 2, size / 2
    ry, rx = size * 0.34, size * 0.27
    # mild random boundary perturbation
    theta = np.arctan2(yy - cy, xx - cx)
    wobble = 1.0 + 0.03 * np.sin(3 * theta + rng.random() * 6.28)
    r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) / wobble
    thickness = 0.09
    hu = np.full((size, size), -1000.0)
    hu[r < 1.0] = 40.0 + 5.0 * rng.standard_normal((r < 1.0).sum())
    shell = (r >= 1.0 - thickness) & (r < 1.0 + thickness)
    hu[shell] = 1400.0 + 150.0 * rng.standard_normal(shell.sum())
    return hu


def make_arc_source(
    shape: tuple[int, int],
    center: tuple[int, int],
    radius: float,
    focus: tuple[int, int],
    aperture: float,
    amplitude: float = 1.0,
) -> np.ndarray:
    """k-Wave makeArc equivalent: 1-px arc of given radius/aperture centered
    on `center`, oriented toward `focus`. Returns [H, W, 2] with the real
    channel set (monochromatic transducer at phase 0)."""
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = center
    fy, fx = focus
    dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    ring = np.abs(dist - radius) <= 0.6
    ang = np.arctan2(yy - cy, xx - cx)
    ang0 = np.arctan2(fy - cy, fx - cx)
    dang = np.angle(np.exp(1j * (ang - ang0)))
    arc = ring & (np.abs(dang) <= aperture / 2)
    out = np.zeros((h, w, 2), np.float32)
    out[..., 0] = arc * amplitude
    return out


def skull_example_problem(size: int = 512, seed: int = 0):
    """The skull_example.m setup: synthetic CT -> sos map + arc transducer
    source aimed at the head center. Returns (sos [H,W], source [H,W,2])."""
    hu = synthetic_skull_ct(size, seed)
    medium = ct_to_medium(hu)
    source = make_arc_source(
        (size, size),
        center=(int(size * 0.94), size // 2),
        radius=size * 0.12,
        focus=(size // 2, size // 2),
        aperture=2.2,
        amplitude=1.0,
    )
    return medium.sos, source

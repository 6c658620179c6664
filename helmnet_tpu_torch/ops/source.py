"""Monochromatic source maps.

Reproduces the reference SourceModule semantics (helmnet/source_module.py):
a point source placed at `location`, optionally smoothed in the spatial
frequency domain with a (periodic) Blackman window, with the amplitude map
taken as the modulus of the smoothed field; the complex map at time t is
|map| * exp(i*(omega*t + phase)).

Host-side numpy precompute — sources are built once per problem, not in the
hot path. The port's own copy of the point-source half of
`helmnet_tpu/ops/source.py`.
"""

from __future__ import annotations

import numpy as np


def periodic_blackman(n: int) -> np.ndarray:
    """Periodic Blackman window (torch.blackman_window default, periodic=True)."""
    return np.blackman(n + 1)[:-1]


def point_source_amplitude(
    height: int,
    width: int,
    location: tuple[int, int],
    amplitude: float = 1.0,
    smooth: bool = False,
) -> np.ndarray:
    """|amplitude map| of a point source, float64 [H, W].

    Matches helmnet/source_module.py:41-79 including the (numerically lossy)
    fft round trip taken even when smooth=False.
    """
    r, c = int(location[0]), int(location[1])
    if not (0 <= r < height and 0 <= c < width):
        raise ValueError(
            f"source location {location} outside the {height}x{width} grid"
        )
    spatial = np.zeros((height, width), dtype=np.float64)
    spatial[r, c] = amplitude
    freq = np.fft.fftshift(np.fft.fft2(spatial))
    if smooth:
        by = periodic_blackman(height)
        bx = periodic_blackman(width)
        freq = freq * np.outer(by, bx)
    return np.abs(np.fft.ifft2(np.fft.ifftshift(freq)))


def point_source_map(
    height: int,
    width: int,
    location: tuple[int, int],
    amplitude: float = 1.0,
    phase: float = 0.0,
    omega: float = 1.0,
    t: float = 0.0,
    smooth: bool = False,
) -> np.ndarray:
    """Complex source as channel-pair float32 [H, W, 2] at time t.

    real = |map| cos(omega*t + phase), imag = |map| sin(omega*t + phase)
    (helmnet/source_module.py:94-116).
    """
    amp = point_source_amplitude(height, width, location, amplitude, smooth)
    ct = omega * t + phase
    return np.stack([amp * np.cos(ct), amp * np.sin(ct)], axis=-1).astype(np.float32)

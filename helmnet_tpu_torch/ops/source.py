"""Monochromatic source maps.

Reproduces the reference SourceModule semantics (helmnet/source_module.py):
a point source placed at `location`, optionally smoothed in the spatial
frequency domain with a (periodic) Blackman window, with the amplitude map
taken as the modulus of the smoothed field; the complex map at time t is
|map| * exp(i*(omega*t + phase)).

Host-side numpy precompute — sources are built once per problem, not in the
hot path — except `point_sources_on_device`, which stamps point sources
from separable kernels on the tensors' device (the training loop's sparse
source pool). The port's own copy of `helmnet_tpu/ops/source.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


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


def line_source_amplitude(
    height: int,
    width: int,
    start: tuple[int, int],
    end: tuple[int, int],
    amplitude: float = 1.0,
    smooth: bool = False,
) -> np.ndarray:
    """|amplitude map| of an extended segment source, float64 [H, W].

    Rasterizes the segment from `start` to `end` (inclusive, (row, col)
    pixel coordinates) by dense parametric sampling, then takes the same
    fft round trip as the point source so smoothing semantics match
    (helmnet/source_module.py:41-79). Extended sources are a training
    extension of the JAX package: the reference trains point sources only.
    """
    r0, c0 = float(start[0]), float(start[1])
    r1, c1 = float(end[0]), float(end[1])
    for r, c in ((r0, c0), (r1, c1)):
        if not (0 <= r < height and 0 <= c < width):
            raise ValueError(
                f"segment endpoint {(r, c)} outside the {height}x{width} grid"
            )
    n = max(int(np.hypot(r1 - r0, c1 - c0) * 2) + 1, 2)
    t = np.linspace(0.0, 1.0, n)
    rows = np.clip(np.round(r0 + t * (r1 - r0)).astype(int), 0, height - 1)
    cols = np.clip(np.round(c0 + t * (c1 - c0)).astype(int), 0, width - 1)
    spatial = np.zeros((height, width), dtype=np.float64)
    spatial[rows, cols] = amplitude
    freq = np.fft.fftshift(np.fft.fft2(spatial))
    if smooth:
        by = periodic_blackman(height)
        bx = periodic_blackman(width)
        freq = freq * np.outer(by, bx)
    return np.abs(np.fft.ifft2(np.fft.ifftshift(freq)))


def line_source_map(
    height: int,
    width: int,
    start: tuple[int, int],
    end: tuple[int, int],
    amplitude: float = 1.0,
    phase: float = 0.0,
    omega: float = 1.0,
    t: float = 0.0,
    smooth: bool = False,
) -> np.ndarray:
    """Extended-segment complex source as channel-pair float32 [H, W, 2]."""
    amp = line_source_amplitude(height, width, start, end, amplitude, smooth)
    ct = omega * t + phase
    return np.stack([amp * np.cos(ct), amp * np.sin(ct)], axis=-1).astype(
        np.float32
    )


def point_source_kernels(
    height: int, width: int, smooth: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Separable 1D amplitude kernels (ky [H], kx [W], float32) such that

        point_source_amplitude(H, W, (r, c), a, smooth)
            == a * np.outer(np.roll(ky, r), np.roll(kx, c))

    to machine precision: the FFT of a pixel delta is an outer product of
    per-axis phase ramps and the Blackman window is an outer product, so
    the (|.| of the) smoothed map factorizes per axis and translation is a
    circular roll. Two vectors plus [K, 2] integer locations replace a
    dense [K, H, W, 2] source pool."""

    def k1(n: int) -> np.ndarray:
        w = periodic_blackman(n) if smooth else np.ones(n)
        return np.abs(np.fft.ifft(np.fft.ifftshift(w)))

    return k1(height).astype(np.float32), k1(width).astype(np.float32)


def point_sources_on_device(ky: torch.Tensor, kx: torch.Tensor,
                            locations: torch.Tensor, amplitude: float,
                            phase: float, omega: float = 1.0,
                            t: float = 0.0) -> torch.Tensor:
    """[B, H, W, 2] channel-pair source maps from integer locations [B, 2],
    computed on the kernels' device from the separable kernels of
    `point_source_kernels`: the f32 equivalent of stacking
    `point_source_map` over the locations, with O(B*H*W) memory instead of
    a gather from an O(K*H*W) dense pool."""
    h, w = ky.shape[0], kx.shape[0]
    loc = locations.to(device=ky.device, dtype=torch.long)
    # torch.roll(k, r)[i] == k[(i - r) % n], one roll per location
    rows = ky[(torch.arange(h, device=ky.device) - loc[:, :1]) % h]  # [B, H]
    cols = kx[(torch.arange(w, device=kx.device) - loc[:, 1:]) % w]  # [B, W]
    amp = amplitude * (rows[:, :, None] * cols[:, None, :])
    ct = omega * t + phase
    return torch.stack([amp * math.cos(ct), amp * math.sin(ct)], dim=-1)


def source_batch_from_locations(
    height: int,
    width: int,
    locations,
    amplitude: float = 1.0,
    phase: float = 0.0,
    omega: float = 1.0,
    smooth: bool = False,
) -> np.ndarray:
    """Stack of source maps [B, H, W, 2] for a list of (row, col) locations."""
    return np.stack(
        [
            point_source_map(height, width, loc, amplitude, phase, omega, 0.0, smooth)
            for loc in locations
        ]
    )

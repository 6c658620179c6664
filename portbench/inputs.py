"""Inputs made from the seed: sound-speed maps and volumes, and sources.

The maps follow the distributions of the program's dataset generators,
drawn with numpy's `default_rng(seed)` on the host (a few numbers a map)
and rasterised on the device in a few large calls:

- `ellipse_maps`: the "idealized skull" of the reference's dataloader
  (helmnet/dataloaders.py): a closed 4-harmonic Fourier contour of 360
  points, a ring of random thickness 2-9 px around it at sound speed
  1.5-2.0 on a background of 1.0. A pixel is in the ring when its
  distance to the contour's polyline is at most max(thickness // 2, 1)
  (the program's generator stamps disks of that radius along it).
- `shell_volumes`: the ellipsoidal shell of the 3D generator, its radius
  perturbed by 4 random plane-wave harmonics of the direction.

Every map of a seed comes from one numpy stream, so the same seed gives
the same inputs; other seeds give other maps of the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for (seed, stream); any whole seed, negative too."""
    return np.random.default_rng([seed % 2**64, stream])


def ellipse_maps(rng: np.random.Generator, count: int, n: int, device) -> torch.Tensor:
    """[count, n, n] f32 on `device`."""
    t = np.linspace(0, 2 * np.pi, num=360, endpoint=True)
    avg = np.array([1.0, 0.0, 0.0, 0.0])
    std = np.array([0.1, 0.05, 0.025, 0.01])
    xs, ys, radius, boost = [], [], [], []
    for _ in range(count):
        a_x = avg + rng.standard_normal(4) * std
        a_y = avg + rng.standard_normal(4) * std
        ph_x = rng.standard_normal(4) * np.pi / 16
        ph_y = rng.standard_normal(4) * np.pi / 16
        x = sum(np.sin(t * (i + 1) + ph_x[i]) * a_x[i] for i in range(4))
        y = sum(np.cos(t * (i + 1) + ph_y[i]) * a_y[i] for i in range(4))
        xs.append(((x + 2) / 4 * n).astype(np.int32))
        ys.append(((y + 2) / 4 * n).astype(np.int32))
        thickness = int(2.0 + rng.random() * 8.0)
        radius.append(max(thickness // 2, 1))
        boost.append(0.5 + rng.random() * 0.5)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    px, py = f32(xs), f32(ys)  # [count, 360]: column, row
    qx, qy = px.roll(-1, 1), py.roll(-1, 1)  # the polyline is closed
    col = torch.arange(n, device=device, dtype=torch.float32)
    gy, gx = torch.meshgrid(col, col, indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    best = torch.full((count, n * n), math.inf, device=device)
    for s in range(px.shape[1]):
        x0, y0 = px[:, s:s + 1], py[:, s:s + 1]
        dx, dy = qx[:, s:s + 1] - x0, qy[:, s:s + 1] - y0
        length = (dx * dx + dy * dy).clamp_min(1e-12)
        u = (((gx - x0) * dx + (gy - y0) * dy) / length).clamp(0.0, 1.0)
        ex, ey = gx - (x0 + u * dx), gy - (y0 + u * dy)
        best = torch.minimum(best, ex * ex + ey * ey)
    ring = best <= f32(radius)[:, None] ** 2
    maps = 1.0 + ring.float() * f32(boost)[:, None]
    return maps.reshape(count, n, n)


def shell_volumes(rng: np.random.Generator, count: int, n: int, device) -> torch.Tensor:
    """[count, n, n, n] f32 on `device`. The shell's thickness is drawn
    from N(2, 4) px and clipped to [1, 0.12 n], as in the program's
    generator."""
    top = 0.12 * n
    ax = torch.arange(n, device=device, dtype=torch.float32)
    z, y, x = torch.meshgrid(ax, ax, ax, indexing="ij")
    vols = []
    for _ in range(count):
        center = n / 2 + rng.uniform(-0.05 * n, 0.05 * n, size=3)
        semi = rng.uniform(0.24 * n, 0.36 * n, size=3)
        dz = (z - float(center[0])) / float(semi[0])
        dy = (y - float(center[1])) / float(semi[1])
        dx = (x - float(center[2])) / float(semi[2])
        rho = torch.sqrt(dz * dz + dy * dy + dx * dx)
        inv = 1.0 / rho.clamp_min(1e-6)
        uz, uy, ux = dz * inv, dy * inv, dx * inv
        perturb = torch.zeros_like(rho)
        for h, std in enumerate((0.08, 0.05, 0.03, 0.02)):
            k = rng.normal(size=3)
            k *= (h + 1) / (np.linalg.norm(k) + 1e-6)
            amp = rng.normal(0.0, std)
            phase = rng.uniform(0, 2 * np.pi)
            perturb += float(amp) * torch.cos(
                float(k[0]) * uz * math.pi + float(k[1]) * uy * math.pi
                + float(k[2]) * ux * math.pi + float(phase))
        thickness = float(np.clip(rng.normal(2.0, 4.0), 1.0, top))
        half_band = thickness / (2.0 * float(np.mean(semi)))
        boost = 0.5 + 0.5 * rng.random()
        shell = (rho - (1.0 + perturb)).abs() < half_band
        vols.append(1.0 + shell.float() * float(boost))
    return torch.stack(vols)


def point_source(grid, location, amplitude: float, phase: float, device) -> torch.Tensor:
    """A point source of `amplitude` and `phase` at `location`, as
    channel pairs [*grid, 2] (real, imaginary)."""
    src = torch.zeros(tuple(grid) + (2,), device=device)
    src[tuple(location)] = torch.tensor(
        [amplitude * math.cos(phase), amplitude * math.sin(phase)], device=device)
    return src

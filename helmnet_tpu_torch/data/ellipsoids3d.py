"""Random ellipsoidal-shell ("idealized skull") sound-speed volumes, the
port's own copy of `helmnet_tpu/data/ellipsoids3d.py` (numpy only; the
same seeded draws, so the same volumes to the bit).

The 3D analog of the 2D ellipse dataset (data/ellipses.py): background sos
1.0, a shell of sos uniform in [1.5, 2.0] and random thickness, its
radius perturbed by a low-order sum of random plane-wave harmonics on the
direction vector; optionally a smooth random interior. Volumes are
float32 [N, D, H, W] and store through plain .npz.
"""

from __future__ import annotations

import os

import numpy as np


def make_shell3d(
    rng: np.random.Generator,
    imsize: int = 64,
    avg_thickness: float = 2.0,
    std_thickness: float = 4.0,
    background_sos: float = 1.0,
    minimal_skull_sos_boost: float = 0.5,
    maximal_random_skull_boost: float = 0.5,
    n_harmonics: int = 4,
    std_amplitudes=(0.08, 0.05, 0.03, 0.02),
    interior_heterogeneity: float = 0.0,
) -> np.ndarray:
    """One random sos volume, float32 [imsize, imsize, imsize].

    interior_heterogeneity > 0 fills the INSIDE of the shell with a
    smooth random low-order Fourier sos field in
    [background, background + interior_heterogeneity] — contrast inside
    the domain, not just a shell on a homogeneous background (the
    tpu3d_het training regime)."""
    n = imsize
    ax = np.arange(n, dtype=np.float32)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")

    center = n / 2 + rng.uniform(-0.05 * n, 0.05 * n, size=3)
    semi = rng.uniform(0.24 * n, 0.36 * n, size=3)
    dz = (z - center[0]) / semi[0]
    dy = (y - center[1]) / semi[1]
    dx = (x - center[2]) / semi[2]
    rho = np.sqrt(dz * dz + dy * dy + dx * dx)  # ellipsoidal radius, shell at 1

    # low-order harmonic perturbation of the shell radius: random plane
    # waves in the normalized direction vector (smooth over the sphere)
    eps = 1e-6
    inv = 1.0 / np.maximum(rho, eps)
    uz, uy, ux = dz * inv, dy * inv, dx * inv
    perturb = np.zeros_like(rho)
    for h in range(n_harmonics):
        kvec = rng.normal(size=3)
        kvec *= (h + 1) / (np.linalg.norm(kvec) + eps)
        amp = rng.normal(0.0, std_amplitudes[min(h, len(std_amplitudes) - 1)])
        phase = rng.uniform(0, 2 * np.pi)
        perturb += amp * np.cos(kvec[0] * uz * np.pi + kvec[1] * uy * np.pi
                                + kvec[2] * ux * np.pi + phase)
    r0 = 1.0 + perturb

    thickness_px = np.clip(
        rng.normal(avg_thickness, std_thickness), 1.0, 0.12 * n
    )
    half_band = thickness_px / (2.0 * float(np.mean(semi)))
    shell = np.abs(rho - r0) < half_band

    boost = minimal_skull_sos_boost + maximal_random_skull_boost * rng.random()
    vol = np.full((n, n, n), background_sos, np.float32)
    if interior_heterogeneity > 0.0:
        # smooth low-order random cosine field, normalized to [0, 1]
        field = np.zeros((n, n, n), np.float32)
        coords = (z / n, y / n, x / n)
        for _ in range(5):
            kv = rng.integers(1, 4, size=3).astype(np.float32)
            phase = rng.uniform(0, 2 * np.pi, size=3)
            field += np.cos(2 * np.pi * kv[0] * coords[0] + phase[0]) * \
                np.cos(2 * np.pi * kv[1] * coords[1] + phase[1]) * \
                np.cos(2 * np.pi * kv[2] * coords[2] + phase[2])
        field -= field.min()
        field /= max(field.max(), 1e-6)
        inside = rho < (r0 - half_band)
        vol[inside] = (background_sos
                       + interior_heterogeneity * field[inside])
    vol[shell] = background_sos + boost
    return vol


def make_dataset3d(
    n_maps: int, imsize: int = 64, seed: int = 0, **kwargs
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack(
        [make_shell3d(rng, imsize, **kwargs) for _ in range(n_maps)]
    )


def split_and_save3d(
    out_dir: str,
    n_train: int = 200,
    n_val: int = 32,
    n_test: int = 32,
    imsize: int = 64,
    seed: int = 0,
) -> None:
    """Generate + save train/validation/test volumes (npz, key 'maps')."""
    os.makedirs(out_dir, exist_ok=True)
    total = n_train + n_val + n_test
    maps = make_dataset3d(total, imsize, seed)
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(total)
    splits = {
        "trainset": maps[order[:n_train]],
        "validation": maps[order[n_train : n_train + n_val]],
        "testset": maps[order[n_train + n_val :]],
    }
    for name, arr in splits.items():
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), maps=arr)

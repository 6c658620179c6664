"""Ellipse ("idealized skull") sound-speed map dataset, port of
`helmnet_tpu/data/ellipses.py`.

Same generative distribution as the reference (helmnet/dataloaders.py:82-156):
a 4-harmonic Fourier contour rasterized as a closed polyline of random
thickness (2-10 px), background sos 1.0, annulus sos uniform in [1.5, 2.0].
Host-side numpy — data prep is not a device hot path. cv2 draws the
polyline where it is installed (as in the reference); without it the numpy
rasterizer `_polylines_numpy` does, as in the JAX package.

Datasets are stored as plain .npz (maps: float32 [N, H, W]); `split_and_save`
mirrors generate_dataset.py's 9000/1000/1000 random split.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # the numpy rasterizer below takes its place
    cv2 = None


def make_ellipsoid(
    rng: np.random.Generator,
    imsize: int = 128,
    avg_thickness: float = 2.0,
    std_thickness: float = 8.0,
    background_sos: float = 1.0,
    minimal_skull_sos_boost: float = 0.5,
    maximal_random_skull_boost: float = 0.5,
    avg_amplitudes=(1.0, 0.0, 0.0, 0.0),
    std_amplitudes=(0.1, 0.05, 0.025, 0.01),
    std_phase_value: float = np.pi / 16,
    avg_phase_value: float = 0.0,
) -> np.ndarray:
    """One random sos map, float32 [imsize, imsize]."""
    t = np.linspace(0, 2 * np.pi, num=360, endpoint=True)
    avg_a = np.asarray(avg_amplitudes)
    std_a = np.asarray(std_amplitudes)
    nh = len(avg_a)
    a_x = avg_a + rng.standard_normal(nh) * std_a
    a_y = avg_a + rng.standard_normal(nh) * std_a
    ph_x = avg_phase_value + rng.standard_normal(nh) * std_phase_value
    ph_y = avg_phase_value + rng.standard_normal(nh) * std_phase_value

    x = np.zeros_like(t)
    y = np.zeros_like(t)
    for i in range(nh):
        x = x + np.sin(t * (i + 1) + ph_x[i]) * a_x[i]
        y = y + np.cos(t * (i + 1) + ph_y[i]) * a_y[i]
    x = (x + 2) / nh * imsize
    y = (y + 2) / nh * imsize

    thickness = int(avg_thickness + rng.random() * std_thickness)
    pts = np.expand_dims(np.array([x, y], np.int32).T, axis=0)
    img = np.zeros((imsize, imsize), np.uint8)
    if cv2 is not None:
        cv2.polylines(img, [pts], True, 1, thickness=thickness)
    else:
        _polylines_numpy(img, pts[0], thickness)

    boost = minimal_skull_sos_boost + rng.random() * maximal_random_skull_boost
    return (background_sos + img.astype(np.float32) * boost).astype(np.float32)


def _polylines_numpy(img: np.ndarray, pts: np.ndarray, thickness: int) -> None:
    """Fallback rasterizer: stamp thickness-radius disks along each segment."""
    h, w = img.shape
    r = max(thickness // 2, 1)
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    disk = (yy**2 + xx**2) <= r**2
    closed = np.vstack([pts, pts[:1]])
    for (x0, y0), (x1, y1) in zip(closed[:-1], closed[1:]):
        steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
        for s in range(steps + 1):
            cx = int(round(x0 + (x1 - x0) * s / steps))
            cy = int(round(y0 + (y1 - y0) * s / steps))
            ylo, yhi = max(cy - r, 0), min(cy + r + 1, h)
            xlo, xhi = max(cx - r, 0), min(cx + r + 1, w)
            if ylo >= yhi or xlo >= xhi:
                continue
            dy0, dx0 = ylo - (cy - r), xlo - (cx - r)
            img[ylo:yhi, xlo:xhi] |= disk[
                dy0 : dy0 + yhi - ylo, dx0 : dx0 + xhi - xlo
            ].astype(img.dtype)


def make_dataset(
    num: int, imsize: int = 96, seed: int = 0, backend: str = "python"
) -> np.ndarray:
    """Generate `num` maps. backend='python' (cv2 where installed, matching
    the reference rasterizer exactly) or 'native' (the threaded C++
    generator of native/helmnet_native.cpp, the same distribution)."""
    if backend == "native":
        from ..core import native

        return native.generate_ellipses(num, imsize, seed)
    rng = np.random.default_rng(seed)
    return np.stack([make_ellipsoid(rng, imsize) for _ in range(num)])


def split_and_save(
    maps: np.ndarray,
    out_dir: str,
    splits=(9000, 1000, 1000),
    seed: int = 0,
) -> dict:
    """Random split (generate_dataset.py:7-17 semantics) into npz files."""
    if sum(splits) > len(maps):
        raise ValueError(f"splits {tuple(splits)} need more than {len(maps)} maps")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(maps))
    os.makedirs(out_dir, exist_ok=True)
    names = ("trainset", "validation", "testset")
    out = {}
    start = 0
    for name, count in zip(names, splits):
        idx = perm[start : start + count]
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez_compressed(path, maps=maps[idx], indices=idx)
        out[name] = path
        start += count
    return out


def load_maps(path: str, key: str = "maps") -> np.ndarray:
    """Load a dataset split -> float32 [N, H, W]. Falls back to the first
    3D array in the archive if `key` is absent."""
    with np.load(path) as f:
        if key in f:
            return f[key].astype(np.float32)
        for name in f.files:
            arr = f[name]
            if arr.ndim == 3:
                return arr.astype(np.float32)
        raise KeyError(f"no 3D map array found in {path} (keys: {f.files})")


def get_dataset(dataset_path: str) -> np.ndarray:
    """Reference-compatible dataset loader (helmnet/dataloaders.py:9-24).

    Accepts the .npz splits or the reference's pickled torch datasets
    (.ph, loaded on the CPU) -> float32 [N, H, W].
    """
    if dataset_path.endswith(".npz"):
        return load_maps(dataset_path)
    import torch

    ds = torch.load(dataset_path, map_location="cpu", weights_only=False)
    maps = [np.asarray(ds[i], np.float32) for i in range(len(ds))]
    arr = np.stack(maps)
    # reference maps are [1, H, W] per item
    return arr[:, 0] if arr.ndim == 4 else arr

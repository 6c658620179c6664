"""Sound-speed map datasets, port of the loader half of
`helmnet_tpu/data/ellipses.py` (`load_maps`). The generator of the
ellipse dataset is not ported yet."""

from __future__ import annotations

import numpy as np


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

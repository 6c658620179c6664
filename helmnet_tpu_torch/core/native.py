"""ctypes bindings for the repo's C++ native runtime
(native/helmnet_native.cpp), port of `helmnet_tpu/core/native.py`.

Loads `native/libhelmnet_native.so`, building it with the in-tree Makefile
(`make -C native`, g++) when it is absent. Every entry point has a numpy
fallback, so the port works without a toolchain; the native path is the
fast bulk ellipse generator and the threaded row mover of the host-side
replay buffer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhelmnet_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_LIB_PATH)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.helmnet_native_abi_version.restype = ctypes.c_int
        if lib.helmnet_native_abi_version() != 1:
            _load_failed = True
            return None
        lib.generate_ellipses.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.generate_ellipses.restype = None
        for name in ("gather_rows", "scatter_rows"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int,
            ]
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def generate_ellipses(num: int, size: int, seed: int = 0,
                      num_threads: Optional[int] = None) -> np.ndarray:
    """Threaded C++ ellipse dataset generation -> float32 [num, size, size]."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty((num, size, size), np.float32)
    nt = num_threads or min(os.cpu_count() or 1, 16)
    lib.generate_ellipses(_fptr(out), num, size, seed, nt)
    return out


def _check_rows(idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"row index out of range for {n} rows")


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = src[idx[i]] over the leading axis (threaded memcpy)."""
    lib = load()
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    row = int(np.prod(src.shape[1:]))
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], np.float32)
    if lib is None or out.dtype != np.float32 or not out.flags.c_contiguous:
        out[...] = src[idx]
        return out
    _check_rows(idx, len(src))
    lib.gather_rows(_fptr(src), _fptr(out), _iptr(idx), len(idx), row,
                    min(os.cpu_count() or 1, 8))
    return out


def scatter_rows(dst: np.ndarray, src: np.ndarray, idx: np.ndarray) -> None:
    """dst[idx[i]] = src[i] over the leading axis (threaded memcpy)."""
    lib = load()
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst[idx] = src
        return
    _check_rows(idx, len(dst))
    src = np.ascontiguousarray(
        np.broadcast_to(src, (len(idx),) + dst.shape[1:]), np.float32)
    row = int(np.prod(dst.shape[1:]))
    lib.scatter_rows(_fptr(dst), _fptr(src), _iptr(idx), len(idx), row,
                     min(os.cpu_count() or 1, 8))

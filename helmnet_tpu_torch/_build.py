"""Build and load the port's CUDA kernels: plain `nvcc`, bound with ctypes.

The sources under `csrc/` have a plain C interface and include no PyTorch
header. Each is compiled by its own `nvcc` process, all started together,
and the objects are linked into one shared library. The library goes to
`build/torch_kernels/libhelmnet_kernels_<sha1>.so` beside the package
(`build/` is not committed); the name carries a digest of the sources and
flags, so an edited source builds anew and an unchanged one is reused.
Each build writes a temporary file and renames it into place, so a build
that was cut off leaves no lock and no half-written library behind.

`nvcc` comes from `$CUDA_HOME/bin` (default `/usr/local/cuda`) or `PATH`.
Nothing is built or loaded at import: the first kernel call does it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = (
    PACKAGE_DIR / "csrc" / "double_conv.cu",
    PACKAGE_DIR / "csrc" / "packed_double_conv.cu",
    PACKAGE_DIR / "csrc" / "stencil_residual.cu",
)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 300

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# hn_double_conv(x1, c1, v1, x2, c2, v2, w1, b1, slope, w2, b2, w3, b3,
#                out, B, H, W, cs, cmp, cop, co, ce, cep, tile, stream)
# hn_packed_double_conv(x0, c0, x1, c1, x2, c2, w1, b1, slope, w2, b2, w3,
#                       b3, out, B, H, W, cm, co, ce, cmp, cop, cep, vec,
#                       tile, stream)
# hn_packed_double_conv_smem(tile, cmp, cop)
# hn_stencil_residual(ur, ui, ubs, uxs, k2, kbs, sr, si, sbs, sxs, rr, ri,
#                     rbs, rxs, cxr, cxi, cyr, cyi, B, H, W, radius, mode,
#                     stream)
_SIGNATURES = {
    "hn_double_conv": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "hn_packed_double_conv": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "hn_packed_double_conv_smem": [_I, _I, _I],
    "hn_stencil_residual": [_P, _P, _L, _I, _P, _L, _P, _P, _L, _I, _P, _P,
                            _L, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    log: str  # nvcc's output, with the -Xptxas -v resource lines; "" if reused


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the port's CUDA kernels"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libhelmnet_kernels_{digest.hexdigest()}.so"


def build(force: bool = False) -> BuildResult:
    """Compile the sources into the shared library unless it exists: one
    `nvcc -c` per source, run in parallel, then one link."""
    out = library_path()
    if out.exists() and not force:
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f".{tag}.tmp.so")
    objs = [out.with_name(f".{tag}.{src.stem}.o") for src in SOURCES]
    t0 = time.perf_counter()
    procs: list[subprocess.Popen] = []
    try:
        procs += [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            try:
                text, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
                failed.append(f"{src.name}: timed out after {BUILD_TIMEOUT_S} s")
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc exited {proc.returncode}")
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildResult(out, seconds, log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

#!/usr/bin/env python3
"""Build variants of the stencil residual kernel (K2a-c) and time them on
one NVIDIA card, warm and with a cold L2, at its two main-path calls:
GMRES's matvec (16 x 256^2 complex64, the `pairs` instance, no source)
and bench.py's 512^2 x 8 split planes with a source (`planes`).

    python3 tools/k2_variants.py [VARIANT ...]

A variant is `NAME=VALUE,...`: each NAME is a constant of the `Tile`
struct in `helmnet_tpu_torch/csrc/stencil_residual.cu` (V, NY, AHEAD,
TX, TY) and VALUE its C++ expression, or the word `notaps`, which drops
the taps (r = k^2 u - s: the kernel's staging and stores alone, a floor
for its memory traffic). No argument times the source as it is. Each
variant is compiled by its own `nvcc` into `build/k2_variants/`, all in
parallel; the script prints each one's registers and shared memory, then
two rounds of warm (`chip_smoke.cuda_ms`) and cold (`chip_smoke.
cuda_cold_ms`) times beside the byte bound, with a check that the result
equals the plain version to the bit (not for `notaps`), and one
elementwise PyTorch pass over GMRES's bytes as a floor.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from helmnet_tpu_torch import _build  # noqa: E402
from helmnet_tpu_torch.ops import stencil_residual as sr  # noqa: E402
from helmnet_tpu_torch.ops.stencil import make_stencil_operator  # noqa: E402

SOURCE = ROOT / "helmnet_tpu_torch" / "csrc" / "stencil_residual.cu"
OUT = ROOT / "build" / "k2_variants"
TAPS = "for (int t = 0; t < NT; ++t) {\n      // x tap"


def patched(spec: str) -> str:
    text = SOURCE.read_text()
    for item in filter(None, spec.split(",")):
        if item == "notaps":
            assert text.count(TAPS) == 1
            text = text.replace(TAPS, TAPS.replace("t < NT", "t < 0"))
            continue
        name, value = item.split("=", 1)
        text, n = re.subn(rf"static constexpr int {name} = [^;]*;",
                          f"static constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in Tile")
    return text


def build(specs: list[str]) -> list[ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for i, spec in enumerate(specs):
        src = OUT / f"k2_{i}.cu"
        src.write_text(patched(spec))
        procs.append(subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(OUT / f"k2_{i}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, (spec, proc) in enumerate(zip(specs, procs)):
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"variant {i} ({spec or 'as is'}) did not build:\n{log}")
        print(f"variant {i} ({spec or 'as is'}):")
        for row in cs.ptxas_table(log):
            print(f"  K2 <{', '.join(map(str, row['args']))}>: {row['registers']} "
                  f"registers, {row['smem']} B shared memory, spills "
                  f"{row['spill_stores']} / {row['spill_loads']} B")
        lib = ctypes.CDLL(str(OUT / f"k2_{i}.so"))
        lib.hn_stencil_residual.argtypes = _build._SIGNATURES["hn_stencil_residual"]
        lib.hn_stencil_residual.restype = ctypes.c_int
        libs.append(lib)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device is available", file=sys.stderr)
        return 1
    import faulthandler

    faulthandler.cancel_dump_traceback_later()  # chip_smoke's watchdog
    specs = sys.argv[1:] or [""]
    libs = build(specs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    on = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    st256 = make_stencil_operator(256, 256, 8, 2.0, 1.0, order=4, device=dev)
    pair = torch.view_as_real(torch.complex(on(rng.standard_normal((16, 256, 256))),
                                            on(rng.standard_normal((16, 256, 256)))))
    k256 = on(rng.uniform(0.5, 1.2, (16, 256, 256)))
    st512 = make_stencil_operator(512, 512, 8, 2.0, 1.0, order=4, device=dev)
    p512 = [on(rng.standard_normal((8, 512, 512))) for _ in range(4)]
    k512 = on(rng.uniform(0.5, 1.2, (8, 512, 512)))
    a512 = (p512[0], p512[1], k512, p512[2], p512[3])
    calls = {
        "GMRES matvec 16 x 256^2": (
            lambda: sr.helmholtz_residual_kernel(st256, pair, k256),
            lambda: torch.stack(sr.residual_planes_plain(
                st256, pair[..., 0], pair[..., 1], k256), -1),
            cs.stencil_bound(2, 16, 256, 256, False)[2]),
        "512^2 x 8": (lambda: sr.residual_planes(st512, *a512),
                      lambda: sr.residual_planes_plain(st512, *a512),
                      cs.stencil_bound(2, 8, 512, 512, True)[2]),
    }
    r = torch.empty_like(pair)
    floor = lambda: torch.mul(pair, k256[..., None], out=r)
    print(f"elementwise pass over GMRES's bytes (torch.mul u k^2): warm "
          f"{cs.cuda_ms(floor, iters=100) * 1e3:.2f} us, cold "
          f"{cs.cuda_cold_ms(floor) * 1e3:.2f} us")
    for rnd in range(2):
        for i, (spec, lib) in enumerate(zip(specs, libs)):
            _build.load_library = lambda lib=lib: lib
            for name, (fn, plain, bound) in calls.items():
                got, ref = fn(), plain()
                same = "notaps" in spec or (
                    torch.equal(got, ref) if isinstance(got, torch.Tensor)
                    else all(map(torch.equal, got, ref)))
                warm, cold = cs.cuda_ms(fn, iters=100), cs.cuda_cold_ms(fn)
                print(f"round {rnd} variant {i} {name}: warm {warm * 1e3:.2f} us, "
                      f"cold {cold * 1e3:.2f} us, bound {bound * 1e3:.2f} us, "
                      f"share {bound / cold:.3f}"
                      + ("" if "notaps" in spec else f", bit-equal {same}"),
                      flush=True)
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

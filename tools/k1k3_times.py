#!/usr/bin/env python3
"""Device time of K1 and K3 per step of their main paths on one card, for
the tree at --root (by default the checkout this file is in), so that two
trees unpacked side by side (a parent and a change) can be timed in turns
on one card.

    python tools/k1k3_times.py [--root DIR] [--label NAME]

With the kernels and `chip_smoke.py` of --root, and the weights of this
checkout: K1 at the 14 DoubleConv calls of a 96^2 x 32 step (phase 5's
shapes, trained_models/round1_best_epoch890.npz, weights prepared once)
and K3 at the 14 calls of a packed 256^2 step at g = 16, 32 and 64
(phase 6 and 6b's shapes: batch 1, the same weights packed), seeded
random inputs, each call at the tile `tile_for` picks, its device time
from CUDA events around a CUDA-graph replay (`chip_smoke.cuda_ms`: 50
calls a graph, 10 at g = 32 and 64, as the phases). Prints one JSON line:
the card's name and power limit, per step the sum over its calls in ms,
and for each K3 call its grid, tile, ms, TFLOP/s (`chip_smoke.packed_bound`'s
operations), and the weight bytes a design that reads the prepared w1, w2
and w3 once a tile reads from L2 (`chip_smoke.k3_design_bytes`, a model,
not measured) with the rate they imply. Both meters are this tree's
`chip_smoke.py`, whatever tree `--root` times, so the two trees are
measured alike. Needs a card; exits non-zero without one.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(HERE), help="tree whose kernels to time")
    parser.add_argument("--label", default="", help="name printed with the result")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k1k3_times: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    meter = cs
    if root != HERE:
        spec = importlib.util.spec_from_file_location("chip_smoke_meter", HERE / "chip_smoke.py")
        meter = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(meter)
    from helmnet_tpu_torch import _build
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.core.device import resolve_device
    from helmnet_tpu_torch.models.packed import pack_params, prepare_k3
    from helmnet_tpu_torch.ops.double_conv import fused_double_conv, prepare
    from helmnet_tpu_torch.ops.packed_double_conv import packed_double_conv, tile_for
    from helmnet_tpu_torch.weights import load_params_npz

    if not _build.__file__.startswith(str(root)):
        raise SystemExit(f"k1k3_times: imported {_build.__file__}, not from {root}")
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build(force=True)
    os.chdir(HERE)
    cfg = Config.from_json_file("experiments/base.json")
    model = dataclasses.replace(cfg.model, precision="default",
                                double_conv_mode="pallas", up_mode="subpixel")
    params = load_params_npz("trained_models/round1_best_epoch890.npz", cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    steps, calls = {}, {}
    k1 = []
    for _, p, n, cins in cs.step_calls(params, model, cs.GRID):
        parts = tuple(torch.randn((cs.BATCH, n, n, c), generator=gen, device=dev)
                      for c in cins)
        pw = prepare(p)
        k1.append(cs.cuda_ms(lambda: fused_double_conv(pw, parts)))
    steps[f"K1 {cs.GRID}^2 x {cs.BATCH}"] = sum(k1)
    for g, iters in ((cs.PACK_G, 50), *((gw, cs.WIDE_ITERS) for gw in cs.WIDE_STEPS)):
        kparams = prepare_k3(pack_params(params, g), model, g, inc_splits=(2, 2, 2))
        k3, rows = [], []
        for name, pw, n, cins in cs.packed_step_calls(kparams, model, cs.PACK_GRID):
            parts = tuple(torch.randn((1, n, n, c), generator=gen, device=dev)
                          for c in cins)
            k3.append(cs.cuda_ms(lambda: packed_double_conv(pw, parts), iters))
            th, tw = tile_for(1, n, n, pw.cmp, pw.cop, pw.ce)
            wbytes = meter.k3_design_bytes(pw, -(-n // th) * -(-n // tw))
            flops = meter.packed_bound(pw, parts, packed_double_conv(pw, parts))[0]
            rows.append({"name": name, "grid": n, "tile": f"{th}x{tw}", "ms": k3[-1],
                         "tflops": flops / k3[-1] / 1e9,
                         "design_l2_gb": wbytes / 1e9,
                         "design_l2_tb_s": wbytes / k3[-1] / 1e9})
        steps[f"K3 {cs.PACK_GRID}^2 g={g}"] = sum(k3)
        calls[f"K3 {cs.PACK_GRID}^2 g={g}"] = rows
        del kparams
    print(json.dumps({"label": args.label, "root": str(root), "nvidia_smi": smi,
                      "ms_per_step": steps, "k3_calls": calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

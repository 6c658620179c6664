"""Run one cell of the benchmark once, on the card this process sees.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the inputs from the seed, builds
the program's entry (its CUDA kernels build once a checkout, into
`build/`), and warms up every shape the window runs. Then the window runs
whole solves, each ended by a sync, until `--seconds` have passed: the
rate is all their work over all that time. With `--trace 1` the window is
instead the traffic's `trace_units` solves under torch.profiler, and the
metrics are the cell's per-layer ones. Once the window has closed, a
seeded sample of the answers is compared with the plain reference
(`cell.SolveCell.check`), and the last line of standard output is the
result as one JSON object.

Exits non-zero with no result when there is no card (or fewer than the
cell asks for), when the program is not beside this folder, and when
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "helmnet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`helmnet_tpu_torch` is not `helmnet_tpu`)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = spec.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """Set-up, window and check of one run; the result line's object."""
    import torch

    from .cell import make_cell
    from .trace import traced, warm_profiler

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sc = make_cell(cell.config, cell.traffic, seed, device)
    sc.warm_up()
    if trace:
        warm_profiler()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    if trace:
        units = cell.traffic["trace_units"]

        def window():
            for i in range(units):
                sc.unit(i)
                sync()

        tr = traced(window)
        window_s = tr.window_s
    else:
        units, start = 0, time.perf_counter()
        while True:
            sc.unit(units)
            sync()
            units += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        tr.counts = sc.layer_counts(units)
    sc.free()
    if cuda:
        torch.cuda.empty_cache()
    checks = sc.check(seed, cell.config["precision"])
    failed = sc.failed()
    correct = failed == 0 and all(checks[k] <= cell.limits[k] for k in cell.limits)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = units * sc.work_per_unit / window_s
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else rate
            if m["name"] in ("setup_s", cell.traffic["rate"]):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": units, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": cell.limits[k]} for k in cell.limits}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.cell(args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 3
    try:
        import helmnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not beside portbench/: {e}", file=sys.stderr)
        return 2

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T0)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

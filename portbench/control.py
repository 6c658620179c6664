"""The readings a cell's limits are set from, on the card. The benchmark's
own runs never run this.

    python3 -m portbench.control --workload <name> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--out FILE]

For each seed: the cell's set-up and one unit of its window (the timed
path at the cell's own size), then the check of its sampled answers
against the reference in the configuration's precision: the program's
readings. For each control seed: the same sample answered by the
reference computed in the configuration's `control_precision` (the
nearest precision below each part's), put in the program's place. Prints
a JSON line a reading, then the largest program reading and the smallest
control reading of each number.
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext
import json
import sys
import time

from . import spec
from .faults import FAULTS, planted


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", choices=sorted({f for fs in FAULTS.values() for f in fs}),
                        help="read the program's numbers with this fault planted")
    parser.add_argument("--out", help="also append the lines to this file")
    args = parser.parse_args(argv)

    import torch

    from .cell import make_cell

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    dev = torch.device("cuda")
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        with planted(args.fault, cell.traffic["entry"]) if args.fault else nullcontext():
            sc = make_cell(cell.config, cell.traffic, seed, dev)
            sc.checked_work()
        torch.cuda.synchronize()
        unit_s = time.perf_counter() - t
        sc.free()
        kinds = ([args.fault or "program"] if seed in args.seeds else []) + \
                (["control"] if seed in args.control_seeds else [])
        for kind in kinds:
            ctl = cell.config["control_precision"] if kind == "control" else None
            t = time.perf_counter()
            got = sc.check(seed, cell.config["precision"], control=ctl)
            rows.append({"workload": args.workload, "seed": seed, "kind": kind,
                         "readings": got, "failed": sc.failed(),
                         "diverged_alike": getattr(sc, "diverged_alike", 0), "unit_s": unit_s,
                         "check_s": time.perf_counter() - t})
            print(json.dumps(rows[-1]), flush=True)
        del sc
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "limits": cell.limits}
    for kind, pick in (("program", max), ("control", min), (args.fault, min)):
        got = [r["readings"] for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

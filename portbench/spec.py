"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (its `file`), a traffic
mix (`portbench/traffic/<traffic>.json`) and has its limits in
`portbench/cells/<workload>.json`. A metric `<name>` is read by
`portbench/metrics/<name>.py`, a module with `read(trace) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# what a DoubleConv mode computes in: the precision of each part of the
# step, the control's (the nearest precision below each part's) and the
# peak the step's MFU is taken against. 'pallas' runs K1 (bf16 operands,
# f32 accumulation) at the DoubleConvs and the head, cuDNN f32 elsewhere;
# 'xla' runs every conv on cuDNN in f32 (TF32 off).
PRECISIONS = {
    "pallas": ({"double_convs": "bf16", "head": "bf16", "resample_convs": "f32",
                "operator": "f32"},
               {"double_convs": "fp8", "head": "fp8", "resample_convs": "tf32",
                "operator": "tf32"},
               "bf16"),
    "xla": ({"double_convs": "f32", "head": "f32", "resample_convs": "f32",
             "operator": "f32"},
            {"double_convs": "tf32", "head": "tf32", "resample_convs": "tf32",
             "operator": "tf32"},
            "f32"),
}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark() -> dict:
    return _json(BENCHMARK)


def cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell `workload` of BENCHMARK.json."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in {BENCHMARK}")
    w = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _json(ROOT / entry["file"])
    config["weights"] = str(ROOT / config["weights"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    # a traffic may run the model in another DoubleConv mode (training has
    # no K1 backward); the precisions follow from the mode run
    mode = traffic.get("double_conv_mode", config["model"]["double_conv_mode"])
    config["model"]["double_conv_mode"] = mode
    config["precision"], config["control_precision"], config["peak"] = PRECISIONS[mode]
    limits = _json(HERE / "cells" / f"{workload}.json")["limits"]
    here = lambda m: "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", ()) or
                 ("workloads" not in m and m["moves"] in names)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, per_layer)


def metric_reader(name: str):
    """The `read` function of `portbench/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

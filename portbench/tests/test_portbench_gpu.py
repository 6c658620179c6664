"""On the card: each cell's traced run at its own size comes out correct,
and every per-layer metric it lists is read (so the K1 name the
roofline reader looks for matches kernels the trace holds), with shares
of a roofline or a peak in (0, 105] and the idle share in [0, 100]."""

import time

import pytest
import torch

from portbench import spec
from portbench.run import run_cell

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run(card, workload):
    cell = spec.cell(workload)
    result = run_cell(cell, 2**31 + 17, 1.0, True, card, time.perf_counter())
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert {m["name"] for m in cell.per_layer} == set(metrics)
    for name, m in metrics.items():
        if "_roofline." in name or "mfu" in name:
            assert 0 < m["value"] <= 105, (name, m)
        if name.startswith("device_idle_share."):
            assert 0 <= m["value"] <= 100
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]

"""Runs of each cell on the CPU at a small size, the harness's look for a
card skipped (`run.run_cell` called directly): a sound run comes out
correct; a run with the timed path broken underneath (`faults.planted`)
comes out not correct, for each fault a cell can have (a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced, and for the train cell the device
buffer's rows not written back); and the control, the reference in the
configuration's `control_precision` put in the program's place, comes
out not correct; and answers that are not finite are judged by the rule
`cell.SolveCell.check` states. A cell runs on one card, so it has no
exchange between cards to leave out."""

import time

import pytest
import torch

from portbench import spec
from portbench.cell import make_cell
from portbench.faults import FAULTS, planted
from portbench.run import run_cell

CPU = torch.device("cpu")
SEED = 2**31 + 11
SMALL = {
    "h2d.eval96-b512-k1": dict(grid=64, batch=4, iterations=30, source_location=[44, 32],
                               check_maps=4, reference_block=4),
    "h3d.eval48-b16": dict(grid=16, batch=2, iterations=12, source_location=[10, 8, 8],
                           check_maps=2, reference_block=2),
    # ages 0, 10, ..., 70 under the limit 41: rows 0-3 kept, 4-7 restarted
    "h2d.train1024-b8": dict(grid=32, batch=2, buffer=8, maps_count=4, source_location=[20, 16],
                             check_maxiter=41, reference_block=1),
}
WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
PLANTED = [(w, f) for w in WORKLOADS for f in FAULTS[spec.cell(w).traffic["entry"]]]


def small(workload: str) -> spec.Cell:
    cell = spec.cell(workload)
    cell.traffic.update(SMALL[workload])
    if cell.config["rank"] == 3:
        cell.config["geometry"]["pml_size"] = 4
    return cell


def run(cell):
    return run_cell(cell, SEED, 0.0, False, CPU, time.perf_counter())


def test_every_cell_has_a_small_size():
    assert sorted(SMALL) == sorted(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = run(small(workload))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("workload,fault", PLANTED)
def test_fault_is_not_correct(workload, fault):
    cell = small(workload)
    with planted(fault, cell.traffic["entry"]):
        result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    cell = small(workload)
    sc = make_cell(cell.config, cell.traffic, SEED, CPU)
    sc.checked_work()
    got = sc.check(SEED, cell.config["precision"], control=cell.config["control_precision"])
    assert any(got[k] > cell.limits[k] for k in cell.limits), got


@pytest.mark.parametrize("program,reference,correct,failed", [
    (True, True, True, 0),      # diverged alike: agrees, left out
    (True, False, False, 2),    # the program alone: failed answers
    (False, True, False, 0),    # the reference alone: infinite gaps
])
def test_answers_not_finite(monkeypatch, program, reference, correct, failed):
    """A sampled answer not finite on both sides agrees; one not finite in
    the program alone is failed; one not finite in the reference alone is
    not correct."""
    from portbench import cell as cell_module
    from portbench import program as program_module

    def spoiled(fn):
        def call(*a, **kw):
            wf, hist = fn(*a, **kw)
            return wf * float("nan"), hist * float("nan")
        return call
    if program:
        monkeypatch.setattr(program_module.Solve3D, "run",
                            spoiled(program_module.Solve3D.run))
    if reference:
        monkeypatch.setattr(cell_module, "solve", spoiled(cell_module.solve))
    result = run(small("h3d.eval48-b16"))
    assert result["correct"] is correct, result["checks"]
    assert result["failed"] == failed

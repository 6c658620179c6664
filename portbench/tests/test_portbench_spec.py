"""BENCHMARK.json against the forms it must keep, every file a cell names
found by name, and the no-JAX rules: what `portbench.run` runs imports
neither JAX nor the JAX package (top-level names compared whole), the
reference imports nothing of the program, and only the test of the
frozen copies imports chip_smoke."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from portbench import spec
from portbench.run import FORBIDDEN, forbidden_modules

HERE = Path(spec.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and all(LINE.match(w) for w in bench["command"])
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (spec.ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        own = json.loads((spec.ROOT / c["file"]).read_text())
        assert own["name"] == c["name"] and own["source_url"] == c["source"]


def test_workloads(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES and LINE.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_files_found(workload):
    """Each cell's configuration, traffic, limits and metric readers, by
    name; it reports setup_s, another end-to-end metric and a per-layer
    one, and every per-layer metric it lists moves one it reports."""
    cell = spec.cell(workload)
    assert Path(cell.config["weights"]).is_file()
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and cell.traffic["rate"] in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.metric_reader(m["name"]))


def test_forbidden_modules_whole_names(monkeypatch):
    fake = object()
    monkeypatch.setitem(sys.modules, "helmnet_tpu_torch", fake)
    monkeypatch.setitem(sys.modules, "helmnet_tpu_torch.ops", fake)
    assert "helmnet_tpu" not in forbidden_modules()
    for name in ("jax", "jaxlib.xla", "flax", "helmnet_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, fake)
        assert name.split(".")[0] in forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "helmnet_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if p.name != "test_portbench_frozen.py"),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "helmnet_tpu", "chip_smoke"}
    if "reference" in path.parts:
        assert "helmnet_tpu_torch" not in tops
        tree = ast.parse(path.read_text())
        # relative imports stay inside reference/
        assert all(n.level <= 1 for n in ast.walk(tree) if isinstance(n, ast.ImportFrom))


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result (on
    the card this test has nothing to say)."""
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bench = spec.benchmark()
    proc = subprocess.run(
        bench["command"] + ["--workload", bench["workloads"][0]["name"], "--seed", "1",
                            "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""

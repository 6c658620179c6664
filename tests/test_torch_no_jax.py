"""The port stands alone: no module under helmnet_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package; its kernels are built by
plain nvcc; and its entry points refuse to fall back to the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "helmnet_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "helmnet_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_no_cpp_extension_build():
    for path in list(PORT.rglob("*")) + [ROOT / "chip_smoke.py"]:
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh", ".h"):
            text = path.read_text()
            assert "cpp_extension" not in text, path
            assert "torch/extension.h" not in text, path


def test_package_imports_with_jax_blocked():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'helmnet_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_raise_without_a_card(monkeypatch):
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.ops.spectral import make_operator
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver, rollout
    from helmnet_tpu_torch.weights import from_jax_params, load_params_npz

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IterativeSolver(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params_npz(str(ROOT / "trained_models" / "round1_best_epoch890.npz"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_operator(32, 32, 4, 2.0, 1.0)
    solver = IterativeSolver(cfg.replace(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout(solver.params, solver.op, solver.source, np.ones((1, 96, 96)),
                cfg=solver.cfg, num_iterations=1)


def test_chip_smoke_fails_alone(tmp_path):
    """Without a card, and in a directory that holds only chip_smoke.py,
    the smoke run exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

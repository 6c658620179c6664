"""The orbax-trained weights in the port: `trained_models/tpu_r2c_best.npz`
against the JAX package's `IterativeSolver.from_orbax_checkpoint` of
`checkpoints/tpu_r2c` (the manifest's best step, 940), leaf by leaf and
exactly; `tools/export_orbax_npz.py` reproducing that file; and the port's
`cli/evaluate` and `IterativeSolver.from_params_npz` reading it."""

import os
import runpy

import jax
import numpy as np
import pytest
import torch

from helmnet_tpu.solvers.iterative import IterativeSolver as JaxSolver
from helmnet_tpu_torch.cli import evaluate as teval
from helmnet_tpu_torch.core.config import Config
from helmnet_tpu_torch.models.hybridnet import iter_leaves
from helmnet_tpu_torch.solvers.iterative import IterativeSolver
from helmnet_tpu_torch.weights import from_jax_params, load_params_npz
from tests.torch_solver_cases import R2C_NPZ, R2C_ORBAX, ROOT
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

LEAVES = 88


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The export tool's file for checkpoints/tpu_r2c, and JAX's params
    from the same restore."""
    if not os.path.isdir(R2C_ORBAX):
        pytest.skip("checkpoints/tpu_r2c is not present")
    out = tmp_path_factory.mktemp("export") / "tpu_r2c.npz"
    tool = runpy.run_path(os.path.join(ROOT, "tools", "export_orbax_npz.py"))
    assert tool["main"]([R2C_ORBAX, str(out)]) == 0
    return out


def test_committed_npz_equals_orbax_params():
    if not os.path.isdir(R2C_ORBAX):
        pytest.skip("checkpoints/tpu_r2c is not present")
    ref = JaxSolver.from_orbax_checkpoint(R2C_ORBAX).params
    leaves = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == LEAVES
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    got = load_params_npz(R2C_NPZ, Config(), device="cpu")
    pairs = list(zip(iter_leaves(got), iter_leaves(want)))
    assert len(pairs) == LEAVES
    for (path, g), (wpath, w) in pairs:
        assert path == wpath
        assert torch.equal(g, w), path


def test_export_tool_reproduces_the_committed_file(exported):
    with np.load(exported) as new, np.load(R2C_NPZ) as old:
        assert sorted(new.files) == sorted(old.files)
        assert len(new.files) == LEAVES
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k])
            assert new[k].dtype == old[k].dtype


def test_from_params_npz():
    solver = IterativeSolver.from_params_npz(R2C_NPZ, device="cpu")
    ref = load_params_npz(R2C_NPZ, solver.cfg, device="cpu")
    for (_, a), (_, b) in zip(iter_leaves(solver.params), iter_leaves(ref)):
        assert torch.equal(a, b)
    assert solver.cfg.model == Config().model


def test_cli_evaluate_reads_the_npz(tmp_path):
    """The default config's 96^2 grid, as JAX's CLI runs an orbax run."""
    testset = os.path.join(ROOT, "datasets", "splitted_96", "testset.npz")
    assert teval.main(["--checkpoint", R2C_NPZ, "--testset", testset,
                       "--limit", "2", "--iterations", "3", "--batch", "2",
                       "--platform", "cpu", "--out", str(tmp_path)]) == 0
    rmse = np.load(tmp_path / "evolution_of_model_RMSE_on_test_set.npy")
    assert rmse.shape == (2, 3) and np.all(np.isfinite(rmse))
    assert np.all(rmse[:, -1] < rmse[:, 0])

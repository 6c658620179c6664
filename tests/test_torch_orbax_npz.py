"""The orbax-trained weights in the port, against the JAX package's orbax
restores of `checkpoints/tpu_r2c` (each done once, in `jax_restores`):

- `trained_models/tpu_r2c_best.npz` against `from_orbax_checkpoint`'s
  params (the manifest's best step, 940), leaf by leaf and exactly, and
  `tools/export_orbax_npz.py` reproducing that file;
- the port's own `IterativeSolver.from_orbax_checkpoint` (train/orbax.py,
  no JAX) against JAX's, exactly: the best step, an explicit one (950)
  and `best=False` (the latest, 970);
- the port's `Trainer.restore` on a copy of the run against JAX's: the
  epoch, global step, scheduler state and learning rate equal, the Adam
  moments and count exactly JAX's restored ones, and after one train
  step on the same batch at tests/test_training.py:20's tiny config the
  params within the optimizer's tolerance (rtol 1e-6 plus 1e-6 * max|ref|
  a leaf, tests/test_torch_training.py:15-18);
- the port's `cli/evaluate` and `IterativeSolver.from_params_npz` reading
  the npz.
"""

import os
import runpy
import shutil

import jax
import jax.numpy as jnp
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
CASES = {"best": {}, "step": {"step": 950}, "latest": {"best": False}}


@pytest.fixture(scope="module")
def jax_restores():
    """JAX's `from_orbax_checkpoint(checkpoints/tpu_r2c)` params (numpy)
    for each of `CASES`; the first restore costs about 20 s here."""
    if not os.path.isdir(R2C_ORBAX):
        pytest.skip("checkpoints/tpu_r2c is not present")
    return {case: jax.tree_util.tree_map(
                np.asarray, JaxSolver.from_orbax_checkpoint(R2C_ORBAX, **kw).params)
            for case, kw in CASES.items()}


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


def test_committed_npz_equals_orbax_params(jax_restores):
    ref = jax_restores["best"]
    leaves = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == LEAVES
    want = from_jax_params(ref, device="cpu")
    got = load_params_npz(R2C_NPZ, Config(), device="cpu")
    pairs = list(zip(iter_leaves(got), iter_leaves(want)))
    assert len(pairs) == LEAVES
    for (path, g), (wpath, w) in pairs:
        assert path == wpath
        assert torch.equal(g, w), path


@pytest.mark.parametrize("case", list(CASES))
def test_from_orbax_checkpoint_equals_jax(jax_restores, case):
    got = IterativeSolver.from_orbax_checkpoint(R2C_ORBAX, device="cpu", **CASES[case])
    want = from_jax_params(jax_restores[case], device="cpu")
    pairs = list(zip(iter_leaves(got.params), iter_leaves(want)))
    assert len(pairs) == LEAVES
    for (path, g), (wpath, w) in pairs:
        assert path == wpath and torch.equal(g, w), path
    assert got.cfg.model == Config().model


def test_from_orbax_checkpoint_without_steps(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        IterativeSolver.from_orbax_checkpoint(str(tmp_path), device="cpu")


def test_trainer_restore_continues_the_jax_run(jax_restores, tmp_path):
    from helmnet_tpu.data.ellipses import make_dataset
    from helmnet_tpu.train import loop as jloop
    from helmnet_tpu.train.replay import ExperienceBatch as JBatch
    from helmnet_tpu_torch.train import loop as tloop
    from helmnet_tpu_torch.train.device_buffer import FIELDS
    from helmnet_tpu_torch.train.replay import ExperienceBatch
    from tests.test_training import tiny_config
    from tests.test_torch_training import PICK, port_config

    run = tmp_path / "tpu_r2c"
    shutil.copytree(R2C_ORBAX, run)
    jcfg = tiny_config()
    jt = jloop.Trainer(jcfg)
    assert jt.restore(str(run))  # the latest step, 970
    tt = tloop.Trainer(port_config(jcfg), device="cpu")
    assert tt.restore(str(run))
    assert (tt.epoch, tt.global_step) == (jt.epoch, jt.global_step) == (970, 272570)
    assert vars(tt.scheduler) == vars(jt.scheduler)
    lr = float(jt.opt_state.hyperparams["learning_rate"])
    assert tt.optimizer.param_groups[0]["lr"] == lr == pytest.approx(2.5e-5)
    adam = jt.opt_state.inner_state[2]
    mu = iter_leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, adam.mu), device="cpu"))
    nu = iter_leaves(from_jax_params(jax.tree_util.tree_map(np.asarray, adam.nu), device="cpu"))
    for (path, leaf), (_, m), (_, v) in zip(iter_leaves(tt.params), mu, nu):
        state = tt.optimizer.state[leaf]
        assert torch.equal(state["exp_avg"], m) and torch.equal(state["exp_avg_sq"], v), path
        assert float(state["step"]) == int(adam.count)

    # one train step on the same draw from JAX's buffer
    jt.fill_buffer(make_dataset(8, 32, seed=0))
    idx = np.random.default_rng(7).choice(jcfg.training.buffer_size, 4, replace=False)
    batch = JBatch(**{k: getattr(jt.buffer, k)[idx].copy() for k in FIELDS}, indices=idx)
    params = jax.tree_util.tree_map(jnp.copy, jt.params)  # donated
    new, _, _, _ = jt._train_step(params, jt.opt_state, jt.op,
                                  JBatch(*[jnp.asarray(a) for a in batch]), PICK)
    tt._train_step(ExperienceBatch(*(torch.as_tensor(a) for a in batch[:-1]), idx), PICK)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, new), device="cpu")
    for (path, a), (_, b) in zip(iter_leaves(tt.params), iter_leaves(want)):
        torch.testing.assert_close(a.detach(), b, rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()), msg=path)
    assert not torch.equal(want["inc"]["c1"]["w"],
                           from_jax_params(jax_restores["latest"], device="cpu")["inc"]["c1"]["w"])


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

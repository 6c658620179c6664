"""The port's remaining 2D entry points and public names against the JAX
package's, on the CPU: `cli/generate_dataset` (the same arrays, to the
bit), `cli/example` (the solve against JAX's on the same random default
weights, rtol 1e-3 on the rmse, tests/test_torch_iterative.py's rollout
tolerance; the CLI with a params npz, 2 iterations and a png),
`core/profiling` (`solver_roofline` equal to JAX's, `Timer`, `trace`),
the package's `__all__`, and the entry points' refusal to run without a
card when no device is given."""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

import helmnet_tpu
import helmnet_tpu_torch
from helmnet_tpu.core import profiling as jprof
from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.models import hybridnet as jh
from helmnet_tpu.train.checkpoint import save_params_npz
from helmnet_tpu_torch.core import profiling as tprof
from tests.torch_solver_cases import R2C_NPZ, one_torch_thread  # noqa: F401

# JAX public names the port does not have: none left
NOT_PORTED = set()


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn(*args)
    return rc, out.getvalue()


def test_generate_dataset_cli(tmp_path):
    from helmnet_tpu.cli import generate_dataset as jcli
    from helmnet_tpu_torch.cli import generate_dataset as tcli

    args = ["--num", "12", "--imsize", "32", "--splits", "8", "2", "2", "--seed", "3"]
    _quiet(jcli.main, args + ["--out", str(tmp_path / "jax")])
    _, text = _quiet(tcli.main, args + ["--out", str(tmp_path / "port")])
    assert "Generating 12 ellipse sos maps at 32^2" in text
    for name, count in (("trainset", 8), ("validation", 2), ("testset", 2)):
        with np.load(tmp_path / "jax" / f"{name}.npz") as j, \
                np.load(tmp_path / "port" / f"{name}.npz") as t:
            assert sorted(t.files) == sorted(j.files) == ["indices", "maps"]
            assert t["maps"].shape == (count, 32, 32)
            for key in j.files:
                assert t[key].dtype == j[key].dtype
                np.testing.assert_array_equal(t[key], j[key])


@pytest.fixture(scope="module")
def random_npz(tmp_path_factory):
    """Seeded random weights of the default config in JAX's tree (PReLU
    slopes 0.25), as the flat params npz the port reads, and the tree."""
    shapes = jax.eval_shape(lambda k: jh.init_params(k, JConfig().model),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.full(a.shape, 0.25, np.float32) if "act" in jax.tree_util.keystr(p)
        else (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes)
    path = tmp_path_factory.mktemp("weights") / "random.npz"
    save_params_npz(str(path), params)
    return str(path), params


def test_simple_scattering_against_jax(random_npz):
    """The example's 256^2 solve in both packages on the same weights."""
    from helmnet_tpu.solvers.iterative import IterativeSolver as JSolver
    from helmnet_tpu_torch.cli.example import simple_scattering
    from helmnet_tpu_torch.core.config import Config
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver

    path, jparams = random_npz
    got = simple_scattering(IterativeSolver.from_params_npz(path, Config(), device="cpu"),
                            iterations=2)
    assert got["wavefield"].shape == (256, 256, 2) and got["rmse"].shape == (2,)
    # JAX's cli/example.main, without its .ckpt load and its plot
    js = JSolver(JConfig(), params=jparams)
    source_map = np.zeros((2, 256, 256), np.float32)
    source_map[0, 30, 120:130] = 1.0
    js.set_domain_size(256, source_map=source_map[None])
    want = js.forward(got["sos"], num_iterations=2)
    np.testing.assert_allclose(got["rmse"], np.asarray(want["rmse"])[:, 0], rtol=1e-3)
    wf = np.asarray(want["wavefield"])[0]
    np.testing.assert_allclose(got["wavefield"], wf, atol=1e-3 * np.abs(wf).max())


def test_example_cli(random_npz, tmp_path):
    pytest.importorskip("matplotlib")
    from helmnet_tpu_torch.cli import example

    png = tmp_path / "wavefield.png"
    rc, text = _quiet(example.main, ["--checkpoint", random_npz[0], "--iterations", "2",
                                     "--out", str(png), "--platform", "cpu"])
    assert rc == 0
    assert text.startswith("residual RMSE: start ") and f"saved {png}" in text
    assert png.stat().st_size > 0
    # a directory is an orbax run; this one holds no step
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        example.main(["--checkpoint", str(tmp_path), "--platform", "cpu"])


def test_entry_points_raise_without_a_card(random_npz, monkeypatch):
    from helmnet_tpu_torch.cli import example, serve
    from helmnet_tpu_torch.serve import SolverService
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: SolverService.from_checkpoint(R2C_NPZ),
                 lambda: serve.main(["--checkpoint", R2C_NPZ, "--warmup"]),
                 lambda: example.main(["--checkpoint", random_npz[0]]),
                 # compare_solvers runs on its solver's device, which
                 # cannot be made without a card unless asked for
                 lambda: IterativeSolver.from_params_npz(R2C_NPZ)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("shape", [(1, 96, 96, 8, 4), (16, 256, 128, 8, 4),
                                   (4, 64, 64, 12, 3)])
def test_solver_roofline(shape):
    want = jprof.solver_roofline(*shape)
    got = tprof.solver_roofline(*shape)
    assert got.flops_per_iteration == want.flops_per_iteration
    assert got.bytes_per_iteration == want.bytes_per_iteration
    assert got.gridpoints == want.gridpoints
    assert got.gridpoints_per_s(0.25) == want.gridpoints_per_s(0.25)


def test_timer_and_trace(tmp_path):
    with tprof.Timer() as t:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        assert t.block({"y": [y, (y,)]}) is not None
    assert t.seconds > 0 and tprof._cuda_devices({"y": [y, (y,)]}) == set()
    with tprof.Timer() as t:
        pass
    assert t.seconds >= 0
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")


def test_public_names():
    """Every name of the port's `__all__` imports; the JAX names it lacks
    are exactly the not-yet-ported list, and the shared ones are the same
    kind of object (class, function or module)."""
    port, jax_names = set(helmnet_tpu_torch.__all__), set(helmnet_tpu.__all__)
    for name in port:
        assert getattr(helmnet_tpu_torch, name) is not None, name
    assert jax_names - port == NOT_PORTED
    assert port - jax_names == {"SolverPlan", "choose_solver", "solve_auto",
                                "solve_helmholtz_chunked"}
    for name in port:  # JAX's __init__ imports these four beyond its __all__
        a, b = getattr(helmnet_tpu_torch, name), getattr(helmnet_tpu, name)
        assert isinstance(a, type) == isinstance(b, type), name
        assert callable(a) == callable(b), name

"""The port's `cli/solve` against the JAX package's, on the CPU:

- on a 32^2 map it prints JAX's plan (method and kwargs), solves it and
  writes `--out`, whose wavefield is JAX's within 2e-3 max|u|
  (tests/test_gmres.py:35) and whose trajectory ends below the tolerance;
- with the trained weights (JAX's orbax directory, which the port reads
  too, and the port's npz of it) both choose the learned plan, and the
  port's learned solve runs to its end at 96^2;
- a 24^3 cube takes JAX's 3D plan (`cslp3d`) and the same solution
  within 2e-3 max|u| when both read the source from `--source-npz` (JAX's
  CLI cannot build its default 3D source: its `cli/solve.py:105` imports
  a module that does not exist), and the port builds the default point
  source itself;
- a directory with no checkpoint step raises FileNotFoundError, and a
  source of the wrong shape raises SystemExit.
"""

import numpy as np
import pytest

from helmnet_tpu.cli import solve as jsolve
from helmnet_tpu_torch.cli import solve as tsolve
from tests.torch_solver_cases import R2C_NPZ, R2C_ORBAX, ROOT, as_complex
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

TESTSET_96 = f"{ROOT}/datasets/splitted_96/testset.npz"


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    rng = np.random.default_rng(0)
    sos = np.ones((3, 32, 32), np.float32)
    sos[:, 8:24, 8:24] += 0.3 * rng.random((3, 16, 16), np.float32)
    path = tmp_path_factory.mktemp("maps") / "maps.npz"
    np.savez(path, maps=sos)
    return str(path)


def _plan(out: str) -> tuple[str, str]:
    lines = out.splitlines()
    method = next(l for l in lines if l.startswith("plan: ")).split(": ", 1)[1]
    kwargs = next(l for l in lines if l.strip().startswith("kwargs:")).split(":", 1)[1]
    return method, kwargs.strip()


def test_cslp_plan_matches_jax(maps, tmp_path, capsys):
    args = ["--sos", maps, "--index", "1", "--tol", "1e-6"]
    assert jsolve.main(args + ["--out", str(tmp_path / "jax.npz")]) == 0
    jplan = _plan(capsys.readouterr().out)
    assert tsolve.main(args + ["--platform", "cpu", "--out", str(tmp_path / "port.npz")]) == 0
    plan = _plan(capsys.readouterr().out)
    assert plan == jplan and plan[0] == "cslp"
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as ref:
        assert set(got.files) == set(ref.files)
        assert str(got["method"]) == "cslp"
        assert got["wavefield"].shape == (32, 32, 2)
        traj = got["trajectory"]
        assert traj[-1] / traj[0] < 1e-3
        want = as_complex(ref["wavefield"])
        np.testing.assert_allclose(as_complex(got["wavefield"]), want,
                                   atol=2e-3 * np.abs(want).max())


def test_learned_plan_with_the_trained_weights(maps, tmp_path, capsys):
    import os

    if not os.path.isdir(R2C_ORBAX):
        pytest.skip("checkpoints/tpu_r2c is not present")
    assert jsolve.main(["--sos", maps, "--checkpoint", R2C_ORBAX, "--dry-run"]) == 0
    jplan = _plan(capsys.readouterr().out)
    for ckpt in (R2C_ORBAX, R2C_NPZ):
        assert tsolve.main(["--sos", maps, "--checkpoint", ckpt, "--dry-run",
                            "--platform", "cpu"]) == 0
        assert _plan(capsys.readouterr().out) == jplan
    assert jplan[0] == "learned"


def test_learned_solve_runs(tmp_path, capsys):
    """At 96^2: both packages' learned branch builds the default solver,
    whose point source (82, 48) lies outside grids below 83^2."""
    out = tmp_path / "learned.npz"
    assert tsolve.main(["--sos", TESTSET_96, "--checkpoint", R2C_NPZ, "--platform", "cpu",
                        "--out", str(out)]) == 0
    assert "learned rollout: best residual RMSE" in capsys.readouterr().out
    with np.load(out) as f:
        assert str(f["method"]) == "learned"
        assert f["trajectory"].shape == (1000,) and np.all(np.isfinite(f["trajectory"]))
        assert f["trajectory"].min() < f["trajectory"][0]
        assert f["wavefield"].shape == (96, 96, 2)


def test_refusals(maps, tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tsolve.main(["--sos", maps, "--checkpoint", str(tmp_path), "--platform", "cpu"])
    bad = tmp_path / "src.npz"
    np.savez(bad, src=np.zeros((16, 16, 2), np.float32))
    with pytest.raises(SystemExit, match="does not match"):
        tsolve.main(["--sos", maps, "--source-npz", str(bad), "--platform", "cpu"])


def test_3d_cube_against_jax(tmp_path, capsys):
    from helmnet_tpu_torch.ops.spectral3d import point_source_map3d

    n = 24
    rng = np.random.default_rng(1)
    sos = np.ones((n, n, n), np.float32)
    sos[8:16, 8:16, 8:16] += 0.5 * rng.random((8, 8, 8), np.float32)
    cube = tmp_path / "cube.npz"
    np.savez(cube, maps=sos)
    # the CLI's default source: the 2D default scaled, mid-depth in x
    src = point_source_map3d(n, n, n, (20, 12, 12), 10.0, 0.0, 1.0)
    src_npz = tmp_path / "src.npz"
    np.savez(src_npz, src=src)
    args = ["--sos", str(cube), "--source-npz", str(src_npz)]
    assert jsolve.main(args + ["--out", str(tmp_path / "jax.npz")]) == 0
    jplan = _plan(capsys.readouterr().out)
    assert tsolve.main(args + ["--platform", "cpu", "--out", str(tmp_path / "port.npz")]) == 0
    assert _plan(capsys.readouterr().out) == jplan and jplan[0] == "cslp3d"
    assert tsolve.main(["--sos", str(cube), "--platform", "cpu",
                        "--out", str(tmp_path / "default.npz")]) == 0
    out = capsys.readouterr().out
    assert "cslp3d: rel residual" in out and "saved" in out
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as ref, \
            np.load(tmp_path / "default.npz") as default:
        assert str(got["method"]) == "cslp3d" and got["wavefield"].shape == (n, n, n, 2)
        assert got["trajectory"][-1] / got["trajectory"][0] < 1e-4
        want = as_complex(ref["wavefield"])
        np.testing.assert_allclose(as_complex(got["wavefield"]), want,
                                   atol=2e-3 * np.abs(want).max())
        np.testing.assert_array_equal(default["wavefield"], got["wavefield"])

"""The port's hybrid solver (solvers/hybrid.py: a learned warm start, then
a GMRES polish for each sample) against the JAX package's, on the CPU, at
32^2 x 2 with the tpu_r2c weights, with the bare polish and with the CSLP
polish as defect correction:

- the warm start's best rmse within rtol 1e-3 of JAX's (the rollout's
  tolerance, tests/test_torch_iterative.py);
- the polished fields within 2e-2 max|u| of JAX's (tests/test_fgmres.py:73),
  both at the tolerance, with the same Krylov iterations;
- the reported relative residuals equal to the true ones within rtol 1e-3
  (tests/test_fgmres.py:56).
"""

import numpy as np
import pytest
import torch

from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers import hybrid as jhy
from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
from helmnet_tpu_torch.solvers import hybrid as thy
from tests.torch_solver_cases import (
    N, PML, as_complex, configs, heterogeneous, r2c_params,
)
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

B, TOL = 2, 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(precision="highest")
    jparams, tparams = r2c_params(jcfg, tcfg)
    sos0, src0 = heterogeneous(seed=3)
    sos1, _ = heterogeneous(seed=4)
    sos = np.stack([sos0, sos1])
    src = np.stack([src0, src0])
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, sos=sos, src=src)


def _relres(op, field, k_sq, src) -> np.ndarray:
    r = helmholtz_residual(op, field, k_sq, src, "matmul")
    return (torch.linalg.vector_norm(r.reshape(len(r), -1), dim=1)
            / torch.linalg.vector_norm(src.reshape(len(src), -1), dim=1)).numpy()


@pytest.mark.parametrize("precond", ["none", "shifted_laplace"])
def test_matches_jax(setup, precond):
    s = setup
    kw = dict(learned_iterations=10, restart=40, max_restarts=10, tol=TOL, precond=precond)
    ref = jhy.solve_hybrid(s["jparams"], jmake_operator(N, N, PML, 2.0, 1.0), s["src"],
                           s["sos"], cfg=s["jcfg"], **kw)
    top = make_operator(N, N, PML, 2.0, 1.0, device="cpu")
    got = thy.solve_hybrid(s["tparams"], top, s["src"], s["sos"], cfg=s["tcfg"],
                           device="cpu", **kw)
    assert got.wavefield.shape == (B, N, N, 2)
    np.testing.assert_allclose(got.warm_rmse.numpy(), np.asarray(ref.warm_rmse), rtol=1e-3)
    rel = got.final_relres.numpy()
    assert np.all(rel <= TOL) and np.all(np.asarray(ref.final_relres) <= TOL)
    np.testing.assert_array_equal(got.gmres_iterations.numpy(),
                                  np.asarray(ref.gmres_iterations))
    want = as_complex(ref.wavefield)
    np.testing.assert_allclose(as_complex(got.wavefield.numpy()), want,
                               atol=2e-2 * np.abs(want).max())
    k_sq = torch.from_numpy((1.0 / s["sos"]) ** 2)
    src = torch.from_numpy(s["src"])
    np.testing.assert_allclose(_relres(top, got.wavefield, k_sq, src), rel,
                               rtol=1e-3, atol=1e-8)

"""The port's deflated restarted GMRES (solvers/deflation.py, GCRO-DR)
against the JAX package's, on the CPU:

- `solve_helmholtz_deflated` on the spectral operator and on the order-4
  FD stencil operator (plain and CSLP-preconditioned on the spectral one)
  equals the direct solve of the same system (`assemble_dense`, or scipy
  on `stencil_to_csr`) within 5e-3 max|u| (tests/test_deflation.py:108),
  and its first cycle is within rtol 1e-4 of JAX's;
- `gmres_deflated` on tests/test_deflation.py's isolated-spectrum matrix:
  the harmonic-Ritz values within rtol 0.1 of JAX's (:77), the restart
  stagnation broken (:55-57), and the reported residual norms equal to
  the true ones (:91).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from helmnet_tpu.ops.source import point_source_map
from helmnet_tpu.ops.spectral import assemble_dense
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.ops.stencil import make_stencil_operator as jmake_stencil
from helmnet_tpu.solvers import deflation as jd
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.ops.stencil import make_stencil_operator
from helmnet_tpu_torch.ops.stencil_residual import stencil_to_csr
from helmnet_tpu_torch.solvers import deflation as td
from helmnet_tpu_torch.solvers import gmres as tg
from tests.torch_solver_cases import as_complex
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

N, PML = 32, 4
DIRECT_ATOL = 5e-3  # * max|u|, tests/test_deflation.py:108
FIRST_RTOL = 1e-4


def _helmholtz():
    """tests/test_deflation.py:95-100."""
    sos = np.ones((N, N), np.float32)
    sos[10:24, 8:26] = 1.5
    k_sq = (1.0 / sos) ** 2
    src = np.asarray(point_source_map(N, N, (N - 8, N // 2), 10.0))
    return k_sq, src


OPERATORS = {
    "spectral": dict(),
    "spectral cslp": dict(precond="shifted_laplace"),
    "stencil": dict(),
}


@pytest.mark.parametrize("case", list(OPERATORS))
def test_matches_direct_solve(case):
    k_sq, src = _helmholtz()
    b = as_complex(src).ravel()
    if case.startswith("stencil"):
        jop = jmake_stencil(N, N, PML, 2.0, 1.0, order=4)
        top = make_stencil_operator(N, N, PML, 2.0, 1.0, order=4, device="cpu")
        u = spla.spsolve(stencil_to_csr(top, k_sq).tocsc(), b).reshape(N, N)
    else:
        jop = jmake_operator(N, N, PML, 2.0, 1.0)
        top = make_operator(N, N, PML, 2.0, 1.0, device="cpu")
        u = np.linalg.solve(assemble_dense(N, N, PML, 2.0, 1.0, k_sq=k_sq), b).reshape(N, N)
    kw = dict(restart=25, k=6, max_cycles=30, tol=1e-7, **OPERATORS[case])
    ref = jd.solve_helmholtz_deflated(jop, jnp.asarray(k_sq), jnp.asarray(src), **kw)
    got = td.solve_helmholtz_deflated(top, k_sq, src, device="cpu", **kw)
    assert got.x.shape == (N, N, 2) and got.x.dtype == torch.float32
    np.testing.assert_allclose(as_complex(got.x.numpy()), u, atol=DIRECT_ATOL * np.abs(u).max())
    np.testing.assert_allclose(got.residual_norms[:2], ref.residual_norms[:2],
                               rtol=FIRST_RTOL)
    assert got.iterations > 0 and len(got.ritz_values) == 6


def _isolated_spectrum_problem(n=400, n_small=6, seed=0):
    """tests/test_deflation.py:23: a normal matrix, an indefinite complex
    arc of eigenvalues and a few isolated tiny ones."""
    rng = np.random.default_rng(seed)
    small = np.array([1e-3, -2e-3, 3e-3j, 5e-3, -8e-3j, 1.5e-2])[:n_small]
    bulk = (np.exp(1j * rng.uniform(-1.2, 1.2, n - n_small))
            * rng.uniform(0.5, 3.0, n - n_small))
    d = np.concatenate([small, bulk]).astype(np.complex128)
    Q = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))[0]
    A = (Q * d) @ Q.conj().T
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A.astype(np.complex64), b.astype(np.complex64), np.sort(np.abs(small))


def test_ritz_values_match_jax():
    A, b, small = _isolated_spectrum_problem()
    kw = dict(restart=20, k=8, max_cycles=20, tol=1e-12)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    ref = jd.gmres_deflated(lambda v: Aj @ v, jnp.asarray(b), **kw)
    got = td.gmres_deflated(lambda v: At @ v, torch.from_numpy(b), **kw)
    want = np.sort(np.abs(ref.ritz_values))[: len(small)]
    have = np.sort(np.abs(got.ritz_values))[: len(small)]
    np.testing.assert_allclose(have, want, rtol=0.1)
    assert np.all(have < 0.05)
    np.testing.assert_allclose(have[-1], small[-1], rtol=0.1)


def test_breaks_restart_stagnation():
    A, b, _ = _isolated_spectrum_problem()
    At = torch.from_numpy(A)
    mv = lambda v: At @ v
    bt = torch.from_numpy(b)
    bn = float(np.linalg.norm(b))
    plain = tg.gmres_restarted(mv, bt, restart=20, max_restarts=30, tol=1e-12)
    trace = []
    defl = td.gmres_deflated(mv, bt, restart=20, k=8, max_cycles=30, tol=1e-12,
                             debug_trace=trace)
    plain_final = float(plain.residual_norms[-1]) / bn
    defl_final = defl.residual_norms[-1] / bn
    assert plain_final > 1e-2
    assert defl_final < 1e-4 and defl_final < plain_final / 100
    # the recycle space after the last of 30 cycles: C stays orthonormal up
    # to the f32 drift of its refreshes
    U, C, _ = trace[-1]
    assert U.shape == (400, 8) and C.shape == (8, 400)
    np.testing.assert_allclose(C.conj() @ C.T, np.eye(8), atol=1e-3)


def test_true_residual_norms():
    """tests/test_deflation.py:82-91."""
    A, b, _ = _isolated_spectrum_problem(n=200)
    At = torch.from_numpy(A)
    res = td.gmres_deflated(lambda v: At @ v, torch.from_numpy(b), restart=15, k=5,
                            max_cycles=10, tol=1e-12)
    r = np.linalg.norm(b - A @ res.x.numpy())
    assert abs(r - res.residual_norms[-1]) < 1e-6 * np.linalg.norm(b)


def test_refuses_k_outside_restart():
    with pytest.raises(ValueError, match="0 < k < restart"):
        td.gmres_deflated(lambda v: v, torch.ones(4, dtype=torch.complex64), restart=4, k=4)

"""The port's flexible GMRES (solvers/fgmres.py) against the JAX package's,
on the CPU, on the 32^2 heterogeneous problem of tests/test_twolevel.py:

- `solve_fgmres` under the CSLP inverse with each cycle kind: the device
  cycle (f32 least squares where the vectors live), the host cycle (CGS2,
  complex128 least squares on the host) and the recycled host cycle
  (FGCRO-DR, recycle_k=2);
- `solve_fgmres_learned` with the tpu_r2c weights at 32^2, and one
  application of the learned preconditioner with JAX's random init
  weights (random weights make no preconditioner: the network's output
  barely depends on its input, the Krylov basis is near-singular, and the
  least-squares solution then rests on round-off, so FGMRES itself is held
  with trained weights);
- each with the first cycle's residual norms within rtol 1e-4 of JAX's,
  the final solution within 2e-2 max|u| of JAX's (tests/test_fgmres.py:73)
  and the reported residual equal to the true one within rtol 1e-3
  (tests/test_fgmres.py:56);
- the cycle loop's options with the JAX meaning: `on_cycle`, `budget_s`,
  `keep_x_complex` with a complex `x0` to continue, `recycle_state`
  across calls, and the recycle_k refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers import fgmres as jf
from helmnet_tpu.solvers import precond as jp
from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
from helmnet_tpu_torch.solvers import fgmres as tf
from helmnet_tpu_torch.solvers.precond import make_shifted_laplace_inverse
from tests.torch_solver_cases import (
    N, PML, as_complex, configs, heterogeneous, r2c_params, random_params,
)
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

FIRST_RTOL = 1e-4  # the first cycle's residual norms against JAX's
SOLUTION_ATOL = 2e-2  # * max|u|, tests/test_fgmres.py:73
TRUE_RTOL = 1e-3  # reported against true residual, tests/test_fgmres.py:56

CYCLES = {
    "device": dict(),
    "host": dict(host_arnoldi=True),
    "recycled": dict(host_arnoldi=True, recycle_k=2),
}


@pytest.fixture(scope="module")
def problem():
    jcfg, tcfg = configs(precision="highest")
    sos, src = heterogeneous()
    k_sq = (1.0 / sos) ** 2
    jop = jmake_operator(N, N, PML, 2.0, 1.0)
    top = make_operator(N, N, PML, 2.0, 1.0, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, sos=sos, src=src, k_sq=k_sq, jop=jop, top=top)


def true_relres(pb, wavefield) -> float:
    r = helmholtz_residual(pb["top"], wavefield[None], torch.from_numpy(pb["k_sq"])[None],
                           torch.from_numpy(pb["src"])[None], "matmul")
    return float(torch.linalg.vector_norm(r) / np.linalg.norm(pb["src"]))


def check_against_jax(pb, got, ref, converged=True):
    norms, want_norms = got.residual_norms.numpy(), np.asarray(ref.residual_norms)
    np.testing.assert_allclose(norms[:2], want_norms[:2], rtol=FIRST_RTOL)
    np.testing.assert_allclose(true_relres(pb, got.wavefield), norms[-1],
                               rtol=TRUE_RTOL, atol=1e-8)
    assert np.all(np.isfinite(norms)) and norms[-1] < norms[0]
    if converged:
        want = as_complex(ref.wavefield)
        np.testing.assert_allclose(as_complex(got.wavefield.numpy()), want,
                                   atol=SOLUTION_ATOL * np.abs(want).max())


@pytest.mark.parametrize("kind", list(CYCLES))
def test_cslp_preconditioned(problem, kind):
    pb = problem
    kw = dict(restart=16, max_restarts=12, tol=1e-5, **CYCLES[kind])
    jminv = jp.make_shifted_laplace_inverse(pb["jop"], jnp.asarray(pb["k_sq"]))
    tminv = make_shifted_laplace_inverse(pb["top"], torch.from_numpy(pb["k_sq"]))
    ref = jf.solve_fgmres(pb["jop"], pb["src"], pb["sos"], cfg=pb["jcfg"],
                          precond_field=jminv, **kw)
    got = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], cfg=pb["tcfg"],
                          precond_field=tminv, device="cpu", **kw)
    assert got.wavefield.shape == (N, N, 2)
    assert got.iterations == ref.iterations
    assert got.residual_norms[-1] < 1e-5
    assert (got.recycle_state is None) == (kind != "recycled")
    check_against_jax(pb, got, ref)


@pytest.mark.parametrize("host_arnoldi", [False, True])
def test_learned_preconditioner(problem, host_arnoldi):
    pb = problem
    jparams, tparams = r2c_params(pb["jcfg"], pb["tcfg"])
    kw = dict(inner_iterations=4, restart=4, max_restarts=3, tol=0.0,
              host_arnoldi=host_arnoldi)
    ref = jf.solve_fgmres_learned(jparams, pb["jop"], pb["src"], pb["sos"],
                                  cfg=pb["jcfg"], **kw)
    got = tf.solve_fgmres_learned(tparams, pb["top"], pb["src"], pb["sos"],
                                  cfg=pb["tcfg"], device="cpu", **kw)
    assert got.iterations == ref.iterations == 12
    check_against_jax(pb, got, ref, converged=False)
    np.testing.assert_allclose(got.residual_norms.numpy(),
                               np.asarray(ref.residual_norms), rtol=1e-2)


def test_learned_preconditioner_single_application(problem):
    """One application on a random complex vector, and its scale
    invariance: A^-1 (c v) = c A^-1 v through the amplitude normalisation;
    a zero vector is not scaled, as in JAX."""
    pb = problem
    jparams, tparams = random_params(pb["jcfg"], seed=2)
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))).astype(np.complex64)
    japply = jf.make_learned_preconditioner(jparams, pb["jop"], pb["sos"],
                                            cfg=pb["jcfg"], iterations=3)
    tapply = tf.make_learned_preconditioner(tparams, pb["top"], pb["sos"],
                                            cfg=pb["tcfg"], iterations=3, device="cpu")
    want = np.asarray(japply(jnp.asarray(v)))
    got = tapply(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(tapply(torch.from_numpy(v) * 1e-3).numpy(), got * 1e-3,
                               atol=1e-9 * np.abs(want).max() + 1e-6 * np.abs(got).max())
    zero = np.zeros((N, N), np.complex64)
    want0 = np.asarray(japply(jnp.asarray(zero)))
    np.testing.assert_allclose(tapply(torch.from_numpy(zero)).numpy(), want0,
                               atol=1e-4 * np.abs(want0).max())


def test_cycle_loop_options(problem):
    pb = problem
    tminv = make_shifted_laplace_inverse(pb["top"], torch.from_numpy(pb["k_sq"]))
    base = dict(cfg=pb["tcfg"], precond_field=tminv, restart=5, tol=0.0, device="cpu")
    seen = []
    full = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], max_restarts=4,
                           on_cycle=seen.append, **base)
    assert [len(s) for s in seen] == [2, 3, 4, 5]
    assert seen[-1] == pytest.approx(full.residual_norms.tolist())
    # budget_s: the loop stops before a cycle once the budget is spent
    none = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], max_restarts=4,
                           budget_s=-1.0, **base)
    assert none.iterations == 0 and len(none.residual_norms) == 1
    # keep_x_complex returns the flat complex iterate; as x0 it continues
    half = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], max_restarts=2,
                           keep_x_complex=True, **base)
    assert half.wavefield.is_complex() and half.wavefield.shape == (N * N,)
    rest = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], max_restarts=2,
                           x0=half.wavefield, **base)
    np.testing.assert_allclose(rest.residual_norms[0], half.residual_norms[-1], rtol=1e-6)
    np.testing.assert_allclose(rest.residual_norms.numpy(),
                               full.residual_norms.numpy()[2:], rtol=1e-3)
    # a channel-pair x0 is taken as well
    again = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], max_restarts=0,
                            x0=rest.wavefield, **base)
    np.testing.assert_allclose(again.residual_norms[0], rest.residual_norms[-1], rtol=1e-6)


def test_recycle_state_across_calls(problem):
    """The (U, C) pair of one call seeds the next, as JAX's does: the second
    call's first cycle is already a recycled one, and both packages agree
    on it."""
    pb = problem
    jminv = jp.make_shifted_laplace_inverse(pb["jop"], jnp.asarray(pb["k_sq"]))
    tminv = make_shifted_laplace_inverse(pb["top"], torch.from_numpy(pb["k_sq"]))
    kw = dict(restart=6, max_restarts=2, tol=0.0, host_arnoldi=True, recycle_k=2)
    j1 = jf.solve_fgmres(pb["jop"], pb["src"], pb["sos"], cfg=pb["jcfg"],
                         precond_field=jminv, **kw)
    t1 = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], cfg=pb["tcfg"],
                         precond_field=tminv, device="cpu", **kw)
    U, C = t1.recycle_state
    assert U.shape == (2, N * N) and C.shape == (2, N * N)
    # C is orthonormal and C = A U: a property of A alone
    np.testing.assert_allclose((C.conj() @ C.T).numpy(), np.eye(2), atol=1e-4)
    j2 = jf.solve_fgmres(pb["jop"], pb["src"], pb["sos"], cfg=pb["jcfg"],
                         precond_field=jminv, recycle_state=j1.recycle_state, **kw)
    t2 = tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], cfg=pb["tcfg"],
                         precond_field=tminv, device="cpu",
                         recycle_state=t1.recycle_state, **kw)
    np.testing.assert_allclose(t2.residual_norms.numpy()[:2],
                               np.asarray(j2.residual_norms)[:2], rtol=1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(recycle_k=2), "requires host_arnoldi"),
    (dict(recycle_k=6, host_arnoldi=True), "0 < recycle_k < restart"),
])
def test_recycle_refusals(problem, kw, match):
    pb = problem
    tminv = make_shifted_laplace_inverse(pb["top"], torch.from_numpy(pb["k_sq"]))
    with pytest.raises(ValueError, match=match):
        tf.solve_fgmres(pb["top"], pb["src"], pb["sos"], cfg=pb["tcfg"],
                        precond_field=tminv, restart=6, device="cpu", **kw)

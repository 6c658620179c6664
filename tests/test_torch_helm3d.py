"""The port's 3D CSLP-GMRES (`solvers/helm3d.py`) against the JAX
package's, on the CPU, on tests/test_spectral3d.py's problems. Solutions
are compared, not histories (ROADMAP Queue C 4): the same solution within
2e-3 max|u| (tests/test_gmres.py:35) and both within 5e-3 max|u| of a
dense direct solve (tests/test_spectral3d.py:92); the reported residuals
equal the true ones (rtol 2e-2, tests/test_spectral3d.py:113); the batch
equals single solves; the CSLP inverse equals JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.ops import spectral3d as js
from helmnet_tpu.solvers import helm3d as jh
from helmnet_tpu_torch.ops import spectral3d as ts
from helmnet_tpu_torch.solvers import helm3d as th
from tests.torch_solver_cases import as_complex
from tests.torch_solver_cases import one_torch_thread  # noqa: F401


def tiny_problem(d=10, h=12, w=14, pml=3):
    """tests/test_spectral3d.py:24."""
    sos = np.ones((d, h, w), np.float32)
    sos[3:6, 4:8, 5:10] = 1.5
    k_sq = (1.0 / sos) ** 2
    src = ts.point_source_map3d(d, h, w, (d - 4, h // 2, w // 2), 10.0)
    return (js.make_operator3d(d, h, w, pml, 2.0, 1.0),
            ts.make_operator3d(d, h, w, pml, 2.0, 1.0, device="cpu"), k_sq, src, pml)


@pytest.fixture(scope="module")
def direct():
    jop, top, k_sq, src, pml = tiny_problem()
    M = ts.assemble_dense3d(*k_sq.shape, pml, 2.0, 1.0, k_sq=k_sq)
    return np.linalg.solve(M, as_complex(src).ravel()).reshape(k_sq.shape)


@pytest.mark.parametrize("precond", ["none", "shifted_laplace"])
@pytest.mark.parametrize("mode", ["matmul", "fft"])
def test_solve_against_jax_and_direct(direct, precond, mode):
    jop, top, k_sq, src, _ = tiny_problem()
    kw = dict(restart=30, max_restarts=8, tol=1e-7, precond=precond, mode=mode)
    ref = jh.solve_helmholtz3d(jop, k_sq, src, **kw)
    got = th.solve_helmholtz3d(top, k_sq, src, device="cpu", **kw)
    assert tuple(got.x.shape) == (10, 12, 14, 2)
    assert tuple(got.checkpoints.shape) == np.asarray(ref.checkpoints).shape
    assert tuple(got.residual_norms.shape) == np.asarray(ref.residual_norms).shape
    u = as_complex(np.asarray(ref.x))
    np.testing.assert_allclose(as_complex(got.x.numpy()), u, atol=2e-3 * np.abs(u).max())
    scale = np.abs(direct).max()
    np.testing.assert_allclose(as_complex(got.x.numpy()), direct, atol=5e-3 * scale)
    # the reported norm is the true residual of the returned solution
    r = ts.helmholtz_residual3d(top, got.x, torch.from_numpy(k_sq), torch.from_numpy(src))
    np.testing.assert_allclose(float(torch.linalg.vector_norm(r)),
                               float(got.residual_norms[-1]), rtol=2e-2)
    # the last checkpoint is the solution
    np.testing.assert_allclose(got.checkpoints[-1].numpy(), got.x.numpy(), rtol=1e-6,
                               atol=1e-6 * float(got.x.abs().max()))


def test_cslp_inverse_against_jax():
    jop, top, k_sq, _, _ = tiny_problem()
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(k_sq.shape) + 1j * rng.standard_normal(k_sq.shape)).astype(
        np.complex64)
    for kref in ("mean", "max"):
        ref = np.asarray(jh.make_shifted_laplace_inverse3d(jop, jnp.asarray(k_sq), kref=kref)(
            jax.lax.complex(jnp.asarray(v.real), jnp.asarray(v.imag))))
        got = th.make_shifted_laplace_inverse3d(top, torch.from_numpy(k_sq), kref=kref)(
            torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_batch_equals_single_solves():
    """tests/test_spectral3d.py:119-129, and each problem of the batch
    against its own single solve and against JAX's vmapped batch."""
    jop, top, k_sq, src, _ = tiny_problem()
    k_batch = np.stack([k_sq, (1.0 / 1.2) ** 2 * np.ones_like(k_sq)])
    s_batch = np.stack([src, src])
    kw = dict(restart=20, max_restarts=12, tol=1e-6, precond="shifted_laplace")
    ref = jh.solve_helmholtz3d_batch(jop, k_batch, s_batch, **kw)
    got = th.solve_helmholtz3d_batch(top, k_batch, s_batch, device="cpu", **kw)
    for field in ("x", "residual_norms", "checkpoints", "iterations"):
        assert tuple(getattr(got, field).shape) == np.asarray(getattr(ref, field)).shape
    rel = got.residual_norms[:, -1].numpy() / np.linalg.norm(src)
    assert (rel < 1e-4).all(), rel
    for i in range(2):
        one = th.solve_helmholtz3d(top, k_batch[i], s_batch[i], device="cpu", **kw)
        u = one.x.numpy()
        np.testing.assert_allclose(got.x[i].numpy(), u, atol=1e-3 * np.abs(u).max())
        w = np.asarray(ref.x[i])
        np.testing.assert_allclose(got.x[i].numpy(), w, atol=2e-3 * np.abs(w).max())


def test_complex_source_and_refusal():
    _, top, k_sq, src, _ = tiny_problem()
    kw = dict(restart=10, max_restarts=2, device="cpu")
    a = th.solve_helmholtz3d(top, k_sq, src, **kw)
    b = th.solve_helmholtz3d(top, k_sq, torch.from_numpy(as_complex(src)).to(torch.complex64),
                             **kw)
    assert torch.equal(a.x, b.x)
    with pytest.raises(ValueError, match="unknown precond"):
        th.solve_helmholtz3d(top, k_sq, src, precond="ilu", **kw)

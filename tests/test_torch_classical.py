"""The port's classical building blocks and front end against the JAX
package's, on the CPU:

- `ops/spectral.assemble_dense` at 16^2 and 24^2 (rtol 1e-6);
- `solvers/precond.solve_helmholtz_refined` at 24^2: both reach tol 1e-10
  in float64 and their solutions agree within 1e-6 max|u|;
- `solvers/twolevel.resize_complex` (jax.image.resize 'linear', antialiased
  when downsampling) and `spectral_resize_complex` at 1e-6 max|ref|, odd
  and even sizes, factors 2 and 4, up and down;
- `solvers/auto.choose_solver`: JAX's `method` and `kwargs` on every case
  of tests/test_solve_auto.py, 3D included, with the port's `solve_auto`
  raising NotImplementedError for 3D;
- `solve_auto` end to end at 32^2 (the CSLP plan) against JAX's: both
  below tests/test_solve_auto.py's 1e-3 and the same solution within
  2e-3 max|u| (tests/test_gmres.py:35).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.core.config import GeometryConfig as JGeometry
from helmnet_tpu.ops import spectral as jspec
from helmnet_tpu.solvers import auto as jauto
from helmnet_tpu.solvers import precond as jprecond
from helmnet_tpu.solvers import twolevel as jtwo
from helmnet_tpu_torch.core.config import Config as TConfig
from helmnet_tpu_torch.core.config import GeometryConfig as TGeometry
from helmnet_tpu_torch.ops import spectral as tspec
from helmnet_tpu_torch.solvers import auto as tauto
from helmnet_tpu_torch.solvers import precond as tprecond
from helmnet_tpu_torch.solvers import twolevel as ttwo
from tests.torch_solver_cases import as_complex
from tests.torch_solver_cases import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n", [16, 24])
def test_assemble_dense(n):
    rng = np.random.default_rng(n)
    k_sq = rng.uniform(0.4, 1.0, (n, n)).astype(np.float32)
    ref = jspec.assemble_dense(n, n, 4, 2.0, 1.0, k_sq=k_sq)
    got = tspec.assemble_dense(n, n, 4, 2.0, 1.0, k_sq=k_sq)
    assert got.dtype == np.complex128 and got.shape == (n * n, n * n)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tspec.assemble_dense(n, n, 4, 2.0, 1.0),
                               jspec.assemble_dense(n, n, 4, 2.0, 1.0), rtol=1e-6)


def test_solve_helmholtz_refined():
    n, pml = 24, 4
    sos = np.ones((n, n), np.float32)
    sos[8:16, 6:18] = 1.5
    k_sq = (1.0 / sos) ** 2
    src = np.zeros((n, n, 2), np.float32)
    src[n - 6, n // 2, 0] = 10.0
    geo = JGeometry(domain_size=n, pml_size=pml, sigma_max=2.0)
    kw = dict(tol=1e-10, inner_restart=30, inner_max_restarts=10)
    x_ref, n_ref = jprecond.solve_helmholtz_refined(
        jspec.make_operator(n, n, pml, 2.0, 1.0), geo, 1.0, k_sq, src, **kw)
    x, norms = tprecond.solve_helmholtz_refined(
        tspec.make_operator(n, n, pml, 2.0, 1.0, device="cpu"),
        TGeometry(domain_size=n, pml_size=pml, sigma_max=2.0), 1.0, k_sq, src,
        device="cpu", **kw)
    assert x.dtype == np.complex128
    bnorm = np.linalg.norm(as_complex(src))
    assert norms[-1] <= 1e-10 * bnorm and n_ref[-1] <= 1e-10 * bnorm
    assert len(norms) <= len(n_ref) + 1
    # the f64 defect is the true residual of the dense system
    M = tspec.assemble_dense(n, n, pml, 2.0, 1.0, k_sq=k_sq)
    true = np.linalg.norm(M @ x.ravel() - as_complex(src).ravel())
    np.testing.assert_allclose(true, norms[-1], rtol=1e-2)
    np.testing.assert_allclose(x, x_ref, atol=1e-6 * np.abs(x_ref).max())


RESIZES = [((24, 24), (12, 12)), ((12, 12), (24, 24)), ((32, 32), (8, 8)),
           ((8, 8), (32, 32)), ((15, 15), (7, 7)), ((7, 7), (15, 15)),
           ((21, 14), (7, 28)), ((25, 13), (50, 26))]


# the spectral resize goes up or down on both axes at once
RESIZE_CASES = [("linear", a, b) for a, b in RESIZES] + [
    ("spectral", a, b) for a, b in RESIZES if (b[0] <= a[0]) == (b[1] <= a[1])]


@pytest.mark.parametrize("kind,src_shape,dst_shape", RESIZE_CASES)
def test_resize(kind, src_shape, dst_shape):
    rng = np.random.default_rng(sum(src_shape) + sum(dst_shape))
    v = (rng.standard_normal(src_shape) + 1j * rng.standard_normal(src_shape)
         ).astype(np.complex64)
    jfn, tfn = ((jtwo.resize_complex, ttwo.resize_complex) if kind == "linear"
                else (jtwo.spectral_resize_complex, ttwo.spectral_resize_complex))
    ref = np.asarray(jfn(jax.lax.complex(jnp.asarray(v.real), jnp.asarray(v.imag)),
                         dst_shape))
    got = tfn(torch.from_numpy(v), dst_shape).numpy()
    assert got.shape == dst_shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _sos(n, contrast=0.0, d3=False):
    """tests/test_solve_auto.py:16."""
    shape = (n, n, n) if d3 else (n, n)
    sos = np.ones(shape, np.float32)
    if contrast:
        c = tuple(slice(s // 4, 3 * s // 4) for s in shape)
        rng = np.random.default_rng(0)
        sos[c] = 1.0 + contrast * rng.random(sos[c].shape, np.float32)
    return sos


def _extreme_3d():
    sos = _sos(64, d3=True)
    sos[16:48, 16:48, 16:48] = 4.0
    return sos


# every choose_solver case of tests/test_solve_auto.py: (sos maker, params)
POLICY_CASES = [
    ("96 contrast 1 ckpt", lambda: _sos(96, 1.0), True),
    ("96 contrast 1", lambda: _sos(96, 1.0), False),
    ("512 contrast 0.3 ckpt", lambda: _sos(512, 0.3), True),
    ("512 contrast 1 ckpt", lambda: _sos(512, 1.0), True),
    ("1024 contrast 0.3 ckpt", lambda: _sos(1024, 0.3), True),
    ("2048 ckpt", lambda: _sos(2048), True),
    ("4096", lambda: _sos(4096), False),
    ("2048", lambda: _sos(2048), False),
    ("1024 contrast 1 ckpt", lambda: _sos(1024, 1.0), True),
    ("1024 contrast 1", lambda: _sos(1024, 1.0), False),
    ("8192", lambda: _sos(8192), False),
    ("96", lambda: _sos(96), False),
    ("3d 64 contrast 1", lambda: _sos(64, 1.0, d3=True), False),
    ("3d 64 extreme", _extreme_3d, False),
]


@pytest.mark.parametrize("name,make,ckpt", POLICY_CASES, ids=[c[0] for c in POLICY_CASES])
def test_choose_solver_matches_jax(name, make, ckpt):
    sos = make()
    params = {"dummy": np.zeros(1)} if ckpt else None
    ref = jauto.choose_solver(sos, cfg=JConfig(), params=params)
    got = tauto.choose_solver(sos, cfg=TConfig(), params=params)
    assert (got.method, got.kwargs) == (ref.method, ref.kwargs)
    assert got.rationale and got.evidence
    # a tensor gives the same plan as the array
    assert tauto.choose_solver(torch.from_numpy(sos), cfg=TConfig(),
                               params=params).kwargs == ref.kwargs
    if sos.ndim == 3:
        with pytest.raises(NotImplementedError, match="Queue A item 7"):
            tauto.solve_auto(np.zeros(sos.shape + (2,), np.float32), sos,
                             cfg=TConfig(), device="cpu")


def test_solve_auto_cslp_end_to_end():
    n = 32
    sos = _sos(n, 0.3)
    src = np.zeros((n, n, 2), np.float32)
    src[24, 16, 0] = 10.0
    geo = dict(domain_size=n, pml_size=4, sigma_max=2.0)
    ref, jplan = jauto.solve_auto(src, sos, cfg=JConfig(geometry=JGeometry(**geo)),
                                  tol=1e-6)
    res, plan = tauto.solve_auto(src, sos, cfg=TConfig(geometry=TGeometry(**geo)),
                                 tol=1e-6, device="cpu")
    assert plan.method == jplan.method == "cslp"
    norms = res.residual_norms.numpy()
    assert norms[-1] / norms[0] < 1e-3
    assert float(ref.residual_norms[-1] / ref.residual_norms[0]) < 1e-3
    want = as_complex(ref.x)
    np.testing.assert_allclose(as_complex(res.x.numpy()), want,
                               atol=2e-3 * np.abs(want).max())
    # overrides reach the solver (tests/test_solve_auto.py:158)
    res2, _ = tauto.solve_auto(src, sos, cfg=TConfig(geometry=TGeometry(**geo)),
                               tol=1e-6, mode="matmul", shift=(1.0, 0.6),
                               device="cpu")
    norms2 = res2.residual_norms.numpy()
    assert norms2[-1] / norms2[0] < 1e-3

"""The port's two-level and multilevel preconditioners
(solvers/twolevel.py) against the JAX package's, on the CPU, on the
heterogeneous problem of tests/test_twolevel.py at 32^2 (48^2, sos x 2
for three levels):

- one application of the two-level cycle (CSLP, learned with the tpu_r2c
  weights, and no smoother; spectral and linear transfers) and of the
  three-level cycle, on a random complex vector, within rtol 1e-4 of
  JAX's (tests/test_twolevel.py:182), taken as atol 1e-4 max|ref| since
  a field has entries near zero;
- the front ends `solve_fgmres_two_level` and `solve_fgmres_multilevel`:
  their first cycle within rtol 1e-4 of JAX's, convergence, and reported
  residuals equal to the true ones within rtol 1e-3
  (tests/test_twolevel.py:98); the host cycle against the device cycle
  within rtol 2e-2 (:139); levels=2 equal to the two-level method within
  rtol 1e-4 (:182); and the resolvability refusal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.solvers import twolevel as jtwo
from helmnet_tpu_torch.ops.spectral import helmholtz_residual, make_operator
from helmnet_tpu_torch.solvers import twolevel as ttwo
from tests.torch_solver_cases import N, PML, configs, heterogeneous, r2c_params
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

APPLY_RTOL = 1e-4  # tests/test_twolevel.py:182
TRUE_RTOL = 1e-3  # tests/test_twolevel.py:98
HOST_RTOL = 2e-2  # tests/test_twolevel.py:139


def _problem(n=N, sos_base=1.0):
    jcfg, tcfg = configs(n=n, precision="highest")
    sos, src = heterogeneous(n, sos_base=sos_base)
    return dict(n=n, jcfg=jcfg, tcfg=tcfg, sos=sos, src=src, k_sq=(1.0 / sos) ** 2,
                jop=jmake_operator(n, n, PML, 2.0, 1.0),
                top=make_operator(n, n, PML, 2.0, 1.0, device="cpu"))


@pytest.fixture(scope="module")
def pb():
    return _problem()


@pytest.fixture(scope="module")
def pb3():
    return _problem(48, sos_base=2.0)


def _vector(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))).astype(np.complex64)


APPLY_CASES = {
    "cslp": dict(smoother="cslp"),
    "cslp linear": dict(smoother="cslp", transfer="linear"),
    "none": dict(smoother="none"),
    "learned": dict(smoother="learned", smoother_iterations=4),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_two_level_application(pb, case):
    kw = dict(k0=1.0, pml_size=PML, sigma_max=2.0, coarse_restart=12,
              coarse_max_restarts=2, **APPLY_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if kw["smoother"] == "learned":
        jparams, tparams = r2c_params(pb["jcfg"], pb["tcfg"])
        jkw.update(params=jparams, cfg=pb["jcfg"])
        tkw.update(params=tparams, cfg=pb["tcfg"])
    japply = jtwo.make_two_level_preconditioner(pb["jop"], jnp.asarray(pb["k_sq"]), **jkw)
    tapply = ttwo.make_two_level_preconditioner(pb["top"], torch.from_numpy(pb["k_sq"]), **tkw)
    v = _vector(pb["n"])
    want = np.asarray(japply(jnp.asarray(v)))
    got = tapply(torch.from_numpy(v))
    assert got.dtype == torch.complex64 and got.shape == v.shape
    np.testing.assert_allclose(got.numpy(), want, atol=APPLY_RTOL * np.abs(want).max())


def test_multilevel_application(pb3):
    kw = dict(k0=1.0, pml_size=PML, sigma_max=2.0, levels=3, mode="matmul",
              coarse_restart=12, coarse_max_restarts=2, inner_restart=4)
    japply = jtwo.make_multilevel_preconditioner(pb3["jop"], jnp.asarray(pb3["k_sq"]), **kw)
    tapply = ttwo.make_multilevel_preconditioner(pb3["top"], torch.from_numpy(pb3["k_sq"]),
                                                 **kw)
    v = _vector(pb3["n"], seed=1)
    want = np.asarray(japply(jnp.asarray(v)))
    got = tapply(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=APPLY_RTOL * np.abs(want).max())


def _true_relres(p, wavefield) -> float:
    r = helmholtz_residual(p["top"], wavefield[None], torch.from_numpy(p["k_sq"])[None],
                           torch.from_numpy(p["src"])[None], "matmul")
    return float(torch.linalg.vector_norm(r) / np.linalg.norm(p["src"]))


FRONT_CASES = {
    "two-level cslp": ("two", dict(smoother="cslp", restart=8, max_restarts=8)),
    "two-level learned": ("two", dict(smoother="learned", smoother_iterations=4,
                                      restart=6, max_restarts=3)),
    "three-level cslp": ("multi", dict(levels=3, smoother="cslp", restart=8,
                                       max_restarts=8, inner_restart=4)),
}


@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_front_end(pb, pb3, case):
    kind, kw = FRONT_CASES[case]
    p = pb3 if kind == "multi" else pb
    kw = dict(kw, coarse_restart=16, coarse_max_restarts=2, tol=1e-5)
    jkw, tkw = dict(kw), dict(kw)
    if kw["smoother"] == "learned":
        jkw["params"], tkw["params"] = r2c_params(p["jcfg"], p["tcfg"])
    jfn, tfn = ((jtwo.solve_fgmres_two_level, ttwo.solve_fgmres_two_level) if kind == "two"
                else (jtwo.solve_fgmres_multilevel, ttwo.solve_fgmres_multilevel))
    ref = jfn(p["jop"], p["src"], p["sos"], cfg=p["jcfg"], **jkw)
    got = tfn(p["top"], p["src"], p["sos"], cfg=p["tcfg"], device="cpu", **tkw)
    norms, want = got.residual_norms.numpy(), np.asarray(ref.residual_norms)
    np.testing.assert_allclose(norms[:2], want[:2], rtol=APPLY_RTOL)
    assert np.all(np.isfinite(norms)) and norms[-1] < norms[0] / 100
    if kw["smoother"] == "cslp":
        assert norms[-1] < 1e-5
    np.testing.assert_allclose(_true_relres(p, got.wavefield), norms[-1],
                               rtol=TRUE_RTOL, atol=1e-8)


def test_host_cycle_matches_device_cycle(pb):
    kw = dict(cfg=pb["tcfg"], smoother="cslp", restart=6, max_restarts=3,
              coarse_restart=16, coarse_max_restarts=1, tol=0.0, device="cpu")
    dev = ttwo.solve_fgmres_two_level(pb["top"], pb["src"], pb["sos"], **kw)
    host = ttwo.solve_fgmres_two_level(pb["top"], pb["src"], pb["sos"],
                                       host_arnoldi=True, **kw)
    np.testing.assert_allclose(dev.residual_norms.numpy(), host.residual_norms.numpy(),
                               rtol=HOST_RTOL)


def test_two_levels_of_multilevel_are_the_two_level_method(pb):
    kw = dict(cfg=pb["tcfg"], smoother="cslp", restart=6, max_restarts=3,
              coarse_restart=16, coarse_max_restarts=1, tol=0.0, device="cpu")
    two = ttwo.solve_fgmres_two_level(pb["top"], pb["src"], pb["sos"], **kw)
    ml2 = ttwo.solve_fgmres_multilevel(pb["top"], pb["src"], pb["sos"], levels=2, **kw)
    np.testing.assert_allclose(two.residual_norms.numpy(), ml2.residual_norms.numpy(),
                               rtol=APPLY_RTOL)


def test_multilevel_refuses_an_underresolved_hierarchy(pb):
    """sos 1 gives 6.3 points per wavelength: three levels leave 1.6 at the
    deepest grid, below 2; JAX's message names the levels that are valid."""
    with pytest.raises(ValueError, match="Max valid levels here: 2"):
        ttwo.make_multilevel_preconditioner(
            pb["top"], torch.from_numpy(pb["k_sq"]), k0=1.0, pml_size=PML,
            sigma_max=2.0, levels=3)
    with pytest.raises(ValueError, match="levels must be >= 2"):
        ttwo.make_multilevel_preconditioner(
            pb["top"], torch.from_numpy(pb["k_sq"]), k0=1.0, pml_size=PML,
            sigma_max=2.0, levels=1)

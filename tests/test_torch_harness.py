"""The port's evaluation harness (`helmnet_tpu_torch/eval/harness.py`)
against the JAX package's on the same seeded numpy inputs, on the CPU.

The metrics are numpy in both packages and must agree to round-off
(rtol 1e-12); `compare_solvers` runs the learned rollout ('highest'
precision) and CSLP-GMRES in f32, and every field of its
`SolverComparison` agrees within rtol 1e-3 (tests/test_torch_iterative.py's
rollout tolerance) plus an atol of 1e-5 of the field's scale for the
converged GMRES residuals, which sit at f32's floor."""

import dataclasses

import numpy as np
import pytest

from helmnet_tpu.eval import harness as jh
from helmnet_tpu_torch.eval import harness as th
from tests.torch_solver_cases import (  # noqa: F401
    configs,
    heterogeneous,
    one_torch_thread,
    random_params,
)

RT = 1e-12


def _fields(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, rtol=RT, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_to_complex_and_normalize():
    f = _fields(0, (3, 8, 8, 2)).astype(np.float32)
    _close(th.to_complex(f), jh.to_complex(f))
    c = th.to_complex(f)
    assert th.to_complex(c) is c
    for field in (f[0], f, c):
        _close(th.normalize_wavefield(field, (3, 4)),
               jh.normalize_wavefield(field, (3, 4)))


@pytest.mark.parametrize("conjugate", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_field_difference(conjugate, masked, batched):
    shape = (4, 16, 16, 2) if batched else (16, 16, 2)
    s, r = _fields(1, shape), _fields(2, shape)
    s[..., 5, 5, :] = np.nan  # a NaN sample pixel is zeroed, not propagated
    mask = (np.random.default_rng(3).random((16, 16)) > 0.3) if masked else None
    got = th.field_difference(s, r, (8, 8), pml_size=2,
                              conjugate_reference=conjugate, mask=mask)
    want = jh.field_difference(s, r, (8, 8), pml_size=2,
                               conjugate_reference=conjugate, mask=mask)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_linf_and_rmse_and_error_traces():
    d = np.abs(_fields(4, (5, 10, 12)))
    for g, w in zip(th.linf_and_rmse(d), jh.linf_and_rmse(d)):
        _close(g, w)
    wfs = _fields(5, (5, 16, 16, 2))
    for conjugate in (False, True):
        got = th.error_traces(wfs, wfs[-1], (8, 8), 2, conjugate)
        want = jh.error_traces(wfs, wfs[-1], (8, 8), 2, conjugate)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (5,)
            _close(g, w)


def test_compare_solvers():
    """The fig_generic flow on a 32^2 heterogeneous problem with the same
    random weights in both packages: every field of the comparison."""
    from helmnet_tpu.solvers.iterative import IterativeSolver as JSolver
    from helmnet_tpu_torch.solvers.iterative import IterativeSolver as TSolver

    jcfg, tcfg = configs(precision="highest")
    jparams, tparams = random_params(jcfg)
    sos, _ = heterogeneous()
    kw = dict(num_iterations=40, decimate=10, gmres_restart=20,
              gmres_max_restarts=5, gmres_tol=1e-7, pml_crop=4)
    want = jh.compare_solvers(JSolver(jcfg, params=jparams), sos, **kw)
    got = th.compare_solvers(TSolver(tcfg, params=tparams, device="cpu"), sos, **kw)
    assert isinstance(got, th.SolverComparison)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert isinstance(g, (float, np.ndarray)), f.name
        w = np.asarray(w)
        assert np.shape(g) == w.shape, f.name
        _close(g, w, rtol=1e-3, atol=1e-5 * np.abs(w).max())
    # GMRES converges (tests/test_harness.py:73)
    assert got.gmres_residual_norms[-1] < 1e-2 * got.gmres_residual_norms[0]

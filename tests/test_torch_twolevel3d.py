"""The port's 3D two-level FGMRES (`solvers/twolevel3d.py`) against the
JAX package's, on the CPU:

- `spectral_resize_complex3d` down and up against JAX's (1e-6 max|ref|),
  exact for resolvable modes (tests/test_twolevel3d.py:37-51), mixed
  resizes refused; `make_coarse_level3d`'s operator and antialiased
  'linear' k^2 against JAX's (1e-6);
- `solve_fgmres_two_level3d` (CSLP smoother) with the device and the host
  cycle on tests/test_twolevel3d.py's block-contrast problem at 24^3: the
  same solution as JAX's within 2e-3 max|u| (compare solutions, not
  histories), the last reported residual equal to the true one (rtol
  1e-3, :81), and the two cycle kinds within 2e-2 (:167-169);
- one learned-smoother application (JAX-initialised random weights)
  against JAX's within 1e-3 max|ref|, and the trained tpu3d_a smoother at
  48^3 meeting tests/test_twolevel3d.py:139-141 (residual down 40x in two
  cycles, falling at every cycle).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmnet_tpu.core.config import Config as JConfig
from helmnet_tpu.core.config import GeometryConfig as JGeometry
from helmnet_tpu.core.config import ModelConfig as JModel
from helmnet_tpu.models import hybridnet3d as jhn
from helmnet_tpu.ops import spectral3d as js
from helmnet_tpu.solvers import twolevel3d as jt
from helmnet_tpu_torch.core.config import Config as TConfig
from helmnet_tpu_torch.core.config import GeometryConfig as TGeometry
from helmnet_tpu_torch.core.config import ModelConfig as TModel
from helmnet_tpu_torch.ops import spectral3d as ts
from helmnet_tpu_torch.solvers import twolevel3d as tt
from helmnet_tpu_torch.weights import from_jax_params3d, load_params3d_npz
from tests.torch_solver_cases import ROOT, as_complex
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

PML, SIGMA, K0 = 4, 2.0, 1.0


def _problem(n=24):
    """tests/test_twolevel3d.py:21's block-contrast problem, scaled down."""
    rng = np.random.default_rng(7)
    sos = np.ones((n, n, n), np.float32)
    a, b = n // 3, 2 * n // 3
    sos[a:b, a:b, a:b] = 1.0 + 0.8 * rng.random((b - a,) * 3).astype(np.float32)
    k_sq = (K0 / sos) ** 2
    src = ts.point_source_map3d(n, n, n, (n - 6, n // 2, n // 2), 10.0, 0.0, K0)
    return (js.make_operator3d(n, n, n, PML, SIGMA, K0),
            ts.make_operator3d(n, n, n, PML, SIGMA, K0, device="cpu"), k_sq, src)


def _cplx(v):
    return jax.lax.complex(jnp.asarray(v.real), jnp.asarray(v.imag))


@pytest.mark.parametrize("dst", [(8, 8, 8), (9, 7, 8), (32, 32, 32), (33, 31, 16)])
def test_spectral_resize_against_jax(dst):
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((16, 15, 16))
         + 1j * rng.standard_normal((16, 15, 16))).astype(np.complex64)
    ref = np.asarray(jt.spectral_resize_complex3d(_cplx(v), dst))
    got = tt.spectral_resize_complex3d(torch.from_numpy(v), dst).numpy()
    assert got.shape == dst
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())


def test_spectral_resize_exact_and_mixed_refused():
    z, y, x = np.mgrid[0:32, 0:32, 0:32]
    v = torch.from_numpy(np.exp(1j * 2 * np.pi * (3 * z + 5 * y + 7 * x) / 32).astype(
        np.complex64))
    down = tt.spectral_resize_complex3d(v, (16, 16, 16))
    up = tt.spectral_resize_complex3d(down, (32, 32, 32))
    assert float((up - v).abs().max()) < 1e-5
    np.testing.assert_allclose(float(down.abs().max()), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="mixed"):
        tt.spectral_resize_complex3d(torch.zeros((16, 16, 16), dtype=torch.complex64),
                                     (8, 32, 16))


def test_coarse_level_against_jax():
    _, _, k_sq, _ = _problem()
    k_sq = k_sq[:, :20]  # a non-cube: each axis its own weights
    jop, jk = jt.make_coarse_level3d(jnp.asarray(k_sq), k0=K0, pml_size=8, sigma_max=SIGMA)
    top, tk = tt.make_coarse_level3d(torch.from_numpy(k_sq), k0=K0, pml_size=8,
                                     sigma_max=SIGMA)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    for name, a, b in zip(jop._fields, jop, top):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("host_arnoldi", [False, True], ids=["device", "host"])
def test_two_level_against_jax(host_arnoldi):
    jop, top, k_sq, src = _problem()
    kw = dict(k0=K0, pml_size=PML, sigma_max=SIGMA, restart=6, max_restarts=3,
              coarse_restart=12, coarse_max_restarts=1, tol=1e-6,
              host_arnoldi=host_arnoldi)
    ref = jt.solve_fgmres_two_level3d(jop, src, jnp.asarray(k_sq), **kw)
    got = tt.solve_fgmres_two_level3d(top, src, k_sq, device="cpu", **kw)
    u = as_complex(np.asarray(ref.wavefield))
    np.testing.assert_allclose(as_complex(got.wavefield.numpy()), u,
                               atol=2e-3 * np.abs(u).max())
    norms = got.residual_norms.numpy()
    assert norms[-1] < norms[0] / 100, norms
    r = ts.helmholtz_residual3d(top, got.wavefield, torch.from_numpy(k_sq),
                                torch.from_numpy(src))
    true_rel = float(torch.linalg.vector_norm(r) / np.linalg.norm(src))
    np.testing.assert_allclose(true_rel, norms[-1], rtol=1e-3, atol=1e-8)


def test_host_cycle_matches_device_cycle():
    _, top, k_sq, src = _problem(16)
    kw = dict(k0=K0, pml_size=PML, sigma_max=SIGMA, restart=6, max_restarts=3,
              coarse_restart=12, coarse_max_restarts=1, tol=0.0, device="cpu")
    dev = tt.solve_fgmres_two_level3d(top, src, k_sq, host_arnoldi=False, **kw)
    host = tt.solve_fgmres_two_level3d(top, src, k_sq, host_arnoldi=True, **kw)
    np.testing.assert_allclose(dev.residual_norms.numpy(), host.residual_norms.numpy(),
                               rtol=2e-2)
    # a warm start from the pair continues from there
    warm = tt.solve_fgmres_two_level3d(top, src, k_sq, x0=dev.wavefield,
                                       **dict(kw, max_restarts=1))
    np.testing.assert_allclose(float(warm.residual_norms[0]),
                               float(dev.residual_norms[-1]), rtol=1e-3)


def test_refusals():
    _, top, k_sq, src = _problem(16)
    kw = dict(k0=K0, pml_size=PML, sigma_max=SIGMA, restart=2, max_restarts=1,
              device="cpu")
    with pytest.raises(ValueError, match="params and cfg"):
        tt.solve_fgmres_two_level3d(top, src, k_sq, smoother="learned", **kw)
    with pytest.raises(ValueError, match="unknown 3D smoother"):
        tt.solve_fgmres_two_level3d(top, src, k_sq, smoother="jacobi", **kw)


def test_learned_preconditioner_against_jax():
    n = 16
    def make(Config, Geometry, Model):
        return Config(geometry=Geometry(domain_size=n, pml_size=3),
                      model=Model(depth=2, state_depth=2, features=4, in_channels=7,
                                  precision="highest"))
    jcfg, tcfg = make(JConfig, JGeometry, JModel), make(TConfig, TGeometry, TModel)
    jp = jhn.init_params(jax.random.PRNGKey(1), jcfg.model)
    tp = from_jax_params3d(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    sos = (1.0 + 0.3 * np.random.default_rng(2).random((n, n, n))).astype(np.float32)
    jop = js.make_operator3d(n, n, n, 3, 2.0, 1.0)
    top = ts.make_operator3d(n, n, n, 3, 2.0, 1.0, device="cpu")
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))).astype(
        np.complex64)
    ref = np.asarray(jt.make_learned_preconditioner3d(jp, jop, sos, cfg=jcfg,
                                                      iterations=3)(_cplx(v)))
    got = tt.make_learned_preconditioner3d(tp, top, sos, cfg=tcfg,
                                           iterations=3)(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


def test_trained_learned_smoother():
    """tests/test_twolevel3d.py:84-141 on the port: the tpu3d_a weights at
    48^3 as the smoother of two cycles."""
    cfg = TConfig()
    cfg = cfg.replace(
        geometry=dataclasses.replace(cfg.geometry, domain_size=48),
        model=dataclasses.replace(cfg.model, depth=3, state_depth=3, features=16,
                                  in_channels=7))
    params = load_params3d_npz(os.path.join(ROOT, "trained_models", "tpu3d_a_ep80.npz"),
                               cfg, device="cpu")
    n = 48
    op = ts.make_operator3d(n, n, n, cfg.geometry.pml_size, cfg.geometry.sigma_max,
                            cfg.source.omega, device="cpu")
    rng = np.random.default_rng(5)
    sos = np.ones((n, n, n), np.float32)
    sos[16:33, 12:39, 12:39] = 1.0 + rng.random((17, 27, 27)).astype(np.float32)
    k_sq = (cfg.source.omega / sos) ** 2
    src = ts.point_source_map3d(n, n, n, (n - 12, n // 2, n // 2), cfg.source.amplitude,
                                0.0, cfg.source.omega)
    res = tt.solve_fgmres_two_level3d(
        op, src, k_sq, k0=cfg.source.omega, pml_size=cfg.geometry.pml_size,
        sigma_max=cfg.geometry.sigma_max, smoother="learned", params=params, cfg=cfg,
        smoother_iterations=6, restart=4, max_restarts=2, coarse_restart=12,
        coarse_max_restarts=1, tol=1e-5, device="cpu")
    norms = res.residual_norms.numpy()
    assert norms[-1] < norms[0] / 40, norms
    assert np.all(np.diff(norms) < 0), norms

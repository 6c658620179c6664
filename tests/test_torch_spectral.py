"""The port's spectral PML operator against the JAX package's, on the CPU.

Same numpy inputs to both; atol 1e-4 * max|ref| against JAX, and the
JAX package's own atol 5e-4 (tests/test_parity.py:44-49) against the
reference fixture.
"""

import os

import numpy as np
import pytest
import torch

from helmnet_tpu.ops import spectral as jspec
from helmnet_tpu_torch.ops import spectral as tspec

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SHAPES = [(32, 32), (48, 32)]
FIELDS = ["ay_r", "ay_i", "ax_r", "ax_i", "kx", "ky", "ax1d", "bx1d", "ay1d",
          "by1d", "sigmas"]


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _ops(h, w):
    return (jspec.make_operator(h, w, 4, 2.0, 1.0),
            tspec.make_operator(h, w, 4, 2.0, 1.0, device="cpu"))


def _field(h, w, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, h, w, 2)).astype(np.float32)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("name", FIELDS)
def test_operator_arrays(h, w, name):
    jop, top = _ops(h, w)
    got = getattr(top, name)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got.numpy(), getattr(jop, name))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("mode", ["matmul", "fft"])
def test_laplacian(h, w, mode):
    jop, top = _ops(h, w)
    u = _field(h, w)
    _close(tspec.laplacian(top, torch.from_numpy(u), mode).numpy(),
           jspec.laplacian(jop, u, mode))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("mode", ["matmul", "fft", "auto"])
def test_helmholtz_residual(h, w, mode):
    jop, top = _ops(h, w)
    rng = np.random.default_rng(1)
    u, s = _field(h, w, 2), _field(h, w, 3)
    k_sq = (1.0 / (1.0 + rng.random((2, h, w)))).astype(np.float32) ** 2
    got = tspec.helmholtz_residual(top, torch.from_numpy(u),
                                   torch.from_numpy(k_sq), torch.from_numpy(s),
                                   mode)
    _close(got.numpy(), jspec.helmholtz_residual(jop, u, k_sq, s, mode=mode))


@pytest.mark.parametrize("mode", ["matmul", "fft"])
def test_laplacian_fixture(mode):
    fx = np.load(os.path.join(FIXTURES, "laplacian_96.npz"))
    op = tspec.make_operator(96, 96, 8, 2.0, 1.0, device="cpu")
    got = tspec.laplacian(op, torch.from_numpy(fx["u"]), mode).numpy()
    np.testing.assert_allclose(got, fx["lap"], atol=5e-4)


def test_sigmas_fixture():
    fx = np.load(os.path.join(FIXTURES, "laplacian_96.npz"))
    op = tspec.make_operator(96, 96, 8, 2.0, 1.0, device="cpu")
    np.testing.assert_allclose(op.sigmas.numpy(), fx["sigmas"], atol=1e-6)


def test_resolve_mode_and_dense_free_operator():
    for n in (96, 512, 1024, 2048):
        assert tspec.resolve_mode("auto", n, n) == jspec.resolve_mode("auto", n, n)
    op = tspec.make_operator(32, 32, 4, 2.0, 1.0, dense=False, device="cpu")
    assert not op.has_dense
    u = torch.from_numpy(_field(32, 32))
    with pytest.raises(ValueError, match="dense"):
        tspec.laplacian(op, u, "matmul")
    dense = tspec.make_operator(32, 32, 4, 2.0, 1.0, device="cpu")
    _close(tspec.laplacian(op, u, "auto").numpy(),
           tspec.laplacian(dense, u, "fft").numpy())

"""The port's 3D spectral PML operator (`ops/spectral3d.py`) against the
JAX package's, on the CPU, on tests/test_spectral3d.py's 10x12x14 problem:
the operator tables and sigma maps equal; both Laplacian modes within
2e-5 max|ref| of JAX's (tests/test_spectral3d.py:39) and of each other;
the residual; `assemble_dense3d` against JAX's and against the matmul
mode; `point_source_map3d` to the bit."""

import numpy as np
import pytest
import torch

from helmnet_tpu.ops import spectral3d as js
from helmnet_tpu_torch.ops import spectral3d as ts
from tests.torch_solver_cases import one_torch_thread  # noqa: F401

D, H, W, PML = 10, 12, 14, 3


def _field(seed, shape=(D, H, W, 2)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ops():
    return (js.make_operator3d(D, H, W, PML, 2.0, 1.0),
            ts.make_operator3d(D, H, W, PML, 2.0, 1.0, device="cpu"))


def test_operator_tables_equal(ops):
    jop, top = ops
    assert top._fields == jop._fields
    for name, a, b in zip(jop._fields, jop, top):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (top.depth, top.height, top.width) == (D, H, W)
    np.testing.assert_array_equal(ts.sigma_maps_3d(D, H, W, PML, 2.0),
                                  js.sigma_maps_3d(D, H, W, PML, 2.0))


@pytest.mark.parametrize("mode", ["matmul", "fft", "auto"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch2"])
def test_laplacian_against_jax(ops, mode, batched):
    jop, top = ops
    u = _field(1, ((2,) if batched else ()) + (D, H, W, 2))
    ref = np.asarray(js.laplacian3d(jop, u, mode))
    got = ts.laplacian3d(top, torch.from_numpy(u), mode).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_modes_agree(ops):
    _, top = ops
    u = torch.from_numpy(_field(2))
    lm = ts.laplacian3d(top, u, "matmul")
    lf = ts.laplacian3d(top, u, "fft")
    scale = lm.abs().max().item()
    np.testing.assert_allclose(lm.numpy(), lf.numpy(), atol=2e-5 * scale)
    with pytest.raises(ValueError, match="unknown operator mode"):
        ts.laplacian3d(top, u, "dense")


def test_residual_against_jax(ops):
    jop, top = ops
    rng = np.random.default_rng(3)
    u = _field(4)
    k_sq = (1.0 + rng.random((D, H, W))).astype(np.float32)
    src = ts.point_source_map3d(D, H, W, (D - 4, H // 2, W // 2), 10.0)
    for mode in ("matmul", "fft"):
        ref = np.asarray(js.helmholtz_residual3d(jop, u, k_sq, src, mode))
        got = ts.helmholtz_residual3d(top, torch.from_numpy(u), torch.from_numpy(k_sq),
                                      torch.from_numpy(src), mode).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def test_assemble_dense3d(ops):
    _, top = ops
    rng = np.random.default_rng(5)
    k_sq = rng.random((D, H, W))
    M = ts.assemble_dense3d(D, H, W, PML, 2.0, 1.0, k_sq=k_sq)
    np.testing.assert_allclose(M, js.assemble_dense3d(D, H, W, PML, 2.0, 1.0, k_sq=k_sq),
                               rtol=1e-12, atol=1e-12)
    u = _field(6)
    uc = u[..., 0] + 1j * u[..., 1]
    want = (ts.assemble_dense3d(D, H, W, PML, 2.0, 1.0) @ uc.ravel()).reshape(D, H, W)
    got = ts.laplacian3d(top, torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], want,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("loc,amp,phase", [((6, 6, 7), 10.0, 0.0), ((0, 11, 13), 1.0, 0.7)])
def test_point_source_map3d(loc, amp, phase):
    want = js.point_source_map3d(D, H, W, loc, amp, phase, 1.0)
    got = ts.point_source_map3d(D, H, W, loc, amp, phase, 1.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        ts.point_source_map3d(D, H, W, (D, 0, 0))


def test_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.make_operator3d(D, H, W, PML, 2.0, 1.0)

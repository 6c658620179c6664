"""The port's FD stencil operator (ops/stencil.py) and its host-side forms
(ops/stencil_residual.banded_matrices, stencil_to_csr) against the JAX
package's, on the CPU:

- the tap tables and sigmas, and the banded matrices: equal to the bit
  (both are built in float64 numpy and cast to f32 the same way; the
  bands are the same f32 sums in the same order);
- `stencil_to_csr`: the same sparsity, values within 1e-7;
- `laplacian_stencil`, `helmholtz_residual_stencil` and
  `laplacian_stencil_local` at 32^2 (orders 2 and 4) and 16x48, atol 1e-5
  (tests/test_pallas_stencil.py:35);
- an unknown order raises ValueError.
"""

import numpy as np
import pytest
import torch

from helmnet_tpu.ops import pallas_stencil as jps
from helmnet_tpu.ops import stencil as jst
from helmnet_tpu_torch.ops import stencil as tst
from helmnet_tpu_torch.ops import stencil_residual as tsr

SHAPES = [(32, 32, 2), (32, 32, 4), (16, 48, 4)]
TABLES = ["cx_r", "cx_i", "cy_r", "cy_i", "sigmas"]


def _ops(h, w, order, pml=4):
    return (jst.make_stencil_operator(h, w, pml, 2.0, 1.0, order=order),
            tst.make_stencil_operator(h, w, pml, 2.0, 1.0, order=order,
                                      device="cpu"))


def _fields(h, w, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((batch, h, w, 2)).astype(np.float32)
    k_sq = rng.uniform(0.5, 1.2, (batch, h, w)).astype(np.float32)
    src = rng.standard_normal((batch, h, w, 2)).astype(np.float32)
    return u, k_sq, src


@pytest.mark.parametrize("h,w,order", SHAPES)
@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_jax(h, w, order, name):
    jop, top = _ops(h, w, order)
    got = getattr(top, name)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jop, name)))
    assert top.radius == jop.radius == order // 2


@pytest.mark.parametrize("h,w,order", SHAPES)
def test_banded_matrices_equal_jax(h, w, order):
    jop, top = _ops(h, w, order)
    btr, bti = tsr.banded_matrices(top)
    jbtr, jbti = jps.banded_matrices(jop)
    np.testing.assert_array_equal(btr.numpy(), np.asarray(jbtr))
    np.testing.assert_array_equal(bti.numpy(), np.asarray(jbti))
    assert tsr.banded_matrices(top)[0] is btr  # built once, cached


@pytest.mark.parametrize("h,w,order", SHAPES)
def test_stencil_to_csr_matches_jax(h, w, order):
    jop, top = _ops(h, w, order)
    k_sq = np.random.default_rng(1).uniform(0.5, 1.2, (h, w))
    got = tsr.stencil_to_csr(top, k_sq)
    ref = jps.stencil_to_csr(jop, k_sq)
    assert got.shape == ref.shape == (h * w, h * w)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=1e-7)
    assert got.nnz == h * w * (4 * top.radius + 1)


@pytest.mark.parametrize("h,w,order", SHAPES)
def test_laplacian_and_residual_match_jax(h, w, order):
    jop, top = _ops(h, w, order)
    u, k_sq, src = _fields(h, w)
    lap = tst.laplacian_stencil(top, torch.tensor(u)).numpy()
    np.testing.assert_allclose(lap, np.asarray(jst.laplacian_stencil(jop, u)),
                               atol=1e-5)
    r = tst.helmholtz_residual_stencil(top, torch.tensor(u), torch.tensor(k_sq),
                                       torch.tensor(src)).numpy()
    ref = np.asarray(jst.helmholtz_residual_stencil(jop, u, k_sq, src))
    np.testing.assert_allclose(r, ref, atol=1e-5)


@pytest.mark.parametrize("h,w,order", SHAPES)
def test_laplacian_local_matches_jax(h, w, order):
    """A halo-padded block with the tables of its output rows and columns
    (the building block of a domain-decomposed residual)."""
    jop, top = _ops(h, w, order)
    r = top.radius
    u, _, _ = _fields(h, w, seed=2)
    padded = np.pad(u, ((0, 0), (r, r), (r, r), (0, 0)), mode="wrap")
    rows, cols = slice(2, h - 2), slice(3, w - 1)
    block = padded[:, 2 : h - 2 + 2 * r, 3 : w - 1 + 2 * r]
    jt = [np.asarray(t) for t in (jop.cx_r, jop.cx_i, jop.cy_r, jop.cy_i)]
    jt = [jt[0][:, cols], jt[1][:, cols], jt[2][:, rows], jt[3][:, rows]]
    ref = np.asarray(jst.laplacian_stencil_local(*jt, block, r))
    tt = [top.cx_r[:, cols], top.cx_i[:, cols], top.cy_r[:, rows], top.cy_i[:, rows]]
    got = tst.laplacian_stencil_local(*tt, torch.tensor(block), r).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and the periodic whole-grid operator on those rows and columns
    whole = tst.laplacian_stencil(top, torch.tensor(u)).numpy()[:, rows, cols]
    np.testing.assert_allclose(got, whole, atol=1e-5)


def test_unknown_order_raises():
    with pytest.raises(ValueError, match="order"):
        tst.make_stencil_operator(32, 32, 4, 2.0, 1.0, order=3, device="cpu")


def test_to_keeps_the_cache_on_the_same_device():
    _, top = _ops(32, 32, 4)
    bands = tsr.banded_matrices(top)
    assert top.to("cpu") is top
    assert tsr.banded_matrices(top.to("cpu")) is bands

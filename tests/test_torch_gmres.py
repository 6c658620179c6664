"""The port's restarted GMRES (solvers/gmres.py) and CSLP inverse
(solvers/precond.py) against the JAX package's, on the CPU, on
tests/test_gmres.py's 32^2 `problem()`:

- residual histories of the spectral operator (matmul and fft modes), the
  stencil operator and the CSLP-preconditioned solve at rtol 1e-3 over
  the first 5 restart cycles. Later cycles are left out on purpose: the
  two frameworks sum in other orders, restarted GMRES amplifies that
  from cycle to cycle (measured on this problem: below 1.2e-4 over the
  first 5 cycles, up to 2e-2 by cycle 14, where f32 stagnates near 1e-6
  relative); the solutions themselves are held by the direct solves;
- solutions against dense and scipy direct solves at test_gmres.py's
  tolerances (2e-3 * scale, :35; 5e-3 * scale, :153; CSLP :218);
- the batch, zero right-hand side, early convergence, chunked and early
  exit semantics of test_gmres.py (:69, :91, :103, :252, :171);
- the traps of the port: the host lstsq on a rank-deficient H (a
  converged problem in a batch), per-problem masking, and vdot's
  conjugation of its first argument.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from helmnet_tpu.ops.source import point_source_map
from helmnet_tpu.ops.spectral import assemble_dense
from helmnet_tpu.ops.spectral import make_operator as jmake_operator
from helmnet_tpu.ops.stencil import make_stencil_operator as jmake_stencil
from helmnet_tpu.solvers import gmres as jg
from helmnet_tpu.solvers import precond as jp
from helmnet_tpu_torch.ops.spectral import make_operator
from helmnet_tpu_torch.ops.stencil import make_stencil_operator
from helmnet_tpu_torch.ops.stencil_residual import stencil_to_csr
from helmnet_tpu_torch.solvers import gmres
from helmnet_tpu_torch.solvers.precond import make_shifted_laplace_inverse

N, PML = 32, 4
HIST_RTOL, HIST_CYCLES = 1e-3, 5


def problem(n=N):
    """tests/test_gmres.py's problem(): a slab of sos 1.5, a point source."""
    sos = np.ones((n, n), np.float32)
    sos[10:20, 8:26] = 1.5
    k_sq = (1.0 / sos) ** 2
    src = np.asarray(point_source_map(n, n, (n - 8, n // 2), 10.0))
    return k_sq, src


def _ops(kind):
    if kind == "stencil":
        return (jmake_stencil(N, N, PML, 2.0, 1.0, order=4),
                make_stencil_operator(N, N, PML, 2.0, 1.0, order=4, device="cpu"))
    return (jmake_operator(N, N, PML, 2.0, 1.0),
            make_operator(N, N, PML, 2.0, 1.0, device="cpu"))


def _complex(pair):
    pair = np.asarray(pair)
    return pair[..., 0] + 1j * pair[..., 1]


@pytest.mark.parametrize("kind,kw", [
    ("spectral", {"mode": "matmul"}),
    ("spectral", {"mode": "fft"}),
    ("stencil", {}),
    ("spectral", {"precond": "shifted_laplace"}),
], ids=["matmul", "fft", "stencil", "cslp"])
def test_residual_history_matches_jax(kind, kw):
    jop, top = _ops(kind)
    k_sq, src = problem()
    opts = dict(restart=20, max_restarts=HIST_CYCLES, tol=1e-12, **kw)
    ref = jg.solve_helmholtz(jop, k_sq, src, **opts)
    got = gmres.solve_helmholtz(top, k_sq, src, device="cpu", **opts)
    np.testing.assert_allclose(got.residual_norms.numpy(),
                               np.asarray(ref.residual_norms), rtol=HIST_RTOL)
    assert got.x.shape == (N, N, 2)
    assert got.checkpoints.shape == (HIST_CYCLES, N, N, 2)
    assert int(got.iterations) == int(ref.iterations) == 20 * HIST_CYCLES
    x, xr = got.x.numpy(), np.asarray(ref.x)
    np.testing.assert_allclose(x, xr, atol=1e-3 * np.abs(xr).max())


def test_matches_dense_direct_solve():
    _, top = _ops("spectral")
    k_sq, src = problem()
    res = gmres.solve_helmholtz(top, k_sq, src, restart=30, max_restarts=40,
                                tol=1e-7, device="cpu")
    M = assemble_dense(N, N, PML, 2.0, 1.0, k_sq=k_sq)
    u_direct = np.linalg.solve(M, _complex(src).ravel()).reshape(N, N)
    scale = np.abs(u_direct).max()
    np.testing.assert_allclose(_complex(res.x), u_direct, atol=2e-3 * scale)


def test_stencil_matches_scipy_spsolve():
    """GMRES on the FD stencil system solves the port's own CSR matrix
    (test_gmres.py:131-153)."""
    _, top = _ops("stencil")
    k_sq, src = problem()
    res = gmres.solve_helmholtz(top, k_sq, src, restart=40, max_restarts=30,
                                tol=1e-6, device="cpu")
    M = stencil_to_csr(top, k_sq)
    u_direct = spla.spsolve(M.tocsc(), _complex(src).ravel()).reshape(N, N)
    scale = np.abs(u_direct).max()
    np.testing.assert_allclose(_complex(res.x), u_direct, atol=5e-3 * scale)


def test_preconditioned_solves_same_system():
    _, top = _ops("spectral")
    k_sq, src = problem()
    res = gmres.solve_helmholtz(top, k_sq, src, restart=30, max_restarts=40,
                                tol=1e-7, precond="shifted_laplace", device="cpu")
    M = assemble_dense(N, N, PML, 2.0, 1.0, k_sq=k_sq)
    u_direct = np.linalg.solve(M, _complex(src).ravel()).reshape(N, N)
    scale = np.abs(u_direct).max()
    np.testing.assert_allclose(_complex(res.x), u_direct, atol=2e-3 * scale)


@pytest.mark.parametrize("kref", ["mean", "max"])
def test_shifted_laplace_inverse_matches_jax(kref):
    jop, top = _ops("spectral")
    k_sq, _ = problem()
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))).astype(np.complex64)
    ref = np.asarray(jp.make_shifted_laplace_inverse(jop, k_sq, kref=kref)(v))
    minv = make_shifted_laplace_inverse(top, torch.tensor(k_sq), kref=kref)
    got = minv(torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    # per-problem reference wavenumber over a batch
    minv_batch = make_shifted_laplace_inverse(
        top, torch.tensor(np.stack([k_sq, 2 * k_sq])), kref=kref)
    out = minv_batch(torch.tensor(np.stack([v, v])))
    np.testing.assert_allclose(out[0].numpy(), got, rtol=0, atol=0)
    other = make_shifted_laplace_inverse(top, torch.tensor(2 * k_sq), kref=kref)
    np.testing.assert_allclose(out[1].numpy(), other(torch.tensor(v)).numpy(),
                               rtol=0, atol=0)


def test_batch_equals_single_solves():
    """A batch of 3 (two media, one with zero source: beta = 0 from the
    start, so its H is all zeros and the host lstsq must give y = 0, not
    NaN) equals three single solves."""
    _, top = _ops("stencil")
    k_sq, src = problem()
    ks = np.stack([k_sq, np.ones_like(k_sq), k_sq])
    ss = np.stack([src, src, np.zeros_like(src)])
    opts = dict(restart=15, max_restarts=4, tol=1e-6)
    batch = gmres.solve_helmholtz_batch(top, ks, ss, device="cpu", **opts)
    assert batch.x.shape == (3, N, N, 2)
    assert batch.residual_norms.shape == (3, 5)
    assert batch.checkpoints.shape == (3, 4, N, N, 2)
    assert bool(torch.isfinite(batch.residual_norms).all())
    for i in range(3):
        single = gmres.solve_helmholtz(top, ks[i], ss[i], device="cpu", **opts)
        scale = max(single.x.abs().max().item(), 1e-30)
        np.testing.assert_allclose(batch.x[i].numpy(), single.x.numpy(),
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(batch.residual_norms[i].numpy(),
                                   single.residual_norms.numpy(), rtol=1e-4,
                                   atol=1e-30)
    assert np.all(batch.x[2].numpy() == 0)
    assert int(batch.iterations[2]) == 15  # done after its first cycle


def test_zero_rhs():
    _, top = _ops("spectral")
    k_sq, src = problem()
    res = gmres.solve_helmholtz(top, k_sq, np.zeros_like(src), restart=10,
                                max_restarts=3, tol=1e-8, device="cpu")
    assert np.allclose(res.x.numpy(), 0.0)
    assert bool(torch.isfinite(res.residual_norms).all())


def test_early_convergence_freezes_solution():
    _, top = _ops("spectral")
    k_sq, src = problem()
    res = gmres.solve_helmholtz(top, k_sq, src, restart=30, max_restarts=30,
                                tol=1e-5, device="cpu")
    assert int(res.iterations) < 30 * 30
    rn = res.residual_norms.numpy()
    bnorm = np.linalg.norm(_complex(src))
    assert rn[-1] <= 1e-5 * bnorm * 1.5
    # once converged, every later checkpoint is the frozen solution
    done = int(res.iterations) // 30
    cps = res.checkpoints.numpy()
    assert np.all(cps[done:] == cps[-1])
    np.testing.assert_allclose(cps[-1], res.x.numpy(), rtol=0, atol=0)


def test_early_exit_matches_and_stops():
    _, top = _ops("spectral")
    k_sq, src = problem()
    mv = gmres.make_helmholtz_matvec(top, torch.tensor(k_sq))
    b = torch.tensor(_complex(src).astype(np.complex64))
    x, rn, iters = gmres.gmres_restarted_early_exit(mv, b, restart=30,
                                                   max_restarts=40, tol=1e-5)
    bnorm = float(np.linalg.norm(_complex(src)))
    assert float(rn) <= 1e-5 * bnorm * 1.01
    assert int(iters) < 30 * 40
    full = gmres.solve_helmholtz(top, k_sq, src, restart=30, max_restarts=40,
                                 tol=1e-5, device="cpu")
    xf = full.x.numpy()
    got = torch.view_as_real(x).numpy()
    np.testing.assert_allclose(got, xf, atol=1e-3 * np.abs(xf).max())


def test_chunked_matches_monolithic():
    n, pml = 64, 8
    top = make_operator(n, n, pml, 2.0, 1.0, device="cpu")
    rng = np.random.default_rng(5)
    sos = np.ones((n, n), np.float32)
    sos[20:44, 16:48] = 1.0 + 0.4 * rng.random((24, 32)).astype(np.float32)
    k_sq = (1.0 / sos) ** 2
    src = np.zeros((n, n, 2), np.float32)
    src[48, 32, 0] = 10.0
    opts = dict(mode="matmul", restart=25, tol=1e-6, precond="shifted_laplace",
                device="cpu")
    mono = gmres.solve_helmholtz(top, k_sq, src, max_restarts=12, **opts)
    chun = gmres.solve_helmholtz_chunked(top, k_sq, src, max_cycles=12, **opts)
    assert chun.residual_norms.numpy()[-1] < 1e-5
    xm, xc = mono.x.numpy(), chun.x.numpy()
    assert np.abs(xm - xc).max() < 1e-3 * np.abs(xm).max()
    with pytest.raises(ValueError):
        gmres.solve_helmholtz_chunked(top, k_sq, src, x0=np.zeros((n, n)), **opts)


def test_vdot_conjugates_first_argument():
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((2, 7)) + 1j * rng.standard_normal((2, 7))).astype(np.complex64)
    b = (rng.standard_normal((2, 7)) + 1j * rng.standard_normal((2, 7))).astype(np.complex64)
    got = gmres._vdot(torch.tensor(a), torch.tensor(b)).numpy()
    ref = np.array([np.vdot(a[i], b[i]) for i in range(2)])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert torch.allclose(gmres._vdot(torch.tensor(a[:1]), torch.tensor(b[:1]))[0],
                          torch.vdot(torch.tensor(a[0]), torch.tensor(b[0])))


def test_checked_raises_on_nan_medium():
    top = make_operator(24, 24, 6, 2.0, 1.0, device="cpu")
    src = np.zeros((24, 24, 2), np.float32)
    src[12, 12, 0] = 1.0
    k_sq = np.ones((24, 24), np.float32)
    res = gmres.solve_helmholtz_checked(top, k_sq, src, restart=8, max_restarts=4,
                                        device="cpu")
    assert bool(torch.isfinite(res.x).all())
    bad = k_sq.copy()
    bad[5, 5] = np.nan
    with pytest.raises(FloatingPointError, match="nan"):
        gmres.solve_helmholtz_checked(top, bad, src, restart=8, max_restarts=4,
                                      device="cpu")


def test_solver_refuses_unknown_precond_and_missing_card(monkeypatch):
    _, top = _ops("stencil")
    k_sq, src = problem()
    with pytest.raises(ValueError, match="precond"):
        gmres.solve_helmholtz(top, k_sq, src, precond="cslp", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gmres.solve_helmholtz(top, k_sq, src, max_restarts=1)


def test_batched_gmres_on_the_plain_matvec():
    """`gmres_restarted_batch` with the kernel's plain version as the
    matvec (chip_smoke.py phase 10's reference on the card) gives the
    histories of `solve_helmholtz_batch` on the stencil operator."""
    from helmnet_tpu_torch.ops.stencil_residual import residual_planes_plain

    _, top = _ops("stencil")
    k_sq, src = problem()
    ks = torch.tensor(np.stack([k_sq, np.ones_like(k_sq)]))
    ss = np.stack([src, 0.5 * src])
    ref = gmres.solve_helmholtz_batch(top, ks, ss, restart=10, max_restarts=3,
                                      device="cpu")

    def plain_mv(u, k=ks):
        p = torch.view_as_real(u)
        return torch.complex(*residual_planes_plain(top, p[..., 0], p[..., 1], k))

    b = torch.complex(torch.tensor(ss[..., 0]), torch.tensor(ss[..., 1]))
    got = gmres.gmres_restarted_batch(plain_mv, b, restart=10, max_restarts=3)
    assert got.checkpoints.shape == (2, 3, N, N)
    np.testing.assert_allclose(got.residual_norms.numpy(),
                               ref.residual_norms.numpy(), rtol=HIST_RTOL)
    single = gmres.gmres_restarted(lambda u: plain_mv(u[None], ks[1:])[0], b[1],
                                   restart=10, max_restarts=3)
    np.testing.assert_allclose(single.residual_norms.numpy(),
                               got.residual_norms[1].numpy(), rtol=1e-5)

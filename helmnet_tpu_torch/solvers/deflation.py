"""Deflated restarted GMRES (GCRO-DR) for high-wavenumber Helmholtz, port
of `helmnet_tpu/solvers/deflation.py`.

Restarted GMRES on the Helmholtz operator stagnates because each restart
throws away the slowly converging near-null components. Deflated
restarting keeps a small recycle space spanning them across restarts
(Parks, de Sturler et al., "Recycling Krylov subspaces", GCRO-DR):

  cycle 1   plain Arnoldi GMRES(m); harmonic Ritz vectors of H with the
            k smallest |theta| span the near-null subspace -> U, C = A U
            with C orthonormal (QR in the small coordinate space).
  cycle j   project:  x += U C^H r,  r -= C C^H r        (C-exact solve)
            Arnoldi on (I - C C^H) A for m-k steps, recording
            B = C^H A V; least squares on the Arnoldi block alone,
            z = -B y kills the C-component exactly; x += U z + V y.
            Optionally refresh U from harmonic Ritz of the combined
            space [U, V] (thick restart).

The cycles run on the device (modified Gram-Schmidt, the vectors in
complex64); the small least-squares problems, the nonsymmetric harmonic-
Ritz eigenproblems (`np.linalg.eig`/`solve`, with their `LinAlgError`
fallbacks) and the QR factors are complex128 numpy on the host. The JAX
module moves every block as f32 re/im halves because its TPU runtime has
no complex transfers; here complex64 moves as it is, rounded the same way.

With a StencilPML operator and precond='none', every matvec is one launch
of the fused stencil residual kernel K2a on the card
(solvers/gmres.make_helmholtz_matvec).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from .gmres import _on, _rhs, make_helmholtz_matvec


class DeflatedResult(NamedTuple):
    x: torch.Tensor  # solution, same shape as b
    residual_norms: np.ndarray  # [cycles + 1] true residual 2-norms
    iterations: int  # total inner Arnoldi steps
    ritz_values: np.ndarray  # final recycle-space harmonic Ritz values


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.complex128)


def _dev(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host complex128 array as `like`'s complex dtype on its device (re
    and im each rounded to f32 for complex64)."""
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=like.device,
                                                       dtype=like.dtype)


def _arnoldi(mv, r0: torch.Tensor, steps: int, C: Optional[torch.Tensor] = None):
    """Arnoldi(steps) from r0 with modified Gram-Schmidt, on (I - C C^H) A
    when C is given (r0 must then be C-orthogonal). Returns V
    [steps+1, n] on the device, H [steps+1, steps] and B = C^H A V
    [k, steps] (or None) as host complex128, and beta = ||r0||."""
    n, dtype, dev = r0.shape[0], r0.dtype, r0.device
    beta = torch.linalg.vector_norm(r0)
    safe = lambda x: torch.where(x > 0, x, torch.ones_like(x))
    V = torch.zeros((steps + 1, n), dtype=dtype, device=dev)
    V[0] = r0 / safe(beta)
    H = torch.zeros((steps + 1, steps), dtype=dtype, device=dev)
    B = None if C is None else torch.zeros((C.shape[0], steps), dtype=dtype, device=dev)
    for j in range(steps):
        w = mv(V[j])
        if C is not None:
            bcol = C.conj() @ w  # C^H (A v_j)
            w = w - C.T @ bcol  # project out the recycle image space
            B[:, j] = bcol
        for i in range(j + 1):
            h = torch.dot(V[i].conj(), w)
            w = w - h * V[i]
            H[i, j] = h
        hn = torch.linalg.vector_norm(w)
        H[j + 1, j] = hn.to(dtype)
        V[j + 1] = w / safe(hn)
    return V, _host(H), None if B is None else _host(B), float(beta)


def _harmonic_ritz(H: np.ndarray, k: int):
    """k smallest-|theta| harmonic Ritz pairs of the Arnoldi block H.

    Harmonic Ritz values of A w.r.t. the Krylov space solve
        (H_m + h^2 (H_m^{-H} e_m) e_m^H) g = theta g,   h = H[m, m-1].
    Small-|theta| pairs approximate A's near-null eigenvectors, the
    components restarting loses. Returns P [m, k] (coordinates in V) and
    the theta values."""
    m = H.shape[1]
    Hm = H[:m, :]
    h2 = abs(H[m, m - 1]) ** 2
    em = np.zeros(m, H.dtype)
    em[-1] = 1.0
    try:
        f = np.linalg.solve(Hm.conj().T, em)
    except np.linalg.LinAlgError:
        f = np.zeros(m, H.dtype)
    theta, G = np.linalg.eig(Hm + h2 * np.outer(f, em))
    order = np.argsort(np.abs(theta))[:k]
    return np.ascontiguousarray(G[:, order]), theta[order]


def _combined_harmonic_ritz(G: np.ndarray, ChatW: np.ndarray, k: int):
    """Harmonic Ritz over the combined space W = [U, V_mk].

    With A W = Chat G (Chat = [C, V_{mk+1}] orthonormal), harmonic Ritz
    pairs solve (G^H G) g = theta (G^H Chat^H W) g; ChatW = Chat^H W."""
    Amat = G.conj().T @ G
    Bmat = G.conj().T @ ChatW
    try:
        theta, P = np.linalg.eig(np.linalg.solve(Bmat, Amat))
    except np.linalg.LinAlgError:
        return None, None
    order = np.argsort(np.abs(theta))[:k]
    return np.ascontiguousarray(P[:, order]), theta[order]


def _lstsq(H: np.ndarray, beta: float) -> np.ndarray:
    e1 = np.zeros(H.shape[0], np.complex128)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H, e1, rcond=None)
    return y


def gmres_deflated(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 30,
    k: int = 10,
    max_cycles: int = 20,
    tol: float = 1e-8,
    refresh: bool = True,
    debug_trace: Optional[list] = None,
) -> DeflatedResult:
    """GCRO-DR: restarted GMRES with a k-dimensional recycled deflation
    space. `restart` is the TOTAL subspace size per cycle (k recycled +
    restart-k new Krylov directions), so a cycle costs what GMRES(restart)
    costs. `matvec` maps tensors of b's shape to b's shape, on b's device.
    refresh=True updates the recycle space from the combined [U, V]
    subspace every cycle (thick restart); refresh=False freezes it after
    cycle 1."""
    if not (0 < k < restart):
        raise ValueError("need 0 < k < restart")
    mk = restart - k
    shape = b.shape
    mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    flat = b.reshape(-1)
    x = torch.zeros_like(flat) if x0 is None else x0.reshape(-1)

    def residual(x):
        r = flat - mv(x)
        return r, float(torch.linalg.vector_norm(r))

    bnorm = float(torch.linalg.vector_norm(flat))
    r, rn = residual(x)
    norms = [rn]
    iters = 0
    U = C = None
    theta = np.zeros(0, np.complex128)

    for _ in range(max_cycles):
        if norms[-1] <= tol * max(bnorm, 1e-30):
            break
        if U is None:
            # first cycle: plain GMRES(restart), then harvest U, C
            V, Hh, _, beta = _arnoldi(mv, r, restart)
            iters += restart
            y = _lstsq(Hh, beta)
            x = x + V[:restart].T @ _dev(y, V)
            P, theta = _harmonic_ritz(Hh, k)
            # C = V Q, U = (V[:m]^T P) R^-1 with Hbar P = Q R
            Q, R = np.linalg.qr(Hh @ P)
            U = V[:restart].T @ _dev(P @ np.linalg.inv(R), V)
            C = (V.T @ _dev(Q, V)).T
        else:
            # GCRO cycle: recycle-space solve, then projected Arnoldi
            z = C.conj() @ r
            x = x + U @ z
            r = r - C.T @ z
            V, Hh, Bh, beta = _arnoldi(mv, r, mk, C)
            iters += mk
            y = _lstsq(Hh, beta)
            x = x + V[:mk].T @ _dev(y, V) + U @ _dev(-Bh @ y, U)
            if refresh:
                # A [U V] = [C V+] G,  G = [[I, B], [0, H]]
                G = np.block([
                    [np.eye(k, dtype=np.complex128), Bh],
                    [np.zeros((mk + 1, k), np.complex128), Hh],
                ])
                ChatW = np.block([
                    [_host(C.conj() @ U), np.zeros((k, mk), np.complex128)],
                    [_host(V.conj() @ U), np.vstack([np.eye(mk), np.zeros((1, mk))])],
                ])
                P, th = _combined_harmonic_ritz(G, ChatW, k)
                if P is not None and np.all(np.isfinite(P)):
                    Q, R = np.linalg.qr(G @ P)
                    if np.linalg.cond(R) < 1e12:
                        # theta only changes when the refresh is installed,
                        # so ritz_values describe the space in use
                        theta = th
                        PRinv = P @ np.linalg.inv(R)
                        U = U @ _dev(PRinv[:k], U) + V[:mk].T @ _dev(PRinv[k:], V)
                        C = (C.T @ _dev(Q[:k], C) + V.T @ _dev(Q[k:], V)).T
        r, rn = residual(x)
        norms.append(rn)
        if debug_trace is not None:
            debug_trace.append((_host(U), _host(C), theta))

    return DeflatedResult(
        x=x.reshape(shape),
        residual_norms=np.asarray(norms),
        iterations=iters,
        ritz_values=theta,
    )


def solve_helmholtz_deflated(
    op,
    k_sq,
    source,
    *,
    mode: str = "matmul",
    restart: int = 30,
    k: int = 10,
    max_cycles: int = 20,
    tol: float = 1e-8,
    precond: str = "none",
    shift: tuple = (1.0, 0.5),
    refresh: bool = True,
    device=None,
) -> DeflatedResult:
    """Deflated GMRES front end for (L + k^2) u = s, on the card unless
    `device` says otherwise.

    precond='shifted_laplace' deflates the right-preconditioned operator
    A M^{-1}: CSLP clusters the bulk of the spectrum and deflation removes
    the near-null stragglers it cannot move. Returns the channel pair x
    [H, W, 2]; residual norms are true residuals of the (preconditioned)
    system solved."""
    dev = resolve_device(device)
    op = op.to(dev)
    k_sq = _on(k_sq, dev, torch.float32)
    b = _rhs(source, dev, batched=False)
    mv_field = make_helmholtz_matvec(op, k_sq, mode)
    mv = lambda v: mv_field(v[None])[0]
    opts = dict(restart=restart, k=k, max_cycles=max_cycles, tol=tol, refresh=refresh)
    if precond == "shifted_laplace":
        from .precond import make_shifted_laplace_inverse

        minv = make_shifted_laplace_inverse(op, k_sq, shift)
        res = gmres_deflated(lambda v: mv(minv(v)), b, **opts)
        res = res._replace(x=minv(res.x))
    else:
        res = gmres_deflated(mv, b, **opts)
    return res._replace(x=torch.view_as_real(res.x))

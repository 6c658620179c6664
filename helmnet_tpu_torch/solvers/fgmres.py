"""Flexible GMRES with any right preconditioner, the learned one above all,
port of `helmnet_tpu/solvers/fgmres.py`.

Each outer step applies z_j = M_j^-1 v_j where M_j^-1 may change from
step to step: K learned iterations on the auxiliary problem A z = v_j
(amplitude-normalised into the network's training range, solved from a
fresh zero state), a two-level cycle (solvers/twolevel.py) or the CSLP
inverse. Flexible GMRES (Saad 1993) stores the preconditioned vectors Z
and forms x = x0 + Z y, so any per-step operator is admissible, and the
outer least-squares problem keeps the true residual falling.

Three cycle kinds, with the JAX package's meaning:
- the device cycle (`host_arnoldi=False`): modified Gram-Schmidt, and the
  small least-squares problem min ||beta e1 - H y|| solved in complex64
  (f32) where the vectors live, by SVD (`torch.linalg.pinv`, minimum
  norm, jnp.linalg.lstsq's cutoff), as the JAX cycle solves it in f32 on
  the device;
- the host cycle (`host_arnoldi=True`): classical Gram-Schmidt with one
  reorthogonalisation (CGS2) against the whole masked basis, one host
  read of H's column per Krylov step, and the least-squares problem in
  complex128 numpy on the host;
- the recycled host cycle (`recycle_k > 0`, FGCRO-DR): the host cycle with
  a k-dimensional harmonic-Ritz deflation space (U, C = A U) carried
  across cycles and across calls through `FGMRESResult.recycle_state`; its
  eigenproblems, QR and the `cond(R) < 1e12` guard are host numpy code
  (solvers/deflation.py).

The JAX module wraps its cycle functions in `core/hoist.LazyHoistedJit`,
which turns arrays captured by a jitted closure into arguments because
jit embeds captures as literals and very large ones overflowed the TPU
runtime's remote compile. Eager PyTorch captures nothing into a compiled
program, so the port has no counterpart of `core/hoist.py`. Nor of its
f32 channel-pair transfers: complex64 moves to and from the card as it
is, with the same rounding.

K1 (the fused DoubleConv kernel) runs inside every learned preconditioner
application on the card. `make_learned_preconditioner` moves the params
to the device and prepares K1's weights once, so the `restart x cycles`
rollouts it makes reuse them, and it normalises the amplitude with
`torch.where` on the device, with no host read per application.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..models.hybridnet import params_to
from ..models.registry import get_architecture
from .deflation import _combined_harmonic_ritz, _dev, _harmonic_ritz, _host, _lstsq
from .gmres import _norm, _on, _rhs, make_helmholtz_matvec
from .iterative import rollout


class FGMRESResult(NamedTuple):
    wavefield: torch.Tensor  # [H, W, 2] solution (channel pair), or flat complex
    residual_norms: torch.Tensor  # [cycles + 1] true relative residuals
    iterations: int  # outer Krylov iterations performed
    recycle_state: Optional[tuple] = None  # (U, C) device bases (FGCRO-DR)


def make_learned_preconditioner(params, op, sos_map, *, cfg: Config,
                                iterations: int = 20, device=None):
    """complex [H, W] -> complex [H, W] approximate A^-1 v.

    Runs `iterations` learned steps on A z = v from a zero wavefield and
    FRESH hidden states, with v amplitude-normalised to the training
    source scale (the solve is linear, the network is not); returns the
    best iterate, un-normalised."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    # K1's weights converted once, not once a rollout
    params = get_architecture(cfg.model.architecture).prepare_params(params, cfg.model)
    op = op.to(dev)
    sos = _on(sos_map, dev, torch.float32)[None]
    amplitude = float(cfg.source.amplitude)

    def apply(v: torch.Tensor) -> torch.Tensor:
        src = torch.view_as_real(v)[None]
        amp = v.abs().max()
        scale = torch.where(amp > 0, amplitude / amp, torch.ones_like(amp))
        out = rollout(params, op, src * scale, sos, cfg=cfg,
                      num_iterations=iterations, collect=("rmse", "best"),
                      device=dev)
        w = out["best_wavefield"][0] / scale
        return torch.complex(w[..., 0], w[..., 1])

    return apply


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.ones_like(x))


def _lstsq_f32(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """min_y ||rhs - h y|| in h's precision on h's device: the SVD
    pseudo-inverse with jnp.linalg.lstsq's cutoff eps * max(m+1, m)."""
    rtol = torch.finfo(h.real.dtype).eps * max(h.shape)
    return torch.linalg.pinv(h, rtol=rtol) @ rhs


def _fgmres_cycle(matvec, precond, b, x0, restart: int):
    """One FGMRES(m) cycle on flat complex vectors; x = x0 + Z y with
    per-iteration Z_j (modified Gram-Schmidt, least squares in f32)."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    r0 = b - matvec(x0)
    beta = _norm(r0)
    V = torch.zeros((restart + 1, n), dtype=dtype, device=dev)
    V[0] = r0 / _safe(beta)
    Z = torch.zeros((restart, n), dtype=dtype, device=dev)
    H = torch.zeros((restart + 1, restart), dtype=dtype, device=dev)
    for j in range(restart):
        z = precond(V[j])
        w = matvec(z)
        for i in range(j + 1):
            h = torch.dot(V[i].conj(), w)
            w = w - h * V[i]
            H[i, j] = h
        hnorm = _norm(w)
        H[j + 1, j] = hnorm.to(dtype)
        V[j + 1] = w / _safe(hnorm)
        Z[j] = z
    e1 = torch.zeros(restart + 1, dtype=dtype, device=dev)
    e1[0] = beta.to(dtype)
    y = _lstsq_f32(H, e1)
    return torch.where(beta > 0, x0 + Z.T @ y, x0)


def _cgs2_step(V, Z, j: int, z, w):
    """Classical Gram-Schmidt with one reorthogonalisation against the
    whole basis with masked coefficients (rows past j of V are zero);
    writes V[j+1] and Z[j] and returns H's column [m+1]."""
    mask = torch.arange(V.shape[0], device=V.device) <= j
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    h1 = torch.where(mask, V.conj() @ w, zero)
    w = w - V.T @ h1
    h2 = torch.where(mask, V.conj() @ w, zero)
    w = w - V.T @ h2
    hcol = h1 + h2
    hn = _norm(w)
    hcol[j + 1] = hn.to(V.dtype)
    V[j + 1] = w / _safe(hn)
    Z[j] = z
    return hcol


def _alloc(mv, bv, x, m: int):
    r0 = bv - mv(x)
    beta = _norm(r0)
    V = torch.zeros((m + 1, bv.shape[0]), dtype=bv.dtype, device=bv.device)
    V[0] = r0 / _safe(beta)
    Z = torch.zeros((m, bv.shape[0]), dtype=bv.dtype, device=bv.device)
    return V, Z, float(beta)


def _make_host_arnoldi_cycle(mv, precond, restart: int):
    """FGMRES(m) cycle driven from the host: one CGS2 Krylov step at a
    time, H's column read back after each, and the small least-squares
    problem solved on the host in complex128."""

    def cycle(bvec, x):
        V, Z, beta = _alloc(mv, bvec, x, restart)
        if beta == 0.0:
            return x
        H = np.zeros((restart + 1, restart), np.complex128)
        for j in range(restart):
            z = precond(V[j])
            H[:, j] = _host(_cgs2_step(V, Z, j, z, mv(z)))
        y = _lstsq(H, beta)
        return x + Z.T @ _dev(y, Z)

    return cycle


def _make_recycled_host_cycle(mv, precond, restart: int, k: int):
    """FGCRO-DR: host-Arnoldi flexible GMRES with a k-dimensional recycled
    deflation space carried across restart cycles (and across calls via
    FGMRESResult.recycle_state).

    Harmonic-Ritz approximations of the slowly converging components are
    kept as U (solution space) and C = A U (orthonormal image space):
    every cycle first solves exactly in span(U), then runs the flexible
    Arnoldi on the projected operator (I - C C^H) A. The pair satisfies
    A U^T = C^T, a property of A alone, so it stays valid when the
    preconditioner changes between cycles. Bases are row-major [k, n] /
    [m+1, n] on the device; the small eigenproblems, QR and inverses run
    in complex128 numpy on the host."""
    m = restart
    state = {"U": None, "C": None}

    def set_state(UC):
        if UC is not None:
            state["U"], state["C"] = UC

    def get_state():
        return (state["U"], state["C"]) if state["U"] is not None else None

    def cycle(bvec, x):
        if state["U"] is None:
            # first cycle: plain flexible Arnoldi, then harvest U, C
            V, Z, beta = _alloc(mv, bvec, x, m)
            if beta == 0.0:
                return x
            H = np.zeros((m + 1, m), np.complex128)
            for j in range(m):
                z = precond(V[j])
                H[:, j] = _host(_cgs2_step(V, Z, j, z, mv(z)))
            y = _lstsq(H, beta)
            x = x + Z.T @ _dev(y, Z)
            P, _ = _harmonic_ritz(H, k)
            Q, R = np.linalg.qr(H @ P)
            if np.linalg.cond(R) < 1e12:
                # with Hbar P = Q R: U = (Z^T P R^-1)^T, C = (V^T Q)^T, so
                # A U^T = C^T by the Arnoldi relation A Z^T = V^T Hbar
                PRinv = P @ np.linalg.inv(R)
                state["U"] = _dev(PRinv, Z).T @ Z
                state["C"] = _dev(Q, V).T @ V
            return x
        # recycled cycle: project, deflated Arnoldi, refresh
        U, C = state["U"], state["C"]
        r0 = bvec - mv(x)
        t = C.conj() @ r0
        x = x + U.T @ t
        r = r0 - C.T @ t
        beta_t = _norm(r)
        V = torch.zeros((m + 1, bvec.shape[0]), dtype=bvec.dtype, device=bvec.device)
        V[0] = r / _safe(beta_t)
        Z = torch.zeros((m, bvec.shape[0]), dtype=bvec.dtype, device=bvec.device)
        beta = float(beta_t)
        if beta == 0.0:
            return x
        H = np.zeros((m + 1, m), np.complex128)
        B = np.zeros((k, m), np.complex128)
        for j in range(m):
            z = precond(V[j])
            w = mv(z)
            bcol = C.conj() @ w  # C^H A M(v_j)
            w = w - C.T @ bcol
            H[:, j] = _host(_cgs2_step(V, Z, j, z, w))
            B[:, j] = _host(bcol)
        y = _lstsq(H, beta)
        # x += Z^T y + U^T (-B y): -B y cancels the C-component the new
        # directions bring back (A Z^T = C^T B + V^T Hbar)
        x = x + Z.T @ _dev(y, Z) + U.T @ _dev(-B @ y, U)
        # thick restart: harmonic Ritz over the combined space [U^T, Z^T];
        # A W = Chat G with G = [[I, B], [0, H]]
        G = np.block([
            [np.eye(k, dtype=np.complex128), B],
            [np.zeros((m + 1, k), np.complex128), H],
        ])
        ChatW = _host(torch.cat([
            torch.cat([C.conj() @ U.T, C.conj() @ Z.T], dim=1),
            torch.cat([V.conj() @ U.T, V.conj() @ Z.T], dim=1),
        ], dim=0))
        P, _ = _combined_harmonic_ritz(G, ChatW, k)
        if P is not None and np.all(np.isfinite(P)):
            Q, R = np.linalg.qr(G @ P)
            if np.linalg.cond(R) < 1e12:
                PRinv = P @ np.linalg.inv(R)
                state["U"] = (_dev(PRinv[:k], U).T @ U
                              + _dev(PRinv[k:], Z).T @ Z)
                state["C"] = (_dev(Q[:k], C).T @ C
                              + _dev(Q[k:], V).T @ V)
        return x

    cycle.set_state = set_state
    cycle.get_state = get_state
    return cycle


def solve_fgmres(
    op,
    source,
    sos_map,
    *,
    cfg: Config,
    precond_field,
    restart: int = 10,
    max_restarts: int = 10,
    tol: float = 1e-5,
    x0=None,
    host_arnoldi: bool = False,
    recycle_k: int = 0,
    recycle_state: Optional[tuple] = None,
    budget_s: Optional[float] = None,
    on_cycle=None,
    keep_x_complex: bool = False,
    verbose: bool = False,
    device=None,
) -> FGMRESResult:
    """Solve A u = s with flexible GMRES under ANY (possibly nonlinear,
    iteration-varying) right preconditioner `precond_field`: complex
    [H, W] -> complex [H, W], on the same device.

    source: [H, W, 2] channel pair; sos_map: [H, W]. Returns the true
    relative residual after every restart cycle. `host_arnoldi=True` reads
    H back one Krylov step at a time and solves the least squares in
    float64 on the host. `recycle_k > 0` (needs host_arnoldi) carries a
    k-dimensional harmonic-Ritz deflation space across cycles and, through
    result.recycle_state -> the next call's `recycle_state`, across calls.
    `budget_s` stops the cycle loop on wall-clock time; `on_cycle(norms)`
    runs after every cycle; `keep_x_complex=True` returns the flat complex
    solution in `wavefield` instead of the [H, W, 2] pair (pass it back as
    `x0`, which also takes a flat complex vector, to continue)."""
    dev = resolve_device(device)
    op = op.to(dev)
    b = _rhs(source, dev, batched=False)
    shape = tuple(b.shape)
    k_sq = (cfg.source.omega / _on(sos_map, dev, torch.float32)) ** 2
    mv_field = make_helmholtz_matvec(op, k_sq, cfg.operator_mode)
    mv = lambda v: mv_field(v.reshape((1,) + shape)).reshape(-1)
    precond = lambda v: precond_field(v.reshape(shape)).reshape(-1)
    return run_fgmres_loop(
        mv, precond, b.reshape(-1), shape, restart=restart,
        max_restarts=max_restarts, tol=tol, x0=x0,
        host_arnoldi=host_arnoldi, recycle_k=recycle_k,
        recycle_state=recycle_state, budget_s=budget_s, on_cycle=on_cycle,
        keep_x_complex=keep_x_complex, verbose=verbose,
    )


def run_fgmres_loop(
    mv,
    precond,
    bvec: torch.Tensor,
    shape: tuple,
    *,
    restart: int,
    max_restarts: int,
    tol: float,
    x0=None,
    host_arnoldi: bool = False,
    recycle_k: int = 0,
    recycle_state=None,
    budget_s=None,
    on_cycle=None,
    keep_x_complex: bool = False,
    verbose: bool = False,
    label: str = "fgmres",
) -> FGMRESResult:
    """The FGMRES host loop over flat complex vectors; see solve_fgmres
    for the meaning of every option."""
    if recycle_k > 0:
        if not host_arnoldi:
            raise ValueError("recycle_k > 0 requires host_arnoldi=True")
        if not (0 < recycle_k < restart):
            raise ValueError("need 0 < recycle_k < restart")
        cycle = _make_recycled_host_cycle(mv, precond, restart, recycle_k)
        cycle.set_state(recycle_state)
    elif host_arnoldi:
        cycle = _make_host_arnoldi_cycle(mv, precond, restart)
    else:
        cycle = lambda bv, x: _fgmres_cycle(mv, precond, bv, x, restart)

    bnorm = torch.clamp_min(_norm(bvec), 1e-30)
    true_relres = lambda x: float(_norm(bvec - mv(x)) / bnorm)

    if x0 is None:
        x = torch.zeros_like(bvec)
    elif isinstance(x0, torch.Tensor) and x0.is_complex():
        x = x0.to(bvec.device).reshape(-1)
    else:
        x = _rhs(x0, bvec.device, batched=False).reshape(-1)
    norms = [true_relres(x)]
    it = 0
    t0 = time.time()
    for _ in range(max_restarts):
        if norms[-1] < tol:
            break
        if budget_s is not None and time.time() - t0 > budget_s:
            break
        x = cycle(bvec, x)
        it += restart
        norms.append(true_relres(x))
        if on_cycle is not None:
            on_cycle(list(norms))
        if verbose:
            print(f"  {label}[{it}]: rel={norms[-1]:.3e}", flush=True)
    wavefield = x if keep_x_complex else torch.view_as_real(x.reshape(shape))
    return FGMRESResult(
        wavefield=wavefield,
        residual_norms=torch.tensor(norms, dtype=torch.float32),
        iterations=it,
        recycle_state=cycle.get_state() if recycle_k > 0 else None,
    )


def solve_fgmres_learned(
    params,
    op,
    source,
    sos_map,
    *,
    cfg: Config,
    inner_iterations: int = 20,
    restart: int = 10,
    max_restarts: int = 10,
    tol: float = 1e-5,
    x0=None,
    host_arnoldi: bool = False,
    verbose: bool = False,
    device=None,
) -> FGMRESResult:
    """Flexible GMRES with the LEARNED solver as the preconditioner (see
    the module docstring): a thin front end over solve_fgmres."""
    precond_field = make_learned_preconditioner(
        params, op, sos_map, cfg=cfg, iterations=inner_iterations, device=device)
    return solve_fgmres(
        op, source, sos_map, cfg=cfg, precond_field=precond_field,
        restart=restart, max_restarts=max_restarts, tol=tol, x0=x0,
        host_arnoldi=host_arnoldi, verbose=verbose, device=device,
    )

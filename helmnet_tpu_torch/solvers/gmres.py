"""Matrix-free restarted GMRES for the PML Helmholtz system, port of
`helmnet_tpu/solvers/gmres.py`.

Restarted GMRES(m) with a solution and a true residual norm recorded
after every restart cycle (as the reference's MATLAB GMRES script does),
matrix-free: the operator is the spectral PML operator (ops/spectral.py)
or the FD stencil operator (ops/stencil.py). On the card the stencil
matvec `L u + k^2 u` is one launch of the fused residual kernel with no
source (ops/stencil_residual.py, K2), reading and writing complex64
through stride-2 views.

The solver is batched: vectors are `[B, n]` complex64 (complex64 as in
the JAX package without x64), and each Arnoldi step applies the operator
to the whole batch at once; `solve_helmholtz_batch` is this batch, where
the JAX package vmaps single solves. The JAX `lax.scan` / `fori_loop`
become Python loops with the same static semantics: every problem runs
`max_restarts` cycles and records every checkpoint; a problem that has
converged keeps its solution by masking, not by leaving the loop (only
`gmres_restarted_early_exit` stops early). Modified Gram-Schmidt runs
over `i <= j` only; the JAX loop's masked terms are exact zeros, so the
numbers are the same.

The small least-squares problem of each cycle, min ||beta e1 - H y|| on
`[B, m+1, m]`, is solved on the host with LAPACK's SVD-based `gelsd`,
minimum norm, as `jnp.linalg.lstsq` does. This is a numerical choice, not
a device fallback: `torch.linalg.lstsq` on CUDA has only `gels`, which
assumes full rank, and gives NaN for the rank-deficient H of a converged
problem (beta = 0) or of a happy breakdown. It costs one small copy and
one synchronisation per cycle.

`spatial=` (a distributed/spatial.Spatial) solves on a grid split over
the mesh axes y and x, as GSPMD partitions the JAX package's solve:
k^2, the source, the Krylov basis and x are this rank's tiles, the
matvec is the partitioned operator (`helmholtz_residual(..., spatial=)`
for the spectral operator in either mode; the halo-exchanged stencil
residual of distributed/halo.py for a StencilPML), and every norm and
inner product is completed over y and x (`Spatial.sum`), so the small
least-squares solve runs on the same numbers on every rank. Each
completion is a collective, so there the Arnoldi step orthogonalises by
classical Gram-Schmidt run twice (CGS2, as the host FGMRES cycle of
solvers/fgmres.py does): two all-reduces of its j + 1 inner products,
where modified Gram-Schmidt needs j + 1 all-reduces in sequence. CGS2
keeps the basis orthogonal to working precision, as MGS does; the
trajectory differs from the unsplit one in rounding only. The CSLP
preconditioner runs there too: its inverse takes the whole grid's kref
and transforms one axis at a time on pencils (solvers/precond.py).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..distributed.halo import make_sharded_stencil_residual
from ..ops.spectral import helmholtz_residual, laplacian
from ..ops.stencil import StencilPML
from ..ops.stencil_residual import helmholtz_residual_stencil_auto
from .precond import make_shifted_laplace_inverse


class GMRESResult(NamedTuple):
    x: torch.Tensor  # solution, same shape as b
    residual_norms: torch.Tensor  # [num_restarts + 1] true residual 2-norms
    checkpoints: torch.Tensor  # [num_restarts, *b.shape] solution after each cycle
    iterations: torch.Tensor  # total inner iterations performed


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.vdot per row: conj(a) . b over the last axis."""
    return (a.conj() * b).sum(-1)


def _norm_of(spatial):
    """The 2-norm over the last axis; with `spatial`, of the global vectors
    whose tiles these are."""
    if spatial is None:
        return _norm
    return lambda v: torch.sqrt(spatial.sum(torch.sum(v.real**2 + v.imag**2, -1)))


def _lstsq_host(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """min_y ||rhs - h y|| per problem: h [B, m+1, m], rhs [B, m+1] ->
    y [B, m], by SVD (gelsd) on the host, rcond eps * max(m+1, m) as in
    jnp.linalg.lstsq (see the module docstring)."""
    sol = torch.linalg.lstsq(h.cpu(), rhs.cpu()[..., None], driver="gelsd").solution
    return sol[..., 0].to(h.device)


def _arnoldi_cycle(matvec, b: torch.Tensor, x0: torch.Tensor, restart: int,
                   spatial=None):
    """One GMRES(m) cycle for a batch: b, x0 [B, n]; matvec maps [B, n] to
    [B, n]. Returns the new iterate [B, n]."""
    norm = _norm_of(spatial)
    nb, n = b.shape
    dtype, dev = b.dtype, b.device
    r0 = b - matvec(x0)
    beta = norm(r0)
    safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))

    # [m+1, B, n]: V[j] is a contiguous [B, n] block for the matvec
    V = torch.zeros((restart + 1, nb, n), dtype=dtype, device=dev)
    V[0] = r0 / safe_beta[:, None]
    H = torch.zeros((nb, restart + 1, restart), dtype=dtype, device=dev)
    for j in range(restart):
        w = matvec(V[j])
        if spatial is None:
            # modified Gram-Schmidt against V[0..j]
            for i in range(j + 1):
                h = _vdot(V[i], w)
                w = w - h[:, None] * V[i]
                H[:, i, j] = h
        else:
            # classical Gram-Schmidt, twice: each pass's j + 1 inner
            # products make one all-reduce, where MGS makes one of each
            basis = V[: j + 1]
            for _ in range(2):
                h = spatial.sum(torch.einsum("kbn,bn->bk", basis.conj(), w))
                w = w - torch.einsum("kbn,bk->bn", basis, h)
                H[:, : j + 1, j] += h
        hnorm = norm(w)
        H[:, j + 1, j] = hnorm.to(dtype)
        safe = torch.where(hnorm > 0, hnorm, torch.ones_like(hnorm))
        V[j + 1] = w / safe[:, None]

    e1 = torch.zeros((nb, restart + 1), dtype=dtype, device=dev)
    e1[:, 0] = beta.to(dtype)
    y = _lstsq_host(H, e1)
    x_new = x0 + torch.einsum("mbn,bm->bn", V[:restart], y)
    # per problem, as jnp.where(beta > 0, ...) under vmap
    return torch.where((beta > 0)[:, None], x_new, x0)


def _gmres(mv, b: torch.Tensor, x0: Optional[torch.Tensor], restart: int,
           max_restarts: int, tol: float, spatial=None):
    """The batched restarted loop on flat vectors b [B, n]. Returns (x
    [B, n], residual norms [B, max_restarts + 1], checkpoints
    [max_restarts, B, n], iterations [B])."""
    norm = _norm_of(spatial)
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = norm(b)
    norms = [norm(b - mv(x))]
    done = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    xs = []
    for _ in range(max_restarts):
        x_new = _arnoldi_cycle(mv, b, x, restart, spatial)
        x = torch.where(done[:, None], x, x_new)
        rn = norm(b - mv(x))
        iters = iters + torch.where(done, 0, restart)
        done = done | (rn <= tol * torch.clamp_min(bnorm, 1e-30))
        xs.append(x)
        norms.append(rn)
    return x, torch.stack(norms, dim=-1), torch.stack(xs), iters


def gmres_restarted_batch(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 20,
    max_restarts: int = 50,
    tol: float = 1e-10,
    spatial=None,
) -> GMRESResult:
    """Restarted GMRES with per-cycle solution checkpoints for a batch of
    independent problems b [B, ...]; `matvec` maps [B, ...] to [B, ...]
    (one operator application for the whole batch). With `spatial`, b,
    x0 and what `matvec` maps are this rank's tiles of [B, H, W] grids,
    and the norms are global.

    Runs `max_restarts` cycles of GMRES(restart) and records each
    problem's solution and TRUE residual norm ||b - A x|| after each
    cycle. Once a problem's residual falls below `tol * ||b||`, further
    cycles keep its converged solution (masked). Returns x [B, ...],
    residual_norms [B, max_restarts + 1], checkpoints
    [B, max_restarts, ...] and iterations [B]."""
    shape = b.shape
    nb = shape[0]
    mv = lambda v: matvec(v.reshape(shape)).reshape(nb, -1)
    x, norms, xs, iters = _gmres(
        mv, b.reshape(nb, -1), None if x0 is None else x0.reshape(nb, -1),
        restart, max_restarts, tol, spatial)
    return GMRESResult(
        x=x.reshape(shape),
        residual_norms=norms,
        checkpoints=xs.transpose(0, 1).reshape((nb, max_restarts) + tuple(shape[1:])),
        iterations=iters,
    )


def gmres_restarted(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 20,
    max_restarts: int = 50,
    tol: float = 1e-10,
) -> GMRESResult:
    """`gmres_restarted_batch` for one problem: `matvec` maps tensors of
    b's shape to b's shape; the result has no batch axis."""
    res = gmres_restarted_batch(
        lambda v: matvec(v[0])[None], b[None], None if x0 is None else x0[None],
        restart=restart, max_restarts=max_restarts, tol=tol)
    return GMRESResult(*(t[0] for t in res))


# ---------------------------------------------------------------------------
# Helmholtz front end
# ---------------------------------------------------------------------------


def make_helmholtz_matvec(op, k_sq: torch.Tensor, mode: str = "auto",
                          spatial=None):
    """Complex matvec u -> L u + k^2 u on [..., H, W] complex grids.

    `op` may be the spectral operator (SpectralPML; `mode` selects
    matmul/fft) or the FD stencil operator (StencilPML): GMRES on the
    sparse stencil system, which on the card is one launch of the fused
    residual kernel (K2, no source) on stride-2 views of complex64. With
    `spatial`, u and k_sq are this rank's tiles; on a StencilPML the
    matvec is the halo-exchanged residual of distributed/halo.py (the
    plain stencil on the widened tile, not K2)."""
    if isinstance(op, StencilPML) and spatial is not None:
        residual = make_sharded_stencil_residual(spatial.mesh, op)
        return lambda u: torch.view_as_complex(
            residual(torch.view_as_real(u), k_sq, 0.0).contiguous())

    def mv(u: torch.Tensor) -> torch.Tensor:
        pair = torch.view_as_real(u)
        if isinstance(op, StencilPML):
            return torch.view_as_complex(
                helmholtz_residual_stencil_auto(op, pair, k_sq))
        lap = laplacian(op, pair, mode, spatial)
        return torch.view_as_complex(lap.contiguous()) + k_sq.to(u.real.dtype) * u

    return mv


def _on(t, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
    return t.to(device=device, dtype=dtype)


def _rhs(source, device, batched: bool, dims: int = 2) -> torch.Tensor:
    """A channel pair [..., H, W, 2] (in 3D [..., D, H, W, 2]) or a real or
    complex [..., H, W] source -> complex64. A real source still has a
    complex solution."""
    s = _on(source, device)
    if s.dim() == dims + 1 + batched and s.shape[-1] == 2:
        s = s.to(torch.float32)
        return torch.complex(s[..., 0], s[..., 1])
    return s.to(torch.complex64)


def _solve(op, k_sq, b, *, mode, restart, max_restarts, tol, precond,
           shift, spatial=None) -> GMRESResult:
    """GMRES on b [B, H, W] complex; complex fields in the result."""
    if precond not in ("none", "shifted_laplace"):
        raise ValueError(f"unknown precond {precond!r} (use 'none' or "
                         f"'shifted_laplace')")
    mv = make_helmholtz_matvec(op, k_sq, mode, spatial)
    opts = dict(restart=restart, max_restarts=max_restarts, tol=tol,
                spatial=spatial)
    if precond == "none":
        return gmres_restarted_batch(mv, b, **opts)
    minv = make_shifted_laplace_inverse(op, k_sq, shift, spatial=spatial)
    res = gmres_restarted_batch(lambda v: mv(minv(v)), b, **opts)
    # right preconditioning: x = M^-1 y (M^-1 per problem, over the cycles)
    return res._replace(x=minv(res.x),
                        checkpoints=minv(res.checkpoints.transpose(0, 1)).transpose(0, 1))


def solve_helmholtz(
    op,
    k_sq,
    source,
    *,
    mode: str = "auto",
    restart: int = 20,
    max_restarts: int = 50,
    tol: float = 1e-10,
    precond: str = "none",
    shift: tuple = (1.0, 0.5),
    device=None,
    spatial=None,
) -> GMRESResult:
    """Solve (L + k^2) u = s for one problem.

    k_sq: [H, W] real; source: [H, W, 2] channel pair (or [H, W] complex
    or real). Returns channel-pair fields x [H, W, 2] and checkpoints
    [max_restarts, H, W, 2]. f32 stagnates near 1e-6 relative.

    precond='shifted_laplace' right-preconditions with the FFT-diagonal
    complex shifted Laplacian (solvers/precond.py; spectral operator only).
    Residual norms remain TRUE residuals of the original system. Runs on
    the card unless `device` says otherwise.

    `spatial`: k_sq and source are this rank's tiles of a grid split over
    the mesh axes y and x, and so are x and the checkpoints; the residual
    norms are the global ones (module docstring). The CSLP inverse then
    runs on pencils with the whole grid's kref (solvers/precond.py)."""
    dev = resolve_device(device)
    op = op.to(dev)
    k_sq = _on(k_sq, dev, torch.float32)
    b = _rhs(source, dev, batched=False)[None]
    res = _solve(op, k_sq, b, mode=mode, restart=restart,
                 max_restarts=max_restarts, tol=tol, precond=precond, shift=shift,
                 spatial=spatial)
    # complex -> channel-pair fields, as the JAX package returns them
    return GMRESResult(torch.view_as_real(res.x[0]), res.residual_norms[0],
                       torch.view_as_real(res.checkpoints[0]), res.iterations[0])


def solve_helmholtz_checked(op, k_sq, source, **kw) -> GMRESResult:
    """`solve_helmholtz` run under `core/sanitize.checked`: a NaN or inf
    born anywhere in the solve (for example from a non-finite medium or
    source) raises FloatingPointError naming the op, or the hand kernel
    (K2 on a StencilPML on the card), and its location, instead of filling
    the checkpoints with NaNs, as the JAX package's checkify-instrumented
    solve does. The operator's tables are held to `check_finite` first."""
    from ..core.sanitize import check_finite, checked

    def solve():
        check_finite(op.tables() if isinstance(op, StencilPML) else tuple(op),
                     "the operator's tables")
        return solve_helmholtz(op, k_sq, source, **kw)

    return checked(solve)()


def solve_helmholtz_batch(op, k_sq_batch, source_batch, **kw) -> GMRESResult:
    """A test-set sweep as one batched solve: k_sq_batch [B, H, W],
    source_batch [B, H, W, 2] (or [B, H, W] complex). Every Arnoldi step
    applies the operator once to the whole batch (on a StencilPML, one K2
    launch); each problem is masked once it converges. The same results
    as B calls of `solve_helmholtz` (the JAX package vmaps them)."""
    dev = resolve_device(kw.pop("device", None))
    op = op.to(dev)
    k_sq = _on(k_sq_batch, dev, torch.float32)
    b = _rhs(source_batch, dev, batched=True)
    res = _solve(op, k_sq, b, **{
        "mode": "auto", "restart": 20, "max_restarts": 50, "tol": 1e-10,
        "precond": "none", "shift": (1.0, 0.5), **kw})
    return res._replace(x=torch.view_as_real(res.x),
                        checkpoints=torch.view_as_real(res.checkpoints))


def solve_helmholtz_chunked(
    op,
    k_sq,
    source,
    *,
    mode: str = "auto",
    restart: int = 25,
    max_cycles: int = 160,
    tol: float = 1e-4,
    precond: str = "shifted_laplace",
    shift: tuple = (1.0, 0.5),
    budget_s: float = float("inf"),
    verbose: bool = False,
    x0=None,
    device=None,
):
    """Host-chunked restarted GMRES: one restart cycle per call, warm-started
    by defect correction (u += solve(-r(u))).

    x0: optional [H, W, 2] channel-pair initial iterate (for example the
    best iterate of a learned rollout). Every cycle solves against the TRUE
    residual of the running iterate, so a good x0 only shrinks the work,
    and the reported norms are true relative residuals of the original
    system. Stops at `tol`, after `max_cycles` or once `budget_s` seconds
    have passed. Returns a GMRESResult with per-cycle relative residuals
    in residual_norms."""
    dev = resolve_device(device)
    op = op.to(dev)
    k_sq = _on(k_sq, dev, torch.float32)
    src = torch.view_as_real(_rhs(source, dev, batched=False))

    def neg_residual(u):
        if isinstance(op, StencilPML):
            r = helmholtz_residual_stencil_auto(op, u[None], k_sq[None], src[None])[0]
        else:
            r = helmholtz_residual(op, u[None], k_sq[None], src[None], mode=mode)[0]
        return -r, float(torch.linalg.vector_norm(r.reshape(-1)))

    src_norm = float(torch.linalg.vector_norm(src.reshape(-1)))
    t0 = time.time()
    if x0 is None:
        u = torch.zeros(src.shape, dtype=torch.float32, device=dev)
    else:
        u = _on(x0, dev, torch.float32)
        if u.shape != src.shape:
            raise ValueError(
                f"x0 shape {tuple(u.shape)} != source pair shape {tuple(src.shape)}")
    hist, cycles_run = [], 0
    for _ in range(max_cycles):
        b_eff, rnorm = neg_residual(u)
        hist.append(rnorm / max(src_norm, 1e-30))
        if verbose:
            print(f"  cslp-chunked[{cycles_run * restart}]: "
                  f"rel {hist[-1]:.3e}", flush=True)
        if hist[-1] < tol or time.time() - t0 > budget_s:
            break
        step = solve_helmholtz(op, k_sq, b_eff, mode=mode, restart=restart,
                               max_restarts=1, tol=1e-12, precond=precond,
                               shift=shift, device=dev)
        u = u + step.x
        cycles_run += 1
        del step
    else:
        _, rnorm = neg_residual(u)
        hist.append(rnorm / max(src_norm, 1e-30))
    return GMRESResult(
        x=u,
        residual_norms=torch.tensor(hist),
        checkpoints=u[None],
        iterations=torch.tensor(cycles_run * restart),
    )


def gmres_restarted_early_exit(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 20,
    max_restarts: int = 50,
    tol: float = 1e-10,
):
    """Restarted GMRES that STOPS once converged: no cycles after
    convergence (one host synchronisation per cycle decides). Returns
    (x, final residual norm, iterations)."""
    shape = b.shape
    flat = b.reshape(1, -1)
    x = torch.zeros_like(flat) if x0 is None else x0.reshape(1, -1)
    mv = lambda v: matvec(v.reshape(shape)).reshape(1, -1)
    bnorm = max(float(_norm(flat)[0]), 1e-30)
    rn = _norm(flat - mv(x))
    cycles = 0
    while float(rn[0]) > tol * bnorm and cycles < max_restarts:
        x = _arnoldi_cycle(mv, flat, x, restart)
        rn = _norm(flat - mv(x))
        cycles += 1
    return x.reshape(shape), rn[0], cycles * restart

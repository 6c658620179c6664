"""Hybrid solver: learned warm start + GMRES polish, port of
`helmnet_tpu/solvers/hybrid.py`.

The learned iteration converges in tens of steps on in-distribution
problems but can oscillate far out of distribution. The robust path: run
N learned iterations tracking the minimum-residual iterate, then hand that
iterate to restarted GMRES as the initial guess; the polish comes with
the classical convergence guarantee the learned solver lacks.

The learned rollout runs once for the whole batch (on the card, K1 in
'pallas' mode). The JAX package vmaps a `while_loop` over the samples,
which freezes each converged sample; here a Python loop polishes one
sample at a time with `gmres_restarted_early_exit`, which gives the same
numbers per sample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..ops.spectral import SpectralPML
from .gmres import _on, gmres_restarted_early_exit, make_helmholtz_matvec
from .iterative import rollout
from .precond import make_shifted_laplace_inverse


class HybridResult(NamedTuple):
    wavefield: torch.Tensor  # [B, H, W, 2] polished solution
    warm_rmse: torch.Tensor  # [B] best learned residual RMSE (warm start)
    final_relres: torch.Tensor  # [B] GMRES relative residual after polish
    gmres_iterations: torch.Tensor  # [B]


def solve_hybrid(
    params,
    op: SpectralPML,
    source,
    sos_maps,
    *,
    cfg: Config,
    learned_iterations: int = 100,
    restart: int = 50,
    max_restarts: int = 10,
    tol: float = 1e-6,
    precond: str = "none",
    shift: tuple = (1.0, 0.5),
    device=None,
) -> HybridResult:
    """Learned warm start + per-sample GMRES polish.

    precond='shifted_laplace' right-preconditions the polish with the CSLP
    operator. The warm start enters as defect correction: solve
    A M^-1 y = b - A x0 from y0 = 0 with tol rescaled by
    ||b|| / ||b - A x0||, then x = x0 + M^-1 y (mapping x0 through M
    instead would amplify its high-frequency error by the Laplacian symbol
    and poison the Krylov space). Reported residuals are TRUE relative
    residuals of the original system (A x - b == A M^-1 y - b_eff)."""
    dev = resolve_device(device)
    op = op.to(dev)
    source = _on(source, dev, torch.float32)
    sos_maps = _on(sos_maps, dev, torch.float32)
    out = rollout(params, op, source, sos_maps, cfg=cfg,
                  num_iterations=learned_iterations, collect=("rmse", "best"),
                  device=dev)
    warm = out["best_wavefield"]  # [B, H, W, 2]
    k_sq = (cfg.source.omega / sos_maps) ** 2

    fields, rels, iters = [], [], []
    for w, ks, src in zip(warm, k_sq, source):
        mv = make_helmholtz_matvec(op, ks, cfg.operator_mode)
        b = torch.complex(src[..., 0], src[..., 1])
        x0 = torch.complex(w[..., 0], w[..., 1])
        bnorm = torch.clamp_min(torch.linalg.vector_norm(b), 1e-30)
        if precond == "shifted_laplace":
            minv = make_shifted_laplace_inverse(op, ks, shift)
            b_eff = b - mv(x0)
            tol_eff = float(tol * bnorm / torch.clamp_min(
                torch.linalg.vector_norm(b_eff), 1e-30))
            y, rn, it = gmres_restarted_early_exit(
                lambda v: mv(minv(v)), b_eff, torch.zeros_like(b_eff),
                restart=restart, max_restarts=max_restarts, tol=tol_eff)
            x = x0 + minv(y)
        else:
            x, rn, it = gmres_restarted_early_exit(
                mv, b, x0, restart=restart, max_restarts=max_restarts, tol=tol)
        fields.append(torch.view_as_real(x))
        rels.append(rn / bnorm)
        iters.append(it)
    return HybridResult(
        wavefield=torch.stack(fields),
        warm_rmse=out["best_rmse"],
        final_relres=torch.stack(rels),
        gmres_iterations=torch.tensor(iters),
    )

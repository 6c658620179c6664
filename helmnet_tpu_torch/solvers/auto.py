"""solve_auto: one entry point that executes the solver policy, port of
`helmnet_tpu/solvers/auto.py` (2D branches).

| regime                                   | method                 | evidence (result files of the JAX package) |
|------------------------------------------|------------------------|--------------------------------------------|
| <= 512^2 with a checkpoint               | learned rollout        | results/gmres_sweep_96.json; adjudication_512_tpu_r2c (the 96^2 tpu_r2c weights at 512^2) |
| <= 512^2, no checkpoint                  | CSLP-GMRES             | results/gmres_sweep_96.json |
| >= 512^2, contrast > 1.45                | two-level FGMRES       | skull_auto_512; fgmres_1024_twolevel_r3_fft |
| 1024^2 and up, mild contrast             | CSLP-GMRES             | adjudication_1024; twolevel_2048_highk.cslp_comparison |
| >= 4096^2                                | two-level + recycling  | helm_4096_recycled; helm_8192_recycled |
| 3D                                       | CSLP / two-level 3D    | not ported: NotImplementedError |

`choose_solver` is pure (inspect the plan without solving) and returns
the JAX package's `method` and `kwargs` for every problem; `solve_auto`
executes the plan with the port's solvers. The thresholds
(`CONTRAST_TWO_LEVEL`, `LEARNED_MAX_GRID`, `RECYCLE_MIN_GRID`) are the
JAX package's constants, copied as they are. They were set from runs of
the JAX package on a TPU and are not verified on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device
from .gmres import _on

# two-level beats CSLP only when the medium is heterogeneous enough to
# stall the constant-coefficient shift; ellipse-dataset media reach about
# 1.36, the far-out-of-distribution and skull regimes 1.5 and above
CONTRAST_TWO_LEVEL = 1.45
# the largest grid where the learned rollout is the plan (with the 96^2
# tpu_r2c weights resized); above it classical solvers certify the
# tolerance
LEARNED_MAX_GRID = 512
# the grid from which recycled two-level FGMRES is the plan
RECYCLE_MIN_GRID = 4096

NOT_PORTED_3D = ("3D solves (cslp3d, two_level3d) are not ported to the PyTorch "
                 "package yet (ROADMAP Queue A item 7)")


@dataclass
class SolverPlan:
    method: str  # 'learned' | 'cslp' | 'two_level' | 'two_level_recycled' | 'cslp3d' | 'two_level3d'
    rationale: str
    kwargs: dict = field(default_factory=dict)
    evidence: str = ""


def _sos_range(sos_map) -> tuple[float, float]:
    """(min, max) of the sos map as host floats; for a tensor the two
    reductions run where it lives and only two scalars are read."""
    if isinstance(sos_map, torch.Tensor):
        s = sos_map.to(torch.float32)
        return float(s.min()), float(s.max())
    s = np.asarray(sos_map)
    return float(s.min()), float(s.max())


def choose_solver(sos_map, *, cfg, params=None, tol: float = 1e-4) -> SolverPlan:
    """Pure policy: the plan for this problem's grid size, wavelengths
    across, heterogeneity contrast and checkpoint availability."""
    shape = tuple(np.shape(sos_map))
    is_3d = len(shape) == 3
    n = max(shape)
    sos_min, sos_max = _sos_range(sos_map)
    contrast = sos_max / max(sos_min, 1e-6)
    omega = cfg.source.omega
    wavelengths = n / (2 * np.pi * sos_min / omega)

    if is_3d:
        if contrast > 2.5:
            return SolverPlan(
                method="two_level3d",
                rationale=f"3D, contrast {contrast:.2f} > 2.5: beyond the "
                          "contrast where CSLP-GMRES converged; the coarse "
                          "correction carries the medium",
                evidence="helm3d_twolevel_256",
                kwargs=dict(smoother="cslp", restart=8, tol=tol,
                            host_arnoldi=True),
            )
        return SolverPlan(
            method="cslp3d",
            rationale=f"3D, contrast {contrast:.2f} <= 2.5: CSLP-GMRES "
                      "converges at every contrast measured in 3D",
            evidence="helm3d_cslp_gmres_256cubed, helm3d_twolevel_256",
            kwargs=dict(restart=15, tol=tol),
        )

    if n >= RECYCLE_MIN_GRID:
        return SolverPlan(
            method="two_level_recycled",
            rationale=f"{n}^2 (~{wavelengths:.0f} wavelengths): recycled "
                      "two-level FGMRES; host-chunked CSLP plateaus from "
                      "restart memory at the largest grids",
            evidence="helm_4096_recycled vs gmres_4096_highk; "
                     "helm_8192_capability (plateau) vs "
                     "helm_8192_recycled (converged)",
            # the configuration of helm_8192_recycled: restart 3 / k 1 /
            # coarse 8x1
            kwargs=dict(smoother="cslp", restart=3, recycle_k=1,
                        coarse_restart=8, coarse_max_restarts=1,
                        transfer="spectral", tol=tol, host_arnoldi=True,
                        keep_x_complex=True),
        )

    if contrast > CONTRAST_TWO_LEVEL and n >= 512:
        # strong heterogeneity from 512^2 up: CSLP stalls and the learned
        # rollout is not adjudicated off-distribution; the two-level
        # coarse correction is the converging class
        smoother = "learned" if params is not None else "cslp"
        return SolverPlan(
            method="two_level",
            rationale=f"{n}^2, contrast {contrast:.2f} > "
                      f"{CONTRAST_TWO_LEVEL}: CSLP stalls on strongly "
                      "heterogeneous media at this size; two-level FGMRES "
                      f"({smoother} smoother, spectral transfer) converges",
            evidence="fgmres_1024_twolevel_r3_fft vs "
                     "fgmres_1024.cslp_comparison; skull_auto_512",
            kwargs=dict(smoother=smoother, restart=8, tol=tol,
                        transfer="spectral", coarse_restart=32,
                        coarse_max_restarts=2, host_arnoldi=True),
        )

    if n <= LEARNED_MAX_GRID and params is not None:
        return SolverPlan(
            method="learned",
            rationale=f"{n}^2 within the trained envelope with a "
                      "checkpoint: the learned rollout (the 96^2 tpu_r2c "
                      "weights, resized, up to 512^2)",
            evidence="results/gmres_sweep_96.json; "
                     "results/adjudication_512_tpu_r2c.json vs "
                     "adjudication_512.json",
            kwargs=dict(num_iterations=1000),
        )

    if n <= LEARNED_MAX_GRID:
        return SolverPlan(
            method="cslp",
            rationale=f"{n}^2, no checkpoint: CSLP-GMRES converges on most "
                      "of the test distribution where bare GMRES stalls",
            evidence="results/gmres_sweep_96.json",
            kwargs=dict(restart=20, max_restarts=50, tol=tol),
        )

    return SolverPlan(
        method="cslp",
        rationale=f"{n}^2, contrast {contrast:.2f} <= "
                  f"{CONTRAST_TWO_LEVEL}: host-chunked CSLP-GMRES converges "
                  "on mild-contrast high-k problems",
        evidence="twolevel_2048_highk.cslp_comparison, plateau_2048",
        kwargs=dict(restart=25, max_cycles=160, tol=tol),
    )


def solve_auto(
    source,
    sos_map,
    *,
    cfg,
    params=None,
    op=None,
    tol: float = 1e-4,
    verbose: bool = False,
    device=None,
    **overrides,
):
    """Solve (L + k^2) u = s with the plan's solver, on the card unless
    `device` says otherwise. Returns (result, plan): the chosen solver
    family's own result, and the plan. Keyword overrides are merged into
    the plan's kwargs. source: [H, W, 2]; sos_map: [H, W]. 3D raises
    NotImplementedError."""
    plan = choose_solver(sos_map, cfg=cfg, params=params, tol=tol)
    kw = dict(plan.kwargs)
    kw.update(overrides)
    if verbose:
        print(f"solve_auto -> {plan.method}: {plan.rationale}", flush=True)
    shape = tuple(np.shape(sos_map))
    if len(shape) == 3:
        raise NotImplementedError(NOT_PORTED_3D)
    n = max(shape)
    dev = resolve_device(device)
    sos = _on(sos_map, dev, torch.float32)
    src = _on(source, dev, torch.float32)
    if op is None:
        from ..ops.spectral import make_operator, resolve_mode

        g = cfg.geometry
        h, w = shape
        op = make_operator(h, w, g.pml_size, g.sigma_max, cfg.k0,
                           dense=resolve_mode(cfg.operator_mode, h, w) != "fft",
                           device=dev)
    op = op.to(dev)

    if plan.method == "learned":
        from .iterative import IterativeSolver

        solver = IterativeSolver(cfg, params=params, device=dev)
        solver.op = op
        solver.set_source_maps(src[None])
        out = solver.forward(
            sos[None], num_iterations=kw.pop("num_iterations", 1000),
            collect=("rmse", "best"), chunk_iterations=250, **kw,
        )
        return out, plan

    k_sq = (cfg.source.omega / sos) ** 2
    if plan.method == "cslp":
        # every override reaches the solver; mode and precond are popped so
        # an override cannot collide with the explicit keywords
        mode = kw.pop("mode", cfg.operator_mode)
        precond = kw.pop("precond", "shifted_laplace")
        if n <= LEARNED_MAX_GRID:
            from .gmres import solve_helmholtz

            kw.setdefault("restart", 20)
            kw.setdefault("max_restarts", 50)
            kw.setdefault("tol", tol)
            res = solve_helmholtz(op, k_sq, src, mode=mode, precond=precond,
                                  device=dev, **kw)
        else:
            from .gmres import solve_helmholtz_chunked

            res = solve_helmholtz_chunked(op, k_sq, src, mode=mode,
                                          precond=precond, verbose=verbose,
                                          device=dev, **kw)
        return res, plan

    # two_level / two_level_recycled
    from .twolevel import solve_fgmres_two_level

    if plan.method == "two_level_recycled":
        kw.setdefault("recycle_k", 2)
    if kw.get("smoother") == "learned":
        kw["params"] = params
    # keep_x_complex is the plan's own choice for the cycle loop; the
    # result keeps the [H, W, 2] wavefield unless the caller asked for it
    internal_complex = kw.get("keep_x_complex", False) \
        and "keep_x_complex" not in overrides
    res = solve_fgmres_two_level(op, src, sos, cfg=cfg, device=dev, **kw)
    if internal_complex and res.wavefield.is_complex():
        res = res._replace(wavefield=torch.view_as_real(res.wavefield.reshape(shape)))
    return res, plan

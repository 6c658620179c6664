"""Parity/evaluation harness: error metrics and cross-solver comparisons,
port of `helmnet_tpu/eval/harness.py`.

Reproduces the reference's analysis conventions (support_functions.py):
fields are normalized at the source pixel, references are conjugated (k-Wave
phase convention), errors are l_inf / RMSE over the PML-cropped interior.
The metrics are numpy on the host, as in the JAX package. `compare_solvers`
(the fig_generic flow, support_functions.py:375-513: learned solver vs
GMRES on the same problem) runs both solves on the solver's device and
takes their results to numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _host(t) -> np.ndarray:
    """A tensor on any device as a host numpy array."""
    return t.detach().cpu().numpy()


def to_complex(field: np.ndarray) -> np.ndarray:
    """[..., H, W, 2] channel pair -> complex; complex passes through."""
    field = np.asarray(field)
    if np.iscomplexobj(field):
        return field
    return field[..., 0] + 1j * field[..., 1]


def normalize_wavefield(wavefield: np.ndarray, source_location) -> np.ndarray:
    """Divide by the (complex) value at the source pixel
    (support_functions.py:125-131)."""
    w = to_complex(wavefield)
    r, c = source_location
    if w.ndim == 2:
        return w / w[r, c]
    return w / w[..., r, c][..., None, None]


def field_difference(
    sample: np.ndarray,
    reference: np.ndarray,
    source_location=(82, 48),
    pml_size: int = 10,
    conjugate_reference: bool = False,
    mask: Optional[np.ndarray] = None,
):
    """Source-normalized difference map over the PML-cropped interior
    (difference_to_kwave, support_functions.py:23-48).

    Returns (|difference| cropped, normalized sample, normalized reference).
    `conjugate_reference=True` applies the k-Wave phase-convention flip.
    """
    s = normalize_wavefield(sample, source_location)
    s = np.where(np.isnan(s), 0.0, s)
    r = normalize_wavefield(reference, source_location)
    if conjugate_reference:
        r = np.conj(r)
    if mask is not None:
        s = s * mask
        r = r * mask
        max_vals = np.abs(r).reshape(r.shape[0], -1).max(1)[:, None, None] \
            if r.ndim == 3 else np.abs(r).max()
    else:
        max_vals = 1.0
    crop = np.s_[..., pml_size:-pml_size, pml_size:-pml_size]
    return np.abs(s - r)[crop] / max_vals, s, r


def linf_and_rmse(difference: np.ndarray):
    """l_inf and RMSE of a difference map (last_frame_difference,
    support_functions.py:10-20). difference: [..., H', W']."""
    flat = difference.reshape(difference.shape[:-2] + (-1,))
    return flat.max(-1), np.sqrt((flat**2).mean(-1))


def error_traces(
    wavefields: np.ndarray,
    reference: np.ndarray,
    source_location=(82, 48),
    pml_size: int = 10,
    conjugate_reference: bool = False,
):
    """Per-iteration l_inf/RMSE traces against a fixed reference field
    (get_model_errors / get_gmres_errors semantics).

    wavefields: [iters, H, W, 2] (or complex [iters, H, W]).
    Returns (linf[iters], rmse[iters]).
    """
    diff, _, _ = field_difference(
        wavefields,
        np.broadcast_to(
            to_complex(reference)[None], (wavefields.shape[0],) + to_complex(reference).shape
        ),
        source_location,
        pml_size,
        conjugate_reference,
    )
    return linf_and_rmse(diff)


@dataclass
class SolverComparison:
    model_wavefield: np.ndarray  # complex [H, W], normalized
    gmres_wavefield: np.ndarray  # complex [H, W], normalized
    model_linf_trace: np.ndarray  # vs GMRES final, per collected iteration
    model_rmse_trace: np.ndarray
    model_residual_rmse: np.ndarray  # physics residual per iteration
    gmres_residual_norms: np.ndarray  # per restart cycle
    linf: float  # final model-vs-GMRES l_inf
    rmse: float
    # GMRES per-restart-checkpoint l_inf/RMSE vs its own converged solution
    # (the convergence-trace analog of the reference's get_gmres_errors)
    gmres_linf_trace: Optional[np.ndarray] = None
    gmres_rmse_trace: Optional[np.ndarray] = None
    # model physics residual sampled at the same iterations as the l_inf
    # trace (for the error-vs-residual figure)
    model_residual_at_trace: Optional[np.ndarray] = None


def compare_solvers(
    solver,
    sos_map: np.ndarray,
    num_iterations: int = 1000,
    decimate: int = 10,
    gmres_restart: int = 100,
    gmres_max_restarts: int = 10,
    gmres_tol: float = 1e-7,
    pml_crop: int = 10,
    gmres_precond: str = "shifted_laplace",
) -> SolverComparison:
    """The fig_generic parity flow on one problem: learned rollout vs our
    first-class GMRES on the identical discrete operator.

    GMRES runs CSLP-preconditioned by default: the f32 unpreconditioned
    solve can stall short of convergence on high-contrast maps (measured
    2% field error vs f64 truth at 1000 iterations, vs 1e-5 preconditioned)
    which would corrupt the comparison baseline — the reference's MATLAB
    GMRES is f64/tol-1e-10 and effectively exact. Both solves run on
    `solver.device`."""
    from ..solvers import gmres as gmres_mod

    sos = np.asarray(sos_map, np.float32)
    out = solver.forward(
        sos[None], num_iterations=num_iterations,
        collect=("rmse", "wavefields"), decimate=decimate,
    )
    wfs = _host(out["wavefields"])[:, 0]  # [iters/dec, H, W, 2]
    res_rmse = _host(out["rmse"])[:, 0]

    k_sq = (solver.cfg.source.omega / sos) ** 2
    g = gmres_mod.solve_helmholtz(
        solver.op, k_sq, solver.source[0],
        restart=gmres_restart, max_restarts=gmres_max_restarts, tol=gmres_tol,
        precond=gmres_precond, device=solver.device,
    )
    loc = tuple(solver.cfg.source.location)
    u_g = normalize_wavefield(_host(g.x), loc)
    linf_trace, rmse_trace = error_traces(wfs, u_g, loc, pml_crop)
    g_linf, g_rmse = error_traces(_host(g.checkpoints), u_g, loc, pml_crop)
    u_m = normalize_wavefield(wfs[-1], loc)
    return SolverComparison(
        model_wavefield=u_m,
        gmres_wavefield=u_g,
        model_linf_trace=linf_trace,
        model_rmse_trace=rmse_trace,
        model_residual_rmse=res_rmse,
        gmres_residual_norms=_host(g.residual_norms),
        linf=float(linf_trace[-1]),
        rmse=float(rmse_trace[-1]),
        gmres_linf_trace=g_linf,
        gmres_rmse_trace=g_rmse,
        model_residual_at_trace=res_rmse[decimate - 1 :: decimate],
    )

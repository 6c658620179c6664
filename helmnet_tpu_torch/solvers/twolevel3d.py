"""Two-level (coarse-grid corrected) flexible GMRES in 3D, port of
`helmnet_tpu/solvers/twolevel3d.py`.

The 3D analog of solvers/twolevel.py: a CSLP or learned smoother plus a
factor-2 rediscretised spectral coarse-grid correction, solved
approximately by fixed CSLP-GMRES cycles, under a flexible outer Krylov
iteration (solvers/fgmres.run_fgmres_loop, device or host Arnoldi, with
recycling, a time budget and a per-cycle callback). One multiplicative
cycle per apply:

    z1 = S(v);  r = v - A z1;  z = z1 + P A_c^{-approx} R r.

Transfers are 3D Fourier truncation and zero padding, exact for every
mode the coarse grid resolves. The coarse k^2 is `jax.image.resize(k_sq,
..., method="linear")`, antialiased when downsampling, built here from
the same per-axis weight matrices as in 2D (`twolevel._linear_weights`).
A factor-2 coarse grid needs at least 4 fine points per wavelength.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.spectral3d import SpectralPML3D, make_operator3d
from .fgmres import FGMRESResult, run_fgmres_loop
from .gmres import _on, _rhs, gmres_restarted
from .helm3d import make_helmholtz_matvec3d, make_shifted_laplace_inverse3d
from .twolevel import _linear_weights

_AXES = (-3, -2, -1)


def _freq_indices(n_src: int, n_keep: int) -> np.ndarray:
    """FFT-order indices of the n_keep lowest-|frequency| modes among n_src
    (positive block first, then the negative tail)."""
    return np.concatenate([
        np.arange(0, n_keep - n_keep // 2),
        np.arange(n_src - n_keep // 2, n_src),
    ])


def spectral_resize_complex3d(v: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """Fourier resize of a complex [D, H, W] volume: FFT truncation (down)
    or zero-padding (up). Mixed per-axis up/down raises ValueError."""
    src = tuple(v.shape)
    dst = tuple(shape)
    F = torch.fft.fftn(v, dim=_AXES)
    index = lambda a: torch.as_tensor(a, device=v.device)
    if all(d <= s for d, s in zip(dst, src)):
        Fc = F
        for axis, (s, d) in enumerate(zip(src, dst)):
            Fc = Fc.index_select(axis, index(_freq_indices(s, d)))
    elif all(d >= s for d, s in zip(dst, src)):
        iz, iy, ix = (index(_freq_indices(d, s)) for s, d in zip(src, dst))
        Fc = torch.zeros(dst, dtype=F.dtype, device=F.device)
        Fc[iz[:, None, None], iy[None, :, None], ix[None, None, :]] = F
    else:
        raise ValueError(f"mixed up/down resize {src} -> {dst}")
    scale = float(np.prod(dst)) / float(np.prod(src))
    return torch.fft.ifftn(Fc * scale, dim=_AXES)


def resize_real3d(v: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """jax.image.resize(v, shape, method="linear") of a real [D, H, W]
    volume, one axis at a time."""
    w = [torch.as_tensor(_linear_weights(n, m), device=v.device)
         for n, m in zip(v.shape, shape)]
    return torch.einsum("dhw,da,hb,wc->abc", v, *w)


def make_coarse_level3d(
    k_sq: torch.Tensor,
    *,
    k0: float,
    pml_size: int,
    sigma_max: float,
    factor: int = 2,
) -> tuple[SpectralPML3D, torch.Tensor]:
    """Coarse rediscretised 3D operator and index-space k^2 on k_sq's
    device: coarse spacing factor*dx makes the index-space system
    (L_idx + factor^2 k_sq_c) e = factor^2 R r."""
    df, hf, wf = k_sq.shape
    dc, hc, wc = df // factor, hf // factor, wf // factor
    op_c = make_operator3d(dc, hc, wc, max(pml_size // factor, 4), sigma_max,
                           k0 * factor, device=k_sq.device)
    return op_c, (factor * factor) * resize_real3d(k_sq, (dc, hc, wc))


def make_learned_preconditioner3d(params, op: SpectralPML3D, sos_map, *, cfg,
                                  iterations: int = 20):
    """complex [D, H, W] -> complex [D, H, W] approximate A^-1 v:
    `iterations` learned HybridNet3D steps on A z = v from a zero wavefield
    and fresh hidden states, v scaled so that its peak is the training
    source amplitude (the solve is linear, the network is not); returns the
    best iterate, scaled back."""
    from ..models.hybridnet import params_to
    from .iterative3d import rollout3d

    dev = op.kz.device
    params = params_to(params, dev)  # once, not at every application
    sos = _on(sos_map, dev, torch.float32)[None]

    def apply(v: torch.Tensor) -> torch.Tensor:
        src = torch.view_as_real(v)[None]
        amp = v.abs().max()
        scale = torch.where(amp > 0, cfg.source.amplitude / amp, torch.ones_like(amp))
        out = rollout3d(params, op, src * scale, sos, cfg=cfg,
                        num_iterations=iterations, collect=("rmse", "best"),
                        device=dev)
        return torch.view_as_complex((out["best_wavefield"][0] / scale).contiguous())

    return apply


def make_two_level_preconditioner3d(
    op: SpectralPML3D,
    k_sq: torch.Tensor,
    *,
    k0: float,
    pml_size: int,
    sigma_max: float,
    mode: str = "matmul",
    factor: int = 2,
    shift: Tuple[float, float] = (1.0, 0.5),
    smoother: str = "cslp",
    params=None,
    cfg=None,
    smoother_iterations: int = 20,
    coarse_restart: int = 16,
    coarse_max_restarts: int = 2,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Two-grid preconditioner apply on complex [D, H, W] volumes, on
    k_sq's device. smoother='cslp' uses the FFT shifted-Laplace inverse;
    'learned' `smoother_iterations` fresh-state HybridNet3D steps (needs
    params and cfg); 'none' the coarse correction alone."""
    shape = tuple(k_sq.shape)
    coarse_shape = tuple(s // factor for s in shape)
    mv_f = make_helmholtz_matvec3d(op, k_sq, mode)
    if smoother == "learned":
        if params is None or cfg is None:
            raise ValueError("smoother='learned' requires params and cfg")
        smooth = make_learned_preconditioner3d(
            params, op, torch.sqrt((cfg.source.omega ** 2) / k_sq), cfg=cfg,
            iterations=smoother_iterations)
    elif smoother == "cslp":
        smooth = make_shifted_laplace_inverse3d(op, k_sq, shift)
    elif smoother == "none":
        smooth = None
    else:
        raise ValueError(f"unknown 3D smoother '{smoother}'")

    op_c, k_sq_c_idx = make_coarse_level3d(k_sq, k0=k0, pml_size=pml_size,
                                           sigma_max=sigma_max, factor=factor)
    mv_c = make_helmholtz_matvec3d(op_c, k_sq_c_idx, mode)
    minv_c = make_shifted_laplace_inverse3d(op_c, k_sq_c_idx, shift)

    def coarse_solve(rc: torch.Tensor) -> torch.Tensor:
        res = gmres_restarted(lambda v: mv_c(minv_c(v)), rc, restart=coarse_restart,
                              max_restarts=coarse_max_restarts, tol=1e-8)
        return minv_c(res.x)

    def apply(v: torch.Tensor) -> torch.Tensor:
        v3 = v.reshape(shape)
        if smooth is None:
            z1 = torch.zeros_like(v3)
            r = v3
        else:
            z1 = smooth(v3)
            r = v3 - mv_f(z1)
        rc = spectral_resize_complex3d(r, coarse_shape)
        ec = coarse_solve(float(factor * factor) * rc)
        return (z1 + spectral_resize_complex3d(ec, shape)).reshape(v.shape)

    return apply


def solve_fgmres_two_level3d(
    op: SpectralPML3D,
    source,
    k_sq,
    *,
    k0: float,
    pml_size: int,
    sigma_max: float,
    mode: str = "matmul",
    factor: int = 2,
    smoother: str = "cslp",
    params=None,
    cfg=None,
    smoother_iterations: int = 20,
    shift: Tuple[float, float] = (1.0, 0.5),
    coarse_restart: int = 16,
    coarse_max_restarts: int = 2,
    restart: int = 8,
    max_restarts: int = 10,
    tol: float = 1e-5,
    x0=None,
    host_arnoldi: bool = False,
    recycle_k: int = 0,
    recycle_state=None,
    budget_s=None,
    on_cycle=None,
    keep_x_complex: bool = False,
    verbose: bool = False,
    device=None,
) -> FGMRESResult:
    """Flexible GMRES with the 3D two-level preconditioner.

    source: [D, H, W, 2] channel pair; k_sq: [D, H, W] real. Residual
    norms are TRUE relative residuals; host_arnoldi=True reads H back one
    Krylov step at a time (solvers/fgmres.py). `x0`: a [D, H, W, 2] pair
    or a flat complex vector. Runs on the card unless `device` says
    otherwise."""
    dev = resolve_device(device)
    op = op.to(dev)
    k_sq = _on(k_sq, dev, torch.float32)
    b = _rhs(source, dev, batched=False, dims=3)
    shape = tuple(b.shape)
    mv_field = make_helmholtz_matvec3d(op, k_sq, mode)
    mv = lambda v: mv_field(v.reshape(shape)).reshape(-1)
    precond_field = make_two_level_preconditioner3d(
        op, k_sq, k0=k0, pml_size=pml_size, sigma_max=sigma_max, mode=mode,
        factor=factor, shift=shift, smoother=smoother, params=params, cfg=cfg,
        smoother_iterations=smoother_iterations, coarse_restart=coarse_restart,
        coarse_max_restarts=coarse_max_restarts)
    precond = lambda v: precond_field(v.reshape(shape)).reshape(-1)
    if x0 is not None and not (isinstance(x0, torch.Tensor) and x0.is_complex()):
        x0 = _rhs(x0, dev, batched=False, dims=3)  # a [D, H, W, 2] pair
    return run_fgmres_loop(
        mv, precond, b.reshape(-1), shape, restart=restart,
        max_restarts=max_restarts, tol=tol, x0=x0, host_arnoldi=host_arnoldi,
        recycle_k=recycle_k, recycle_state=recycle_state, budget_s=budget_s,
        on_cycle=on_cycle, keep_x_complex=keep_x_complex, verbose=verbose,
        label="fgmres3d")

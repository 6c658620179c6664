"""Two-level and multilevel (multilevel-Krylov) preconditioning for
high-wavenumber heterogeneous Helmholtz, port of
`helmnet_tpu/solvers/twolevel.py`.

At high wavenumber with strong sound-speed contrast both the
constant-coefficient CSLP and the learned preconditioner plateau: CSLP
ignores the medium, and a short learned rollout propagates information a
bounded distance. What both miss is the globally coupled smooth error,
and the cure is a coarse-grid correction (Erlangga & Nabben's multilevel
Krylov method). One multiplicative two-grid cycle per apply:

    z1 = S(v);  r = v - A z1;  z = z1 + P A_c^{-approx} R r.

- The coarse level is a factor-2 rediscretised spectral PML operator; in
  index space the correction solves (L_idx + factor^2 k_sq_c) e =
  factor^2 r_c.
- Transfers: `spectral_resize_complex` (FFT truncation or zero padding,
  exact for every mode the target grid resolves; the default) or
  `resize_complex` (linear). The linear resize reproduces
  `jax.image.resize(method="linear")`, whose defaults are half-pixel
  centres and, when downsampling, a triangle kernel widened by the factor
  (antialias=True). It is built here as two small dense weight matrices
  in numpy, with JAX's formula, and applied as Wy^T v Wx on each of re and
  im, so no PyTorch interpolation mode has to match it.
- The coarse problem is solved approximately by fixed CSLP-GMRES cycles
  (tol 1e-8, no early exit), so the outer iteration must be flexible
  GMRES (solvers/fgmres.py).
- Smoothers: 'cslp' (two FFTs, medium-blind), 'learned' (the network,
  fresh state per apply; on the card K1 runs inside it) or 'none'.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.spectral import SpectralPML, make_operator, resolve_mode
from .gmres import _on, gmres_restarted, make_helmholtz_matvec
from .precond import make_shifted_laplace_inverse


@lru_cache(maxsize=64)
def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of jax.image.resize's 'linear' method
    along one axis (jax._src.image.scale.compute_weight_mat with the
    triangle kernel, scale n_out/n_in, no translation, antialias=True)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_real(v: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(v, shape, method="linear") of a real [H, W] plane."""
    h, w = v.shape
    out = v
    if shape[0] != h:
        wy = torch.as_tensor(_linear_weights(h, shape[0]), device=v.device)
        out = wy.T @ out
    if shape[1] != w:
        wx = torch.as_tensor(_linear_weights(w, shape[1]), device=v.device)
        out = out @ wx
    return out


def resize_complex(v: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of a complex [H, W] field via split re/im planes."""
    return torch.complex(resize_real(v.real.contiguous(), shape),
                         resize_real(v.imag.contiguous(), shape))


def spectral_resize_complex(v: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Fourier resize of a complex [H, W] field: FFT truncation (down) or
    zero-padding (up), exact for every mode the target grid resolves. The
    Nyquist half-corners are taken as the JAX function takes them, for odd
    and even sizes."""
    hf, wf = v.shape
    hc, wc = shape
    F = torch.fft.fft2(v)
    if hc <= hf and wc <= wf:
        h, w = hc, wc
        top = torch.cat([F[: h - h // 2, : w - w // 2], F[: h - h // 2, wf - w // 2:]], dim=1)
        bot = torch.cat([F[hf - h // 2:, : w - w // 2], F[hf - h // 2:, wf - w // 2:]], dim=1)
        Fc = torch.cat([top, bot], dim=0)
    else:
        Fc = torch.zeros((hc, wc), dtype=F.dtype, device=F.device)
        Fc[: hf - hf // 2, : wf - wf // 2] = F[: hf - hf // 2, : wf - wf // 2]
        Fc[: hf - hf // 2, wc - wf // 2:] = F[: hf - hf // 2, wf - wf // 2:]
        Fc[hc - hf // 2:, : wf - wf // 2] = F[hf - hf // 2:, : wf - wf // 2]
        Fc[hc - hf // 2:, wc - wf // 2:] = F[hf - hf // 2:, wf - wf // 2:]
    scale = (hc * wc) / (hf * wf)
    return torch.fft.ifft2(Fc * scale)


def make_coarse_level(
    k_sq: torch.Tensor,
    *,
    k0: float,
    pml_size: int,
    sigma_max: float,
    factor: int = 2,
    mode: str = "matmul",
) -> tuple[SpectralPML, torch.Tensor]:
    """Coarse rediscretised operator and index-space k^2 for a factor
    `factor` coarsening of an [H, W] fine grid, on k_sq's device. Returns
    (op_c, k_sq_c_idx); the coarse index-space system is
    (L_idx + k_sq_c_idx) e = factor^2 R r. The dense per-axis tables are
    built only where `mode` resolves to matmul at the coarse size."""
    hf, wf = k_sq.shape
    hc, wc = hf // factor, wf // factor
    # the PML thickness in gridpoints shrinks with the grid; sigma_max is
    # the dimensionless profile peak
    op_c = make_operator(
        hc, wc, max(pml_size // factor, 4), sigma_max, k0 * factor,
        dense=resolve_mode(mode, hc, wc) != "fft", device=k_sq.device,
    )
    return op_c, (factor * factor) * resize_real(k_sq, (hc, wc))


def _smoother(op, k_sq, shift, smoother, params, cfg, smoother_iterations):
    if smoother == "learned":
        if params is None or cfg is None:
            raise ValueError("smoother='learned' requires params and cfg")
        from .fgmres import make_learned_preconditioner

        # the sound speed the network sees, rebuilt from k^2
        return make_learned_preconditioner(
            params, op, torch.sqrt((cfg.source.omega ** 2) / k_sq), cfg=cfg,
            iterations=smoother_iterations, device=k_sq.device,
        )
    if smoother == "cslp":
        return make_shifted_laplace_inverse(op, k_sq, shift)
    if smoother == "none":
        return None
    raise ValueError(f"unknown smoother '{smoother}'")


def _cslp_coarse_solver(op_c, k_sq_c, mode, shift, coarse_restart,
                        coarse_max_restarts):
    """Approximate (L_idx + k_sq_idx)^-1 rc by right-CSLP GMRES: fixed
    cycles, tol 1e-8, no early exit."""
    mv_c = make_helmholtz_matvec(op_c, k_sq_c, mode)
    minv_c = make_shifted_laplace_inverse(op_c, k_sq_c, shift)

    def solve_c(rc: torch.Tensor) -> torch.Tensor:
        res = gmres_restarted(lambda v: mv_c(minv_c(v)), rc,
                              restart=coarse_restart,
                              max_restarts=coarse_max_restarts, tol=1e-8)
        return minv_c(res.x)

    return solve_c


def _two_grid(hl, wl, hc, wc, factor, mv_l, smooth, resize, solve_c):
    def apply(v: torch.Tensor) -> torch.Tensor:
        v2 = v.reshape(hl, wl)
        if smooth is None:
            z1 = torch.zeros_like(v2)
            r = v2
        else:
            z1 = smooth(v2)
            r = v2 - mv_l(z1)
        ec = solve_c(float(factor * factor) * resize(r, (hc, wc)))
        return (z1 + resize(ec, (hl, wl))).reshape(v.shape)

    return apply


def make_two_level_preconditioner(
    op: SpectralPML,
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
    coarse_restart: int = 32,
    coarse_max_restarts: int = 2,
    transfer: str = "spectral",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Two-grid preconditioner apply: complex [H, W] -> complex [H, W], on
    k_sq's device.

    smoother='cslp' uses the FFT shifted-Laplace inverse; 'learned' uses
    `smoother_iterations` fresh-state network steps (needs params and cfg,
    see solvers/fgmres.make_learned_preconditioner). The coarse residual
    equation is solved by CSLP-GMRES(coarse_restart) x coarse_max_restarts
    on the rediscretised spectral operator. transfer='spectral' (default)
    or 'linear'."""
    hf, wf = k_sq.shape
    hc, wc = hf // factor, wf // factor
    op = op.to(k_sq.device)
    mv_f = make_helmholtz_matvec(op, k_sq, mode)
    smooth = _smoother(op, k_sq, shift, smoother, params, cfg, smoother_iterations)
    op_c, k_sq_c = make_coarse_level(k_sq, k0=k0, pml_size=pml_size,
                                     sigma_max=sigma_max, factor=factor, mode=mode)
    solve_c = _cslp_coarse_solver(op_c, k_sq_c, mode, shift, coarse_restart,
                                  coarse_max_restarts)
    resize = spectral_resize_complex if transfer == "spectral" else resize_complex
    return _two_grid(hf, wf, hc, wc, factor, mv_f, smooth, resize, solve_c)


def make_multilevel_preconditioner(
    op: SpectralPML,
    k_sq: torch.Tensor,
    *,
    k0: float,
    pml_size: int,
    sigma_max: float,
    mode: str = "auto",
    levels: int = 3,
    factor: int = 2,
    shift: Tuple[float, float] = (1.0, 0.5),
    smoother: str = "cslp",
    params=None,
    cfg=None,
    smoother_iterations: int = 20,
    coarse_restart: int = 32,
    coarse_max_restarts: int = 2,
    inner_restart: int = 6,
    inner_cycles: int = 1,
    transfer: str = "spectral",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Recursive multilevel-Krylov preconditioner: each level applies one
    multiplicative two-grid cycle; intermediate-level corrections are
    solved by `inner_cycles` FGMRES(inner_restart) cycles preconditioned by
    the next level's cycle, and the deepest level by CSLP-GMRES as in the
    two-level method.

    The deepest grid must still resolve the wave: fine-grid points per
    wavelength >= 2 * factor^(levels-1), else ValueError (a spectral
    coarse grid below 2 points per wavelength aliases the wavenumber).
    smoother='learned' applies at level 0 only; coarser levels use CSLP."""
    if levels < 2:
        raise ValueError("levels must be >= 2")
    k_max = float(torch.sqrt(torch.max(k_sq)))
    fine_ppw = 2.0 * np.pi / k_max
    deepest_ppw = fine_ppw / (factor ** (levels - 1))
    if deepest_ppw < 2.0:
        max_levels = int(np.floor(np.log(fine_ppw / 2.0) / np.log(float(factor))) + 1)
        raise ValueError(
            f"deepest level underresolves the wave: {deepest_ppw:.2f} "
            f"points/wavelength < 2 at factor^{levels - 1} coarsening "
            f"(fine grid has {fine_ppw:.1f} ppw). Max valid "
            f"levels here: {max(max_levels, 2)}."
        )
    from .fgmres import _fgmres_cycle

    resize = spectral_resize_complex if transfer == "spectral" else resize_complex

    def build(op_l, k_sq_l, k0_l, pml_l, level):
        hl, wl = k_sq_l.shape
        mv_l = make_helmholtz_matvec(op_l, k_sq_l, mode)
        if level == 0 and smoother in ("learned", "none"):
            smooth = _smoother(op_l, k_sq_l, shift, smoother, params, cfg,
                               smoother_iterations)
        else:
            smooth = make_shifted_laplace_inverse(op_l, k_sq_l, shift)
        hc, wc = hl // factor, wl // factor
        op_c, k_sq_c = make_coarse_level(k_sq_l, k0=k0_l, pml_size=pml_l,
                                         sigma_max=sigma_max, factor=factor,
                                         mode=mode)
        if level + 2 >= levels:  # the next level is the deepest: CSLP-GMRES
            solve_c = _cslp_coarse_solver(op_c, k_sq_c, mode, shift,
                                          coarse_restart, coarse_max_restarts)
        else:  # intermediate level: a few flexible Krylov steps, recurse
            sub = build(op_c, k_sq_c, k0_l * factor, max(pml_l // factor, 4),
                        level + 1)
            mv_c = make_helmholtz_matvec(op_c, k_sq_c, mode)
            mvc_flat = lambda v: mv_c(v.reshape(hc, wc)).reshape(-1)
            sub_flat = lambda v: sub(v.reshape(hc, wc)).reshape(-1)

            def solve_c(rc: torch.Tensor) -> torch.Tensor:
                rf = rc.reshape(-1)
                x = torch.zeros_like(rf)
                for _ in range(inner_cycles):
                    x = _fgmres_cycle(mvc_flat, sub_flat, rf, x, restart=inner_restart)
                return x.reshape(hc, wc)

        return _two_grid(hl, wl, hc, wc, factor, mv_l, smooth, resize, solve_c)

    return build(op.to(k_sq.device), k_sq, k0, pml_size, 0)


def _k_sq(cfg, sos_map, device):
    dev = resolve_device(device)
    return dev, (cfg.source.omega / _on(sos_map, dev, torch.float32)) ** 2


def solve_fgmres_multilevel(
    op: SpectralPML,
    source,
    sos_map,
    *,
    cfg,
    geometry=None,
    levels: int = 3,
    smoother: str = "cslp",
    params=None,
    factor: int = 2,
    smoother_iterations: int = 20,
    coarse_restart: int = 32,
    coarse_max_restarts: int = 2,
    inner_restart: int = 6,
    inner_cycles: int = 1,
    transfer: str = "spectral",
    restart: int = 10,
    max_restarts: int = 20,
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
):
    """Flexible GMRES with the recursive multilevel preconditioner.
    levels=2 is solve_fgmres_two_level. source: [H, W, 2] channel pair;
    sos_map: [H, W]."""
    from .fgmres import solve_fgmres

    geometry = geometry or cfg.geometry
    dev, k_sq = _k_sq(cfg, sos_map, device)
    precond_field = make_multilevel_preconditioner(
        op, k_sq, k0=cfg.k0, pml_size=geometry.pml_size,
        sigma_max=geometry.sigma_max, mode=cfg.operator_mode,
        levels=levels, factor=factor, shift=(1.0, 0.5), smoother=smoother,
        params=params, cfg=cfg, smoother_iterations=smoother_iterations,
        coarse_restart=coarse_restart, coarse_max_restarts=coarse_max_restarts,
        inner_restart=inner_restart, inner_cycles=inner_cycles,
        transfer=transfer,
    )
    return solve_fgmres(
        op, source, sos_map, cfg=cfg, precond_field=precond_field,
        restart=restart, max_restarts=max_restarts, tol=tol, x0=x0,
        host_arnoldi=host_arnoldi, recycle_k=recycle_k,
        recycle_state=recycle_state, budget_s=budget_s, on_cycle=on_cycle,
        keep_x_complex=keep_x_complex, verbose=verbose, device=dev,
    )


def solve_fgmres_two_level(
    op: SpectralPML,
    source,
    sos_map,
    *,
    cfg,
    geometry=None,
    smoother: str = "cslp",
    params=None,
    factor: int = 2,
    smoother_iterations: int = 20,
    coarse_restart: int = 32,
    coarse_max_restarts: int = 2,
    transfer: str = "spectral",
    restart: int = 10,
    max_restarts: int = 20,
    tol: float = 1e-5,
    x0: Optional[torch.Tensor] = None,
    host_arnoldi: bool = False,
    recycle_k: int = 0,
    recycle_state=None,
    budget_s=None,
    on_cycle=None,
    keep_x_complex: bool = False,
    verbose: bool = False,
    device=None,
):
    """Flexible GMRES with the two-level preconditioner. source: [H, W, 2]
    channel pair; sos_map: [H, W]. One restart cycle per host iteration,
    as solve_fgmres_learned."""
    from .fgmres import solve_fgmres

    geometry = geometry or cfg.geometry
    dev, k_sq = _k_sq(cfg, sos_map, device)
    precond_field = make_two_level_preconditioner(
        op, k_sq, k0=cfg.k0, pml_size=geometry.pml_size,
        sigma_max=geometry.sigma_max, mode=cfg.operator_mode, factor=factor,
        smoother=smoother, params=params, cfg=cfg,
        smoother_iterations=smoother_iterations,
        coarse_restart=coarse_restart, coarse_max_restarts=coarse_max_restarts,
        transfer=transfer,
    )
    return solve_fgmres(
        op, source, sos_map, cfg=cfg, precond_field=precond_field,
        restart=restart, max_restarts=max_restarts, tol=tol, x0=x0,
        host_arnoldi=host_arnoldi, recycle_k=recycle_k,
        recycle_state=recycle_state, budget_s=budget_s, on_cycle=on_cycle,
        keep_x_complex=keep_x_complex, verbose=verbose, device=dev,
    )

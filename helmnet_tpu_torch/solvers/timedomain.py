"""Pseudospectral time-domain CW solver, port of the 2D half of
`helmnet_tpu/solvers/timedomain.py`: the independent ground truth (the
role k-Wave's `kspaceFirstOrder2DG` plays for the reference,
matlab/kwave_solver.m).

Solves the second-order wave equation

    d2p/dt2 = c(x)^2 (Lap p + s(x) cos(w t))

to steady state with a leapfrog + spectral-Laplacian scheme and extracts
the complex phasor P(x) by Fourier projection over the last
`record_periods` periods. Boundaries use an exponential sponge layer, a
different absorbing boundary from the Helmholtz PML, so agreement between
the two is an independent cross-check.

The step counts are computed in float32 on the host exactly as the JAX
package computes them (a float64 ceil can move the count by one and every
phasor with it); the transient and recording loops then run in Python
over those counts, each step `torch.fft.fft2` / `ifft2` in complex64 on
the solver's device. 3D (`solve_cw3d*`) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.spectral import wavenumbers


class TimeDomainResult(NamedTuple):
    phasor: torch.Tensor  # [H, W, 2] channel-pair steady-state complex field
    num_steps: int
    dt: float  # the float32 time step, as a Python float


def _sponge_sigma(h: int, w: int, width: int, strength: float) -> np.ndarray:
    """Absorption rate map sigma(x) [1/time]: strength * quadratic ramp in
    the border band (Cerjan sponge). The per-step damping factor is
    exp(-sigma * dt), so results are dt-invariant."""
    def ramp(n):
        r = np.zeros(n)
        j = np.arange(width)
        edge = ((width - j) / width) ** 2
        r[:width] = edge
        r[-width:] = edge[::-1]
        return r
    ry = ramp(h)[:, None]
    rx = ramp(w)[None, :]
    return (strength * (ry + rx)).astype(np.float32)


def _step_counts(sos: np.ndarray, omega: float, cfl: float, roundtrips: int,
                 record_periods: int):
    """(dt, n_transient, n_record) in float32, as JAX's traced arithmetic:
    dt = cfl dx / c_max, t_end = roundtrips * diagonal / c_min."""
    f32 = np.float32
    h, w = sos.shape
    c_max, c_min = sos.max(), sos.min()
    dt = f32(cfl * 1.0) / c_max
    diag = np.sqrt(f32(h * h + w * w))
    t_end = f32(roundtrips) * diag / c_min
    n_total = int(np.ceil(t_end / dt))
    period = 2.0 * np.pi / omega
    n_record = int(np.ceil(f32(record_periods * period) / dt))
    return f32(dt), max(n_total - n_record, 0), n_record


def solve_cw(
    sos,
    source_amplitude_map,
    *,
    omega: float = 1.0,
    cfl: float = 0.1,
    roundtrips: int = 10,
    record_periods: int = 3,
    sponge_width: int = 16,
    sponge_strength: float = 1.0,
    device=None,
) -> TimeDomainResult:
    """Run the CW simulation on one [H, W] sos map.

    source_amplitude_map: real [H, W] spatial amplitude (the |map| the
    source module builds). cfl/roundtrips follow the reference knobs
    (kwave_solver.m:26-38: dt = cfl*dx/c_max, t_end = roundtrips * diagonal
    / c_min). Runs on the card unless `device` says otherwise.
    """
    dev = resolve_device(device)
    host_sos = (sos.detach().cpu().numpy() if isinstance(sos, torch.Tensor)
                else np.asarray(sos)).astype(np.float32)
    h, w = host_sos.shape
    dt, n_transient, n_record = _step_counts(host_sos, omega, cfl, roundtrips,
                                             record_periods)
    c_max = host_sos.max()

    def on(a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    sos_t = on(host_sos)
    src = on(source_amplitude_map)

    kx = on(wavenumbers(w).astype(np.float32))
    ky = on(wavenumbers(h).astype(np.float32))
    ksq = ky[:, None] ** 2 + kx[None, :] ** 2
    # k-space dispersion correction (k-Wave's kappa): the leapfrog scheme is
    # exact for c == c_ref at any dt with -k^2 sinc^2(c_ref |k| dt / 2);
    # torch.sinc is the normalised sinc, as jnp.sinc
    kappa = torch.sinc(float(c_max) * torch.sqrt(ksq) * float(dt)
                       / (2.0 * np.pi))
    neg_ksq = -(ksq * kappa**2)
    damp = torch.exp(-on(_sponge_sigma(h, w, sponge_width, sponge_strength))
                     * float(dt))
    c2 = sos_t**2
    dt2 = float(dt * dt)  # the float32 product, as JAX forms it

    # the drive at every step, t = n dt in float32
    t = torch.arange(n_transient + n_record, dtype=torch.float32,
                     device=dev) * float(dt)
    cos_t, sin_t = torch.cos(omega * t), torch.sin(omega * t)

    def step(p, p_prev, n):
        # leapfrog + Cerjan sponge: damp both time levels after the update
        lap = torch.fft.ifft2(neg_ksq * torch.fft.fft2(p)).real
        accel = c2 * (lap + src * cos_t[n])
        p_next = damp * (2.0 * p - p_prev + dt2 * accel)
        return p_next, damp * p

    p = torch.zeros((h, w), dtype=torch.float32, device=dev)
    p_prev = torch.zeros_like(p)
    for n in range(n_transient):
        p, p_prev = step(p, p_prev, n)

    # recording phase: accumulate projections onto cos/sin
    acc_c = torch.zeros_like(p)
    acc_s = torch.zeros_like(p)
    for n in range(n_transient, n_transient + n_record):
        p, p_prev = step(p, p_prev, n)
        acc_c = acc_c + p * cos_t[n]
        acc_s = acc_s + p * sin_t[n]
    # p(t) = Re{P e^{-i w t}} = Pr cos + Pi sin  ->  projections give P/2 * n
    scale = 2.0 / max(float(n_record), 1.0)
    phasor = torch.stack([acc_c * scale, acc_s * scale], dim=-1)
    return TimeDomainResult(phasor=phasor, num_steps=n_transient + n_record,
                            dt=float(dt))

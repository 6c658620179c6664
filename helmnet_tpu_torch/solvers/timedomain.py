"""Pseudospectral time-domain CW solver, port of
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
the solver's device. The 3D solver (`solve_cw3d`) does the same with
`fftn` and a 3D sponge; `solve_cw3d_chunked` runs the same step function
over the same step sequence in chunks of `chunk_steps`, with a
synchronised progress line after each when `verbose`, so the two give the
same bits.
"""

from __future__ import annotations

import time
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
    dt = cfl dx / c_max, t_end = roundtrips * diagonal / c_min, for a 2D
    or 3D map."""
    f32 = np.float32
    c_max, c_min = sos.max(), sos.min()
    dt = f32(cfl * 1.0) / c_max
    diag = np.sqrt(f32(sum(n * n for n in sos.shape)))
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


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------


def _sponge_sigma3d(d: int, h: int, w: int, width: int,
                    strength: float) -> np.ndarray:
    """3D Cerjan sponge rate map (quadratic border ramp per axis)."""
    def ramp(n):
        r = np.zeros(n)
        j = np.arange(width)
        edge = ((width - j) / width) ** 2
        r[:width] = edge
        r[-width:] = edge[::-1]
        return r
    rz = ramp(d)[:, None, None]
    ry = ramp(h)[None, :, None]
    rx = ramp(w)[None, None, :]
    return (strength * (rz + ry + rx)).astype(np.float32)


def _cw3d_setup(sos, source_amplitude_map, omega, cfl, roundtrips, record_periods,
                sponge_width, sponge_strength, device):
    """Step counts and the step's constant tensors on the device."""
    dev = resolve_device(device)
    host_sos = (sos.detach().cpu().numpy() if isinstance(sos, torch.Tensor)
                else np.asarray(sos)).astype(np.float32)
    d, h, w = host_sos.shape
    dt, n_transient, n_record = _step_counts(host_sos, omega, cfl, roundtrips,
                                             record_periods)
    on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    kz, ky, kx = (on(wavenumbers(n).astype(np.float32)) for n in (d, h, w))
    ksq = kz[:, None, None] ** 2 + ky[None, :, None] ** 2 + kx[None, None, :] ** 2
    kappa = torch.sinc(float(host_sos.max()) * torch.sqrt(ksq) * float(dt)
                       / (2.0 * np.pi))
    damp = torch.exp(-on(_sponge_sigma3d(d, h, w, sponge_width, sponge_strength))
                     * float(dt))
    t = torch.arange(n_transient + n_record, dtype=torch.float32, device=dev) * float(dt)
    consts = {
        "neg_ksq": -(ksq * kappa**2), "damp": damp, "c2": on(host_sos) ** 2,
        "src": on(source_amplitude_map), "dt2": float(dt * dt),
        "cos_t": torch.cos(omega * t), "sin_t": torch.sin(omega * t),
    }
    zeros = torch.zeros((d, h, w), dtype=torch.float32, device=dev)
    return dt, n_transient, n_record, consts, zeros


def _cw3d_chunk(p, p_prev, acc_c, acc_s, n0: int, count: int, record: bool, k: dict):
    """`count` leapfrog steps from step index n0 (the step of `solve_cw`
    with `fftn`); with `record` the projections onto cos/sin accumulate."""
    for n in range(n0, n0 + count):
        lap = torch.fft.ifftn(k["neg_ksq"] * torch.fft.fftn(p)).real
        accel = k["c2"] * (lap + k["src"] * k["cos_t"][n])
        p, p_prev = k["damp"] * (2.0 * p - p_prev + k["dt2"] * accel), k["damp"] * p
        if record:
            acc_c = acc_c + p * k["cos_t"][n]
            acc_s = acc_s + p * k["sin_t"][n]
    return p, p_prev, acc_c, acc_s


def _cw3d_phasor(acc_c, acc_s, n_record: int) -> torch.Tensor:
    # p(t) = Re{P e^{-i w t}} = Pr cos + Pi sin  ->  projections give P/2 * n
    scale = 2.0 / max(float(n_record), 1.0)
    return torch.stack([acc_c * scale, acc_s * scale], dim=-1)


def solve_cw3d(
    sos,
    source_amplitude_map,
    *,
    omega: float = 1.0,
    cfl: float = 0.1,
    roundtrips: int = 10,
    record_periods: int = 3,
    sponge_width: int = 12,
    sponge_strength: float = 1.0,
    device=None,
) -> TimeDomainResult:
    """3D CW pseudospectral time-domain solve on one [D, H, W] sos map: the
    scheme of `solve_cw` with `fftn` and a 3D sponge, the independent
    ground truth for the 3D Helmholtz solvers. Runs on the card unless
    `device` says otherwise."""
    dt, n_transient, n_record, k, zeros = _cw3d_setup(
        sos, source_amplitude_map, omega, cfl, roundtrips, record_periods,
        sponge_width, sponge_strength, device)
    p, p_prev, _, _ = _cw3d_chunk(zeros, zeros, zeros, zeros, 0, n_transient, False, k)
    _, _, acc_c, acc_s = _cw3d_chunk(p, p_prev, zeros, zeros, n_transient, n_record,
                                     True, k)
    return TimeDomainResult(phasor=_cw3d_phasor(acc_c, acc_s, n_record),
                            num_steps=n_transient + n_record, dt=float(dt))


def solve_cw3d_chunked(
    sos,
    source_amplitude_map,
    *,
    omega: float = 1.0,
    cfl: float = 0.1,
    roundtrips: int = 10,
    record_periods: int = 3,
    sponge_width: int = 12,
    sponge_strength: float = 1.0,
    chunk_steps: int = 2000,
    verbose: bool = False,
    device=None,
) -> TimeDomainResult:
    """`solve_cw3d` in chunks of `chunk_steps` leapfrog steps: the same
    step sequence, so the same phasor. With `verbose` each chunk ends with
    a synchronising read of one value and a progress line (the JAX
    package's form, whose host-driven dispatches bound each dispatch's
    duration)."""
    dt, n_transient, n_record, k, zeros = _cw3d_setup(
        sos, source_amplitude_map, omega, cfl, roundtrips, record_periods,
        sponge_width, sponge_strength, device)
    state = [zeros, zeros, zeros, zeros]
    total = n_transient + n_record
    t0 = time.time()
    for start, stop, record in ((0, n_transient, False), (n_transient, total, True)):
        n = start
        while n < stop:
            count = min(chunk_steps, stop - n)
            state = list(_cw3d_chunk(*state, n, count, record, k))
            n += count
            if verbose:
                _ = float(state[0][0, 0, 0])  # completes the chunk
                print(f"  cw3d[{n}/{total}] {time.time() - t0:.1f}s", flush=True)
    return TimeDomainResult(phasor=_cw3d_phasor(state[2], state[3], n_record),
                            num_steps=total, dt=float(dt))

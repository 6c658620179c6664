"""Learned iterative Helmholtz solver on 3D volumes, port of
`helmnet_tpu/solvers/iterative3d.py`: HybridNet3D (models/hybridnet3d.py)
stepping against the 3D spectral PML operator (ops/spectral3d.py), with
the structure of solvers/iterative.py:

- `rollout3d` is a Python loop over an explicit carry (wavefield,
  residual, per-level hidden states) under `torch.no_grad()`, with
  NaN-safe best-iterate tracking and a (wavefield, states) warm start;
- `n_steps3d` unrolls the same steps under autograd for training;
- `IterativeSolver3D.forward` adds best iterate and host-level chunking.

Fields are NDHWC channel pairs [B, D, H, W, 2], sos maps [B, D, H, W].
Network input: wavefield(2) + 1e3*residual(2) + sigma_x/y/z(3) = 7.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import Config
from ..core.device import resolve_device
from ..models import hybridnet3d
from ..models.hybridnet import params_to
from ..ops.spectral3d import (
    SpectralPML3D,
    helmholtz_residual3d,
    make_operator3d,
    point_source_map3d,
)
from .iterative import RESIDUAL_SCALE

IN_CHANNELS_3D = 7


def with_3d_channels(cfg: Config) -> Config:
    """The config with the model's input channels set to 7."""
    if cfg.model.in_channels == IN_CHANNELS_3D:
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model, in_channels=IN_CHANNELS_3D))


class SolverCarry3D(NamedTuple):
    wavefield: torch.Tensor  # [B, D, H, W, 2]
    residual: torch.Tensor  # [B, D, H, W, 2]
    states: Tuple[torch.Tensor, ...]


def get_initials3d(sos_maps: torch.Tensor, omega: float):
    """k_sq = (omega/c)^2 and a zero wavefield."""
    k_sq = (omega / sos_maps) ** 2
    wavefield = torch.zeros(tuple(sos_maps.shape) + (2,), dtype=sos_maps.dtype,
                            device=sos_maps.device)
    return k_sq, wavefield


def network_input3d(wavefield, residual, sigmas_dhwc) -> torch.Tensor:
    b = wavefield.shape[0]
    sig = sigmas_dhwc[None].expand((b,) + tuple(sigmas_dhwc.shape))
    return torch.cat([wavefield, RESIDUAL_SCALE * residual, sig], dim=-1)


def single_step3d(params, op: SpectralPML3D, source, k_sq, carry: SolverCarry3D,
                  *, cfg: Config) -> SolverCarry3D:
    """One learned update: wf' = wf + f(...)/1e3; r' = L wf' + k^2 wf' - s."""
    sigmas_dhwc = op.sigmas.permute(1, 2, 3, 0)  # [D, H, W, 3]
    net_in = network_input3d(carry.wavefield, carry.residual, sigmas_dhwc)
    delta, new_states = hybridnet3d.apply(params, net_in, carry.states, cfg=cfg.model)
    wavefield = delta / RESIDUAL_SCALE + carry.wavefield
    residual = helmholtz_residual3d(op, wavefield, k_sq, source, cfg.operator_mode)
    return SolverCarry3D(wavefield, residual, new_states)


def residual_rmse3d(residual: torch.Tensor) -> torch.Tensor:
    """Per-sample RMSE over (D, H, W, 2)."""
    return torch.sqrt(torch.mean(residual**2, dim=(1, 2, 3, 4)))


def n_steps3d(
    params,
    op: SpectralPML3D,
    source: torch.Tensor,
    k_sq: torch.Tensor,
    carry: SolverCarry3D,
    *,
    cfg: Config,
    num_steps: int,
    remat: bool = False,
):
    """Differentiable unrolled steps from an arbitrary solver state, with
    autograd on. Returns (final_carry, ys), ys stacking the per-step
    'wavefields' and 'residuals' [U, B, D, H, W, 2] and the flat 'states'
    [U, B, C, S].

    remat=True recomputes each step in the backward pass
    (`torch.utils.checkpoint`, non-reentrant): the tape keeps only the
    per-step carries instead of every conv activation of the 3D UNet,
    for about one more forward's work; the gradients are the same."""
    n_states = len(carry.states)

    def step(wavefield, residual, *states):
        c = single_step3d(params, op, source, k_sq,
                          SolverCarry3D(wavefield, residual, states), cfg=cfg)
        return (c.wavefield, c.residual, *c.states)

    ys = {"wavefields": [], "residuals": [], "states": []}
    for _ in range(num_steps):
        args = (carry.wavefield, carry.residual, *carry.states)
        out = checkpoint(step, *args, use_reentrant=False) if remat else step(*args)
        carry = SolverCarry3D(out[0], out[1], tuple(out[2:2 + n_states]))
        ys["wavefields"].append(carry.wavefield)
        ys["residuals"].append(carry.residual)
        ys["states"].append(hybridnet3d.flatten_states(carry.states))
    return carry, {k: torch.stack(v) for k, v in ys.items()}


def _on(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


@torch.no_grad()
def rollout3d(
    params,
    op: SpectralPML3D,
    source,
    sos_maps,
    *,
    cfg: Config,
    num_iterations: int,
    collect: tuple = ("rmse",),
    init=None,
    device=None,
):
    """Inference rollout on volumes. collect ⊆ {'rmse', 'best'}; `init` is
    an optional (wavefield, states) warm start for host-level chunking.
    Returns 'wavefield', 'residual', 'states' (finals), 'rmse'
    [iterations, B] when collected, and with 'best' 'best_wavefield' and
    'best_rmse'."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    op = op.to(dev)
    source = _on(source, dev)
    sos_maps = _on(sos_maps, dev)
    k_sq, wavefield = get_initials3d(sos_maps, cfg.source.omega)
    states = hybridnet3d.init_states(sos_maps.shape[0], tuple(sos_maps.shape[1:4]),
                                     cfg.model, sos_maps.dtype, device=dev)
    if init is not None:
        wavefield = _on(init[0], dev)
        states = tuple(_on(s, dev) for s in init[1])
    residual = helmholtz_residual3d(op, wavefield, k_sq, source, cfg.operator_mode)
    carry = SolverCarry3D(wavefield, residual, states)
    track_best = "best" in collect
    best_wf = wavefield
    best_rmse = torch.full((sos_maps.shape[0],), float("inf"), dtype=sos_maps.dtype,
                           device=dev)
    rmses = []
    for _ in range(num_iterations):
        carry = single_step3d(params, op, source, k_sq, carry, cfg=cfg)
        rmse = residual_rmse3d(carry.residual)
        if track_best:
            better = rmse < best_rmse  # False for NaN: a diverging run keeps its best
            best_wf = torch.where(better[:, None, None, None, None], carry.wavefield,
                                  best_wf)
            best_rmse = torch.where(better, rmse, best_rmse)
        if "rmse" in collect:
            rmses.append(rmse)
    out = {"wavefield": carry.wavefield, "residual": carry.residual,
           "states": carry.states}
    if track_best:
        out["best_wavefield"] = best_wf
        out["best_rmse"] = best_rmse
    if "rmse" in collect:
        out["rmse"] = torch.stack(rmses)
    return out


class IterativeSolver3D:
    """Volume-domain counterpart of IterativeSolver (same conventions):
    owns config, operators, source and params."""

    def __init__(self, config: Optional[Config] = None, params=None,
                 generator: Optional[torch.Generator] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = with_3d_channels(config or Config())
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            params = hybridnet3d.init_params(gen, self.cfg.model)
        self.params = params_to(params, self.device)
        self._op_cache: dict = {}
        self.set_domain_size(self.cfg.geometry.domain_size)

    def operator(self, depth: int, height: int, width: int) -> SpectralPML3D:
        key = (depth, height, width)
        if key not in self._op_cache:
            g = self.cfg.geometry
            self._op_cache[key] = make_operator3d(
                depth, height, width, g.pml_size, g.sigma_max, self.cfg.k0,
                device=self.device)
        return self._op_cache[key]

    def set_domain_size(self, domain_size, source_location=None, source_map=None):
        """Re-target the solver to a new volume; the default source is the
        centre point."""
        if isinstance(domain_size, int):
            d = h = w = domain_size
        else:
            d, h, w = domain_size
        stride = 2 ** self.cfg.model.depth
        if d % stride or h % stride or w % stride:
            raise ValueError(f"domain {d}x{h}x{w} must be divisible by 2^depth = {stride}")
        self.depth, self.height, self.width = d, h, w
        self.op = self.operator(d, h, w)
        if source_map is not None:
            self.set_source_maps(source_map)
        else:
            s = self.cfg.source
            loc = (tuple(source_location) if source_location is not None
                   else (d // 2, h // 2, w // 2))
            self.source = _on(point_source_map3d(d, h, w, loc, s.amplitude, s.phase,
                                                 s.omega), self.device)[None]
        return self

    def set_source_maps(self, source_map):
        """Accepts [D, H, W, 2] or [B, D, H, W, 2]."""
        sm = _on(source_map, self.device)
        self.source = sm[None] if sm.dim() == 4 else sm
        return self

    def get_initials(self, sos_maps):
        return get_initials3d(_on(sos_maps, self.device), self.cfg.source.omega)

    def get_residual(self, wavefield, k_sq):
        return helmholtz_residual3d(self.op, wavefield, k_sq, self.source,
                                    self.cfg.operator_mode)

    @torch.no_grad()
    def forward(
        self,
        sos_maps,
        num_iterations: Optional[int] = None,
        *,
        best_iterate: bool = True,
        chunk_iterations: Optional[int] = None,
    ):
        """Run the learned solver on [B, D, H, W] (or [D, H, W]) sos volumes.
        `chunk_iterations` splits the rollout into warm-started chunks (the
        same trajectory); with `best_iterate`, 'wavefield' is the
        minimum-residual iterate and 'final_wavefield' the last."""
        sos = _on(sos_maps, self.device)
        if sos.dim() == 3:
            sos = sos[None]
        iters = num_iterations or self.cfg.max_iterations
        source = self.source
        if source.shape[0] == 1 and sos.shape[0] > 1:
            source = source.expand((sos.shape[0],) + tuple(source.shape[1:]))
        collect = ("rmse", "best") if best_iterate else ("rmse",)
        chunk = chunk_iterations or iters
        if iters % chunk:
            raise ValueError("need chunk_iterations | num_iterations")
        out = None
        for _ in range(iters // chunk):
            init = None if out is None else (out["wavefield"], out["states"])
            part = rollout3d(self.params, self.op, source, sos, cfg=self.cfg,
                             num_iterations=chunk, collect=collect, init=init,
                             device=self.device)
            if out is None:
                out = part
                continue
            out["rmse"] = torch.cat([out["rmse"], part["rmse"]], dim=0)
            if "best_rmse" in part:
                better = part["best_rmse"] < out["best_rmse"]
                out["best_wavefield"] = torch.where(
                    better[:, None, None, None, None], part["best_wavefield"],
                    out["best_wavefield"])
                out["best_rmse"] = torch.minimum(part["best_rmse"], out["best_rmse"])
            for key in ("wavefield", "residual", "states"):
                out[key] = part[key]
        if best_iterate:
            out["final_wavefield"] = out["wavefield"]
            out["wavefield"] = out["best_wavefield"]
        return out

    @classmethod
    def from_params_npz(cls, path: str, config: Optional[Config] = None, device=None):
        """Solver from a HybridNet3D params npz (`weights.load_params3d_npz`),
        for example `trained_models/tpu3d_a_ep80.npz` with the tpu3d_a config."""
        from ..weights import load_params3d_npz

        cfg = with_3d_channels(config or Config())
        return cls(cfg, params=load_params3d_npz(path, cfg, device=device), device=device)

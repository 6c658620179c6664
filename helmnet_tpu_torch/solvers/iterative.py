"""Learned iterative Helmholtz solver, port of
`helmnet_tpu/solvers/iterative.py`.

`rollout` runs the learned iteration as a Python loop over an explicit
carry (wavefield, residual, hidden states) — the JAX package's
`lax.scan` — under `torch.no_grad()`; `n_steps` unrolls the same steps
under autograd for training (BPTT). Each step is one HybridNet apply
plus one Helmholtz residual (ops/spectral.py). `IterativeSolver` owns the
config, operator, source and params and adds the robustness wrappers of
`forward` (source normalisation, best iterate, chunking, restarts).

Wavefields/residuals/sources are NHWC channel pairs [B, H, W, 2];
sos maps are [B, H, W].

`spatial=` (a distributed/spatial.Spatial) runs `single_step`, `n_steps`
and `rollout` on this rank's tiles of a grid split over the mesh axes y
and x: every field, source, sos map and state passed in and returned is
a tile, the PML sigma maps are sliced to it, and `residual_rmse` is the
global one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import Config
from ..core.device import resolve_device
from ..models.hybridnet import params_to
from ..models.registry import get_architecture
from ..ops.source import point_source_map
from ..ops.spectral import SpectralPML, helmholtz_residual, make_operator, resolve_mode

RESIDUAL_SCALE = 1e3  # the network sees 1e3*residual and returns 1e3*update


class SolverCarry(NamedTuple):
    wavefield: torch.Tensor  # [B, H, W, 2]
    residual: torch.Tensor  # [B, H, W, 2]
    states: Tuple[torch.Tensor, ...]


def get_initials(sos_maps: torch.Tensor, omega: float):
    """k_sq = (omega/c)^2 and a zero wavefield."""
    k_sq = (omega / sos_maps) ** 2
    b, h, w = sos_maps.shape
    wavefield = torch.zeros((b, h, w, 2), dtype=sos_maps.dtype,
                            device=sos_maps.device)
    return k_sq, wavefield


def network_input(wavefield, residual, sigmas_hwc) -> torch.Tensor:
    """[wavefield(2), 1e3*residual(2), sigma_x, sigma_y] channels."""
    b = wavefield.shape[0]
    sig = sigmas_hwc[None].expand((b,) + tuple(sigmas_hwc.shape))
    return torch.cat([wavefield, RESIDUAL_SCALE * residual, sig], dim=-1)


def single_step(params, op: SpectralPML, source, k_sq, carry: SolverCarry,
                *, cfg: Config, spatial=None) -> SolverCarry:
    """One learned update: wf' = wf + f(...)/1e3; r' = L wf' + k^2 wf' - s."""
    arch = get_architecture(cfg.model.architecture)
    sigmas = op.sigmas if spatial is None else spatial.tile(op.sigmas)
    net_in = network_input(carry.wavefield, carry.residual,
                           sigmas.permute(1, 2, 0))  # [H, W, 2]
    d, new_states = arch.apply(params, net_in, carry.states, cfg=cfg.model,
                               spatial=spatial)
    wavefield = d / RESIDUAL_SCALE + carry.wavefield
    residual = helmholtz_residual(op, wavefield, k_sq, source, cfg.operator_mode,
                                  spatial)
    return SolverCarry(wavefield, residual, new_states)


def residual_rmse(residual: torch.Tensor, spatial=None) -> torch.Tensor:
    """Per-sample RMSE over (H, W, 2); with `spatial`, of the global
    residual whose tile this is."""
    if spatial is None:
        return torch.sqrt(torch.mean(residual**2, dim=(1, 2, 3)))
    total = spatial.sum(torch.sum(residual**2, dim=(1, 2, 3)))
    return torch.sqrt(total / (spatial.height * spatial.width * residual.shape[3]))


def _on(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


@torch.no_grad()
def rollout(
    params,
    op: SpectralPML,
    source,
    sos_maps,
    *,
    cfg: Config,
    num_iterations: int,
    collect: tuple = ("rmse",),
    decimate: int = 1,
    init=None,
    device=None,
    spatial=None,
):
    """Full inference rollout.

    collect ⊆ {'rmse', 'wavefields', 'residuals', 'states', 'best'};
    per-iteration outputs other than rmse are sampled every `decimate`
    steps. `init`: optional (wavefield, states) warm start. Returns a dict
    with 'wavefield', 'residual', 'states' (finals) plus the stacked
    per-iteration tensors of each requested key ('rmse' is
    [iterations, B]); with 'best', also 'best_wavefield' and 'best_rmse'.
    As in the JAX package, a collected 'states' trace replaces the final
    states under the same key.
    """
    if num_iterations % decimate != 0:
        raise ValueError("num_iterations must be divisible by decimate")
    dev = resolve_device(device)
    params = params_to(params, dev)
    arch = get_architecture(cfg.model.architecture)
    params = arch.prepare_params(params, cfg.model)  # K1's weights, once a rollout
    op = op.to(dev)
    source = _on(source, dev)
    sos_maps = _on(sos_maps, dev)
    k_sq, wavefield = get_initials(sos_maps, cfg.source.omega)
    states = arch.init_states(sos_maps.shape[0], tuple(sos_maps.shape[1:3]),
                              cfg.model, sos_maps.dtype, device=dev,
                              spatial=spatial)
    if init is not None:  # warm start (host-chunked long rollouts)
        wavefield = _on(init[0], dev)
        states = tuple(_on(s, dev) for s in init[1])
    residual = helmholtz_residual(op, wavefield, k_sq, source, cfg.operator_mode,
                                  spatial)
    carry = SolverCarry(wavefield, residual, states)
    track_best = "best" in collect
    best_wf = wavefield
    best_rmse = torch.full((sos_maps.shape[0],), float("inf"),
                           dtype=sos_maps.dtype, device=dev)
    rmses = []
    traces = {k: [] for k in ("wavefields", "residuals", "states") if k in collect}

    for _ in range(num_iterations // decimate):
        for _ in range(decimate):
            carry = single_step(params, op, source, k_sq, carry, cfg=cfg,
                                spatial=spatial)
            if "rmse" in collect or track_best:
                rmse = residual_rmse(carry.residual, spatial)
            if "rmse" in collect:
                rmses.append(rmse)
            if track_best:
                better = rmse < best_rmse
                best_wf = torch.where(better[:, None, None, None],
                                      carry.wavefield, best_wf)
                # NOT torch.minimum: once a diverging trajectory hits NaN it
                # would poison the best-so-far; `better` is False for NaN
                best_rmse = torch.where(better, rmse, best_rmse)
        if "wavefields" in traces:
            traces["wavefields"].append(carry.wavefield)
        if "residuals" in traces:
            traces["residuals"].append(carry.residual)
        if "states" in traces:
            traces["states"].append(arch.flatten_states(carry.states))

    out = {
        "wavefield": carry.wavefield,
        "residual": carry.residual,
        "states": carry.states,
    }
    if track_best:
        out["best_wavefield"] = best_wf
        out["best_rmse"] = best_rmse
    if "rmse" in collect:
        out["rmse"] = torch.stack(rmses)
    for key, trace in traces.items():
        out[key] = torch.stack(trace)
    return out


def n_steps(
    params,
    op: SpectralPML,
    source: torch.Tensor,
    k_sq: torch.Tensor,
    carry: SolverCarry,
    *,
    cfg: Config,
    num_steps: int,
    remat: bool = False,
    spatial=None,
):
    """Differentiable unrolled steps from an arbitrary solver state
    (reference n_steps, hybridnet.py:586-623), a Python loop of
    `single_step` with autograd on. Returns (final_carry, ys), ys stacking
    the per-step 'wavefields' and 'residuals' [U, B, H, W, 2] and the flat
    'states' [U, B, C, S].

    remat=True recomputes each step in the backward pass
    (`torch.utils.checkpoint`, non-reentrant): the tape keeps only the
    per-step carries instead of every conv activation; the gradients are
    the same."""
    arch = get_architecture(cfg.model.architecture)
    n_states = len(carry.states)

    def step(wavefield, residual, *states):
        c = single_step(params, op, source, k_sq,
                        SolverCarry(wavefield, residual, states), cfg=cfg,
                        spatial=spatial)
        return (c.wavefield, c.residual, *c.states)

    ys = {"wavefields": [], "residuals": [], "states": []}
    for _ in range(num_steps):
        args = (carry.wavefield, carry.residual, *carry.states)
        out = checkpoint(step, *args, use_reentrant=False) if remat else step(*args)
        carry = SolverCarry(out[0], out[1], tuple(out[2:2 + n_states]))
        ys["wavefields"].append(carry.wavefield)
        ys["residuals"].append(carry.residual)
        ys["states"].append(arch.flatten_states(carry.states))
    return carry, {k: torch.stack(v) for k, v in ys.items()}


class IterativeSolver:
    """Owns config, operator, source and params; mirrors the JAX package's
    `IterativeSolver` (set_domain_size, set_sources, forward)."""

    def __init__(self, config: Config, params=None,
                 generator: Optional[torch.Generator] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = config
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            params = get_architecture(config.model.architecture).init_params(
                gen, config.model)
        self.params = params_to(params, self.device)
        self._op_cache: dict = {}
        self.set_domain_size(config.geometry.domain_size)

    # -- geometry / source management ------------------------------------

    def operator(self, height: int, width: int) -> SpectralPML:
        key = (height, width)
        if key not in self._op_cache:
            g = self.cfg.geometry
            # fft mode never reads the dense [N, N] tables
            dense = resolve_mode(self.cfg.operator_mode, height, width) != "fft"
            self._op_cache[key] = make_operator(
                height, width, g.pml_size, g.sigma_max, self.cfg.k0,
                dense=dense, device=self.device,
            )
        return self._op_cache[key]

    def set_domain_size(
        self,
        domain_size,
        source_location: Optional[Sequence[int]] = None,
        source_map=None,
    ):
        """Re-target the solver to a new grid; the same weights run at any
        size divisible by 2^depth."""
        if isinstance(domain_size, int):
            height = width = domain_size
        else:
            height, width = domain_size
        stride = 2 ** self.cfg.model.depth
        if height % stride or width % stride:
            raise ValueError(
                f"domain size {height}x{width} must be divisible by "
                f"2^depth = {stride} (UNet down/up path)"
            )
        self.height, self.width = height, width
        self.cfg = self.cfg.replace(
            geometry=self.cfg.geometry.__class__(
                domain_size=height,
                pml_size=self.cfg.geometry.pml_size,
                sigma_max=self.cfg.geometry.sigma_max,
            )
        )
        self.op = self.operator(height, width)
        if source_map is not None:
            self.set_source_maps(source_map)
        else:
            loc = tuple(source_location or self.cfg.source.location)
            self.set_sources([loc])
        return self

    def set_sources(self, locations: Sequence[Sequence[int]]):
        s = self.cfg.source
        maps = np.stack([
            point_source_map(
                self.height, self.width, tuple(loc), s.amplitude, s.phase,
                s.omega, 0.0, s.smoothing,
            )
            for loc in locations
        ])
        self.source = _on(maps, self.device)
        return self

    def set_source_maps(self, source_map):
        """Accepts [H,W,2], [B,H,W,2], or torch-layout [B,2,H,W]."""
        sm = _on(source_map, self.device)
        if sm.ndim == 3:
            sm = sm[None]
        if sm.shape[-1] != 2 and sm.shape[1] == 2:
            sm = sm.permute(0, 2, 3, 1).contiguous()
        self.source = sm
        return self

    # -- physics ----------------------------------------------------------

    def get_initials(self, sos_maps):
        return get_initials(_on(sos_maps, self.device), self.cfg.source.omega)

    def get_residual(self, wavefield, k_sq):
        return helmholtz_residual(
            self.op, wavefield, k_sq, self.source, self.cfg.operator_mode
        )

    # -- inference --------------------------------------------------------

    @torch.no_grad()
    def forward(
        self,
        sos_maps,
        num_iterations: Optional[int] = None,
        collect: tuple = ("rmse",),
        decimate: int = 1,
        *,
        normalize_source: bool = True,
        best_iterate: bool = True,
        chunk_iterations: Optional[int] = None,
        restart_on_divergence: bool = False,
        restart_factor: float = 10.0,
    ):
        """Run the learned solver. sos_maps: [B, H, W] (or [H, W]).

        * `normalize_source` rescales each sample's source so that its peak
          complex amplitude is the training amplitude, solves at that scale
          and scales every returned field, residual and rmse back.
        * `best_iterate`: `out['wavefield']` is the minimum-residual iterate,
          with the raw final under `out['final_wavefield']`.
        * `chunk_iterations` splits the rollout into chunks of at most that
          many iterations, each warm-started from the last.
        * `restart_on_divergence` (needs chunking): a sample that ends a
          chunk with rmse > restart_factor x its best restarts the next
          chunk from its best iterate with fresh hidden states.
        """
        sos = _on(sos_maps, self.device)
        if sos.ndim == 2:
            sos = sos[None]
        iters = num_iterations or self.cfg.max_iterations
        source = self.source
        if source.shape[0] == 1 and sos.shape[0] > 1:
            source = source.expand((sos.shape[0],) + tuple(source.shape[1:]))
        scale = None
        if normalize_source:
            amp = torch.sqrt(source[..., 0] ** 2 + source[..., 1] ** 2).amax(dim=(1, 2))
            scale = torch.where(amp > 0, self.cfg.source.amplitude / amp,
                                torch.ones_like(amp))
            source = source * scale[:, None, None, None]
        eff_collect = tuple(collect)
        if best_iterate and "best" not in eff_collect:
            eff_collect = eff_collect + ("best",)
        chunk = chunk_iterations or iters
        if chunk % decimate or iters % chunk:
            raise ValueError("need decimate | chunk_iterations | num_iterations")
        if chunk_iterations and chunk < iters and "states" in eff_collect:
            # a collected states trace shares the 'states' key with the
            # final carry the warm start needs
            raise ValueError("collect='states' is unsupported with chunk_iterations")
        if restart_on_divergence and chunk >= iters:
            raise ValueError(
                "restart_on_divergence needs chunk_iterations < "
                "num_iterations (restarts happen at chunk boundaries)")
        if restart_on_divergence and "best" not in eff_collect:
            eff_collect = eff_collect + ("best",)
        out = None
        for _ in range(iters // chunk):
            init = None
            if out is not None:
                wf, states = out["wavefield"], out["states"]
                if restart_on_divergence:
                    end_rmse = residual_rmse(out["residual"])
                    bad = end_rmse > restart_factor * out["best_rmse"]
                    if bool(bad.any()):
                        wf = torch.where(bad[:, None, None, None],
                                         out["best_wavefield"], wf)
                        states = tuple(
                            torch.where(bad[:, None, None, None],
                                        torch.zeros_like(s), s)
                            for s in states
                        )
                init = (wf, states)
            part = rollout(
                self.params, self.op, source, sos, cfg=self.cfg,
                num_iterations=chunk, collect=eff_collect, decimate=decimate,
                init=init, device=self.device,
            )
            if out is None:
                out = part
                continue
            for key in ("rmse", "wavefields", "residuals"):
                if key in part:
                    out[key] = torch.cat([out[key], part[key]], dim=0)
            if "best_rmse" in part:  # merge best-iterate across chunks
                better = part["best_rmse"] < out["best_rmse"]
                out["best_wavefield"] = torch.where(
                    better[:, None, None, None],
                    part["best_wavefield"], out["best_wavefield"],
                )
                out["best_rmse"] = torch.minimum(part["best_rmse"], out["best_rmse"])
            for key in ("wavefield", "residual", "states"):
                out[key] = part[key]
        if scale is not None:
            # undo the linear rescale on every solution-linear output
            inv = 1.0 / scale
            for key, bcast in (
                ("wavefield", inv[:, None, None, None]),
                ("residual", inv[:, None, None, None]),
                ("best_wavefield", inv[:, None, None, None]),
                ("wavefields", inv[None, :, None, None, None]),
                ("residuals", inv[None, :, None, None, None]),
                ("rmse", inv[None, :]),
                ("best_rmse", inv),
            ):
                if key in out:
                    out[key] = out[key] * bcast
        if best_iterate:
            out["final_wavefield"] = out["wavefield"]
            out["wavefield"] = out["best_wavefield"]
        return out

    @classmethod
    def from_reference_checkpoint(cls, path: str, config: Optional[Config] = None,
                                  device=None):
        """Solver from the reference PyTorch-Lightning `.ckpt`, with the
        checkpoint's config unless `config` is given."""
        from ..train.checkpoint import load_reference_checkpoint

        params, ckpt_cfg = load_reference_checkpoint(path, device=device)
        return cls(config or ckpt_cfg, params=params, device=device)

    @classmethod
    def from_params_npz(cls, path: str, config: Optional[Config] = None,
                        device=None):
        """Solver from a flat params npz (`weights.load_params_npz`), with
        the default config unless `config` is given. This is how the
        weights of an orbax training run reach the port:
        `tools/export_orbax_npz.py` writes the run's best step as such a
        file (for example `trained_models/tpu_r2c_best.npz`), since orbax
        imports JAX and the port does not."""
        from ..weights import load_params_npz

        cfg = config or Config()
        return cls(cfg, params=load_params_npz(path, cfg, device=device),
                   device=device)


@torch.no_grad()
def rollout_variable_source(
    params,
    op: SpectralPML,
    sources,
    switch_iterations,
    sos_maps,
    *,
    cfg: Config,
    num_iterations: int,
    collect: tuple = ("rmse",),
    decimate: int = 1,
    device=None,
):
    """Rollout with the source map changing over iterations (reference
    forward_variable_src, hybridnet.py:699-754).

    sources: [K, B, H, W, 2] stacked source maps; switch_iterations: [K]
    ascending iteration indices at which each source becomes active
    (switch_iterations[0] should be 0). At a switch after iteration 0 the
    residual is recomputed against the new source before stepping, as the
    reference does. Which source is active is counted on the host from a
    numpy copy of `switch_iterations`, so no step waits on the card.
    collect ⊆ {'rmse', 'wavefields', 'residuals', 'states'}; the traces
    other than rmse are sampled every `decimate` steps."""
    if num_iterations % decimate != 0:
        raise ValueError("num_iterations must be divisible by decimate")
    dev = resolve_device(device)
    params = params_to(params, dev)
    arch = get_architecture(cfg.model.architecture)
    params = arch.prepare_params(params, cfg.model)  # K1's weights, once a rollout
    op = op.to(dev)
    sources = _on(sources, dev)
    switch = np.asarray(switch_iterations.cpu() if isinstance(
        switch_iterations, torch.Tensor) else switch_iterations)
    sos_maps = _on(sos_maps, dev)
    k_sq, wavefield = get_initials(sos_maps, cfg.source.omega)
    states = arch.init_states(sos_maps.shape[0], tuple(sos_maps.shape[1:3]),
                              cfg.model, sos_maps.dtype, device=dev)

    def source_at(it: int) -> torch.Tensor:
        # a negative index takes the last source, as JAX's dynamic index does
        return sources[int(np.sum(switch <= it)) - 1]

    residual = helmholtz_residual(op, wavefield, k_sq, source_at(0), cfg.operator_mode)
    carry = SolverCarry(wavefield, residual, states)
    rmses = []
    traces = {k: [] for k in ("wavefields", "residuals", "states") if k in collect}
    for it in range(num_iterations):
        src = source_at(it)
        if it > 0 and np.any(switch == it):  # hybridnet.py:729-733
            carry = carry._replace(residual=helmholtz_residual(
                op, carry.wavefield, k_sq, src, cfg.operator_mode))
        carry = single_step(params, op, src, k_sq, carry, cfg=cfg)
        if "rmse" in collect:
            rmses.append(residual_rmse(carry.residual))
        if (it + 1) % decimate == 0:
            if "wavefields" in traces:
                traces["wavefields"].append(carry.wavefield)
            if "residuals" in traces:
                traces["residuals"].append(carry.residual)
            if "states" in traces:
                traces["states"].append(arch.flatten_states(carry.states))
    out = {"wavefield": carry.wavefield, "residual": carry.residual}
    if "rmse" in collect:
        out["rmse"] = torch.stack(rmses)
    for key, trace in traces.items():
        out[key] = torch.stack(trace)
    return out

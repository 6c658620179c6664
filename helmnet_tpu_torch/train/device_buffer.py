"""Device-resident replay training, port of
`helmnet_tpu/train/device_buffer.py`: the replay buffer and the sos
dataset live on the card.

The host loop of train/loop.py moves the sampled batch up, the evolved
fields down and the fresh restarts up and down every step. Here the
buffer and the sos pool are tensors on the trainer's device, and
`mega_step` does gather -> unrolled train step -> re-admission gate ->
fresh restarts -> scatter write-back there; the host contributes only the
RNG integers and reads the scalar metrics at the end of an epoch.

Semantics are the host path's (same gate res^2 < 1, same curriculum age
logic, hybridnet.py:427-464). The batch is gathered with advanced
indexing, which copies, so the write-back, made after `backward()`, cannot
alias a tensor saved for it.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..models.registry import get_architecture
from ..ops.source import point_source_kernels, point_sources_on_device
from ..ops.spectral import SpectralPML, helmholtz_residual
from ..solvers.iterative import get_initials
from .replay import ExperienceBatch

FIELDS = ("wavefield", "states", "k_sq", "residual", "source", "iteration")


@torch.no_grad()
def fresh_experiences(op: SpectralPML, source: torch.Tensor,
                      sos_maps: torch.Tensor, cfg: Config) -> dict:
    """Fresh iteration-0 experiences for sos maps [B, H, W] (train_dataloader
    fill logic, hybridnet.py:199-218): zero wavefield and states, k^2, and
    the residual of the zero field, all on the maps' device."""
    arch = get_architecture(cfg.model.architecture)
    k_sq, wavefield = get_initials(sos_maps, cfg.source.omega)
    states = arch.init_states(sos_maps.shape[0], tuple(sos_maps.shape[1:3]),
                              cfg.model, sos_maps.dtype, device=sos_maps.device)
    residual = helmholtz_residual(op, wavefield, k_sq, source, cfg.operator_mode)
    return {
        "wavefield": wavefield,
        "states": arch.flatten_states(states),
        "k_sq": k_sq,
        "residual": residual,
    }


def make_device_buffer_fns(cfg: Config, train_step, *, device,
                           sparse_sources: bool = False):
    """Returns (init_buffer, mega_step).

    `train_step(batch, pick)` takes an `ExperienceBatch` of tensors on
    `device` and the index of the unrolled step to keep, takes one optimizer
    step, and returns (metrics, evolved) as `Trainer._train_step` does.

    Buffer: a dict of [cap, ...] tensors on `device`, `iteration` [cap]
    int32. sparse_sources=True reads the `src_pool` argument as [K, 2]
    int32 point-source locations and stamps the maps on the device from
    the separable kernels (TrainingConfig.sparse_source_pool: a dense pool
    is O(K*H*W) device memory).
    """
    if sparse_sources:
        n = cfg.geometry.domain_size
        ky, kx = (torch.as_tensor(k, device=device)
                  for k in point_source_kernels(n, n, cfg.source.smoothing))

        def pool_sources(src_pool, idx):
            return point_sources_on_device(ky, kx, src_pool[idx],
                                           cfg.source.amplitude, cfg.source.phase)
    else:

        def pool_sources(src_pool, idx):
            return src_pool[idx]

    @torch.no_grad()
    def init_buffer(op, src_pool, src_idx, sos_maps, ages):
        """Seed every slot from sos_maps [cap, H, W] with ages [cap]; slot i
        gets the source src_pool[src_idx[i]] (index 0 is the training
        source, higher indices the optional random-circle curriculum)."""
        src = pool_sources(src_pool, src_idx)
        buf = fresh_experiences(op, src, sos_maps, cfg)
        buf["source"] = src
        buf["iteration"] = ages.to(torch.int32)
        return buf

    def mega_step(buf, op, src_pool, sos_pool, slot_idx, fresh_idx,
                  fresh_src_idx, pick: int, maxiter: int) -> dict:
        """One train step on the slots `slot_idx` (int64 [B]); restarted
        slots take sos_pool[fresh_idx] and source fresh_src_idx. Updates
        `buf` in place and returns the step's metrics as device scalars."""
        # advanced indexing copies: the batch never aliases the buffer
        batch = ExperienceBatch(*(buf[k][slot_idx] for k in FIELDS),
                                indices=slot_idx)
        metrics, evolved = train_step(batch, pick)
        with torch.no_grad():
            new_age = batch.iteration + (pick + 1)
            keep = (evolved["res_sq_mean"] < 1.0) & (new_age < maxiter)
            fresh_src = pool_sources(src_pool, fresh_src_idx)
            fresh = fresh_experiences(op, fresh_src, sos_pool[fresh_idx], cfg)
            k4 = keep[:, None, None, None]
            k3 = keep[:, None, None]
            rows = {
                "wavefield": torch.where(k4, evolved["wavefield"], fresh["wavefield"]),
                "states": torch.where(k3, evolved["states"], fresh["states"]),
                "k_sq": torch.where(k3, batch.k_sq, fresh["k_sq"]),
                "residual": torch.where(k4, evolved["residual"], fresh["residual"]),
                "source": torch.where(k4, batch.source, fresh_src),
                "iteration": torch.where(keep, new_age, torch.zeros_like(new_age)),
            }
            for key, value in rows.items():
                buf[key].index_copy_(0, slot_idx, value)
            metrics["restarts"] = (~keep).sum()
        return metrics

    return init_buffer, mega_step

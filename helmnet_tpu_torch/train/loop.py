"""Unsupervised physics-residual training loop, port of
`helmnet_tpu/train/loop.py`.

The reference training scheme (hybridnet.py:385-505):

* truncated BPTT: sample partially-solved problems from the replay buffer,
  unroll `unrolling_steps` learned updates under autograd
  (`solvers/iterative.n_steps`), loss = amplify * mean(residuals^2) over
  all unrolled steps;
* curriculum: experiences may only evolve up to min(slope*epoch+1, max_iter)
  solver iterations before being restarted from a fresh sos map;
* re-admission gate: evolved experiences return to their buffer slot only if
  mean(res^2) < 1 (divergence guard), else the slot restarts at iteration 0;
* Adam(0.9, 0.95) + L2 weight decay + grad value-clipping 1.0 +
  ReduceLROnPlateau(factor .5, patience 10) on the epoch-mean train loss.

The network runs on cuDNN (`double_conv_mode='xla'`), as the JAX package
trains on XLA convolutions: K1, the fused DoubleConv kernel, has no
backward, and the JAX package cannot differentiate its Pallas kernel
either, so `Trainer` refuses `'pallas'` mode.

`sanitize=True` is the JAX package's two-tier checked step
(`helmnet_tpu/train/loop.py:298-346`): the step runs uninstrumented; when
its loss or gradient norm is not finite, the forward is replayed under
`core/sanitize.checked`, which raises naming the first op that made a
NaN or inf, else the step raises saying the backward made it. The check
comes after `backward()` and before the optimizer step, so a step that
raises leaves the params and the Adam state as they were.

Data parallelism (`mesh=`, a core/meshes.make_mesh mesh): every rank runs
the same loop on the same seeds, so its replay buffer, draws and params
stay equal to every other rank's. A train step takes the global batch,
computes this rank's slice of it (`shard_experience`), all-reduces the
gradients to their mean and the loss to the global one, and applies the
same Adam step on every rank; the evolved experiences are all-gathered
before the write-back. So a data=N run equals the single-process run step
for step, up to the order of the sums. Only the primary rank writes logs
and checkpoints.

A mesh that splits the grid (y or x above 1) partitions the UNet and the
operator spatially (distributed/spatial.py), as GSPMD does for the JAX
package: each rank computes on its tile of every field and of every
level's hidden state, its convolutions exchange halos, and its operator
gathers along the contracted axis (matmul) or transposes pencils (fft).
The loss and metrics are global
means; each rank's gradient, a partial sum, is all-reduced over the whole
mesh; the evolved fields and states are gathered before the write-back.
The buffer, the draws and `validate` stay replicated on every rank. Both
operator modes and both architectures partition; a UNet level that does
not split evenly runs whole along that axis (distributed/spatial.py).

Params are the port's nested dicts of leaf tensors; the trainer owns them
(copies with `requires_grad`) and steps them in place with `torch.optim.Adam`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.meshes import data_sharding
from ..distributed import multihost
from ..distributed.spatial import Spatial
from ..models.hybridnet import iter_leaves, map_leaves
from ..models.registry import get_architecture
from ..ops.source import line_source_map, point_source_map
from ..ops.spectral import make_operator
from ..solvers.iterative import SolverCarry, n_steps, rollout
from .device_buffer import fresh_experiences, make_device_buffer_fns
from .replay import ExperienceBatch, ReplayBuffer


def resolve_epoch_cap(
    start_epoch: int,
    max_epochs: int,
    *,
    warm_started: bool = False,
    epoch_budget: Optional[int] = None,
) -> int:
    """Absolute epoch at which a training run should stop.

    Resumes of an interrupted run keep the ABSOLUTE `max_epochs` cap (the
    run simply continues toward its original budget). A warm start is a
    NEW run that inherits the source checkpoint's epoch counter only for
    curriculum/bookkeeping continuity — so its cap is a BUDGET measured
    from the restored counter. An explicit `epoch_budget` always wins
    (needed to RESUME a warm-started run, where the caller can no longer
    tell it was warm-started).
    """
    if epoch_budget is not None:
        return start_epoch + epoch_budget
    if warm_started:
        return start_epoch + max_epochs
    return max_epochs


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam over the params' leaves in tree order, the JAX package's optax
    chain clip-by-value -> add-decayed-weights -> scale_by_adam(b1, b2) ->
    -lr: torch's Adam adds the L2 term to the gradient before its moments
    (not AdamW), and `apply_gradients` clips by value before it (not by
    norm)."""
    t = cfg.training
    return torch.optim.Adam(
        [leaf for _, leaf in iter_leaves(params)], lr=t.learning_rate,
        betas=(t.adam_b1, t.adam_b2), eps=1e-8, weight_decay=t.weight_decay,
    )


def apply_gradients(optimizer: torch.optim.Optimizer, gradient_clip: float,
                    check=None):
    """One optimizer step on the gradients in the leaves' `.grad`. Returns
    the global norm of the raw gradients, before the clip (optax's
    `global_norm(grads)`), as a device scalar. `check(grad_norm)`, when
    given, runs before anything is changed and may raise."""
    leaves = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
    grad_norm = torch.sqrt(sum(torch.sum(p.grad**2) for p in leaves))
    if check is not None:
        check(grad_norm)
    if gradient_clip > 0:
        torch.nn.utils.clip_grad_value_(leaves, gradient_clip)
    optimizer.step()
    return grad_norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def unrolled_loss(params, op, batch: ExperienceBatch, *, cfg: Config,
                  spatial=None):
    """loss_amplify * mean(residuals^2) over `unrolling_steps` steps from the
    batch's experiences (tensors on one device), with autograd on.
    Returns (loss, ys) as `n_steps` stacks them. With `spatial` the batch
    holds this rank's tiles (`shard_experience`) and the loss is the mean
    over the tile."""
    arch = get_architecture(cfg.model.architecture)
    t = cfg.training
    carry = SolverCarry(
        batch.wavefield,
        batch.residual,
        arch.unflatten_states(batch.states, tuple(batch.wavefield.shape[1:3]),
                              cfg.model, spatial=spatial),
    )
    _, ys = n_steps(params, op, batch.source, batch.k_sq, carry, cfg=cfg,
                    num_steps=t.unrolling_steps, remat=t.remat, spatial=spatial)
    return t.loss_amplify * torch.mean(ys["residuals"] ** 2), ys


def shard_experience(mesh, batch: ExperienceBatch, spatial=None,
                     cfg: Optional[Config] = None) -> ExperienceBatch:
    """This rank's part of an ExperienceBatch, on the mesh's device: its
    slice along the data axis and, with `spatial` (and the `cfg` whose
    state layout the flat states follow), its tile of every field, of
    k_sq and of every level of the flat states (at that level's
    partition, `Spatial.level`), which are then flattened again in the
    tile's own layout. Every rank passes the full global batch; `indices`
    stay global."""
    s = data_sharding(mesh)
    local = ExperienceBatch(
        *(multihost.put_global(a, s) for a in batch[:-1]), batch.indices)
    if spatial is None:
        return local
    arch = get_architecture(cfg.model.architecture)
    states = arch.unflatten_states(local.states, (spatial.height, spatial.width),
                                   cfg.model)
    return local._replace(
        wavefield=spatial.tile(local.wavefield).contiguous(),
        residual=spatial.tile(local.residual).contiguous(),
        source=spatial.tile(local.source).contiguous(),
        k_sq=spatial.tile(local.k_sq).contiguous(),
        states=arch.flatten_states([spatial.level(d).tile(st)
                                    for d, st in enumerate(states)]),
    )


class PlateauScheduler:
    """ReduceLROnPlateau(min, factor, patience) — hybridnet.py:270-283.
    Kept apart from torch's `ReduceLROnPlateau`, whose default relative
    threshold of 1e-4 changes when the lr drops."""

    def __init__(self, lr: float, factor: float, patience: int, min_lr: float):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class Trainer:
    """Owns params, optimizer state, replay buffer and operator; runs epochs."""

    def __init__(
        self,
        cfg: Config,
        params=None,
        generator: Optional[torch.Generator] = None,
        mesh=None,
        log_dir: Optional[str] = None,
        device_buffer: bool = False,
        sanitize: bool = False,
        device=None,
    ):
        """`params`: the port's params tree (copied; defaults to a seeded
        init). device_buffer=True keeps the replay buffer and the sos
        dataset on the device and runs sample/train/write-back there
        (train/device_buffer.py); the host-side buffer is the default.
        Entry point: runs on `cuda` unless `device` says otherwise."""
        if cfg.model.double_conv_mode == "pallas":
            raise ValueError(
                "training needs double_conv_mode='xla': K1, the fused "
                "DoubleConv kernel of double_conv_mode='pallas', has no "
                "backward (its launches return tensors with no grad_fn, so "
                "every DoubleConv weight would get no gradient), and the JAX "
                "package cannot differentiate its Pallas kernel either"
            )
        g = cfg.geometry
        self.spatial = None
        if mesh is not None and (mesh.size("y") > 1 or mesh.size("x") > 1):
            levels = cfg.model.depth if cfg.model.architecture == "custom_unet" else 0
            self.spatial = Spatial(mesh, g.domain_size, g.domain_size, levels)
        self.sanitize = sanitize
        self.cfg = cfg
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self.device_buffer = device_buffer
        self._dev_buf = None
        self._sos_pool = None
        self.arch = get_architecture(cfg.model.architecture)
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            params = self.arch.init_params(gen, cfg.model)
        self.params = map_leaves(params, lambda _, t: t.detach().to(
            self.device, torch.float32).clone().requires_grad_(True))
        self.height = self.width = g.domain_size
        self.op = make_operator(self.height, self.width, g.pml_size, g.sigma_max,
                                cfg.k0, device=self.device)
        s = cfg.source
        self.source_map = point_source_map(
            self.height, self.width, tuple(s.location), s.amplitude, s.phase,
            s.omega, 0.0, s.smoothing,
        )
        t = cfg.training
        auto_sparse = (
            device_buffer
            and t.p_extended_source <= 0
            and self.height * self.width >= 256 * 256
        )
        self._sparse_sources = (
            t.sparse_source_pool if t.sparse_source_pool is not None else auto_sparse
        )
        if self._sparse_sources and t.p_extended_source > 0:
            raise ValueError(
                "sparse_source_pool stores point locations only; extended "
                "line-segment sources need the dense pool"
            )
        self._src_pool_host = (
            self._build_source_locs() if self._sparse_sources
            else self._build_source_pool()
        )
        self.src_pool = torch.as_tensor(self._src_pool_host, device=self.device)
        self.optimizer = make_optimizer(cfg, self.params)
        self.capacity = t.buffer_size
        # the host-side buffer exists on the host path only; the device
        # path keeps everything on the card (train/device_buffer.py)
        self.buffer = None if device_buffer else ReplayBuffer(
            t.buffer_size,
            self.height,
            self.width,
            cfg.model.state_channels,
            self.arch.total_state_length(self.height, cfg.model),
        )
        self.rng = np.random.default_rng(0)
        self.scheduler = PlateauScheduler(
            t.learning_rate, t.plateau_factor, t.plateau_patience,
            t.minimum_learning_rate,
        )
        self.epoch = 0
        self.global_step = 0
        self.log_dir = log_dir
        self._log_file = None
        self._tb = None
        if log_dir and multihost.is_primary():
            os.makedirs(log_dir, exist_ok=True)
            self._log_file = open(os.path.join(log_dir, "train_log.jsonl"), "a")
            self._tb = self._make_tb_writer(log_dir)
        self.terminate_on_nan = True  # reference train.py --terminate_on_nan
        if device_buffer:
            self._init_dev_buffer, self._mega_step = make_device_buffer_fns(
                cfg, self._train_step, device=self.device,
                sparse_sources=self._sparse_sources,
            )

    @staticmethod
    def _make_tb_writer(log_dir):
        """TensorBoard logging (reference TensorBoardLogger, train.py:88);
        optional: None when torch's summary writer cannot be made."""
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(os.path.join(log_dir, "tb"))
        except Exception:
            return None

    def close(self) -> None:
        """Close the log file and the TensorBoard writer."""
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    # ------------------------------------------------------------------

    def _train_step(self, batch: ExperienceBatch, pick: int):
        """One optimizer step on a batch of tensors on the trainer's device.
        Returns (metrics, evolved): loss, rel_loss and the raw grad norm as
        device scalars; the batch after `pick` + 1 unrolled steps, detached,
        with its per-sample mean(res^2). With a mesh every value is the
        global one, on every rank."""
        mesh, spatial = self.mesh, self.spatial
        local = batch if mesh is None else shard_experience(mesh, batch, spatial,
                                                            self.cfg)
        self.optimizer.zero_grad(set_to_none=True)
        loss, ys = unrolled_loss(self.params, self.op, local, cfg=self.cfg,
                                 spatial=spatial)
        loss.backward()
        loss = loss.detach().clone()
        if mesh is not None:
            # equal shards and tiles: the global means are the ranks' means
            self._mean_over_mesh([p.grad for _, p in iter_leaves(self.params)]
                                 + [loss])
        check = None
        if self.sanitize:
            check = lambda grad_norm: self._check_step(loss, grad_norm, batch)
        grad_norm = apply_gradients(self.optimizer, self.cfg.training.gradient_clip,
                                    check)
        with torch.no_grad():
            res = ys["residuals"].detach()
            evolved = {
                "wavefield": ys["wavefields"][pick].detach(),
                "states": ys["states"][pick].detach(),
                "residual": res[pick],
            }
            if spatial is None:
                ms = torch.mean(res**2, dim=(2, 3, 4))  # [U, B]
            else:
                ms = spatial.sum(torch.sum(res**2, dim=(2, 3, 4))) / (
                    self.height * self.width * res.shape[-1])
            evolved["res_sq_mean"] = ms[pick]
            metrics = {
                "loss": loss,
                "rel_loss": torch.mean(torch.sqrt(ms)),
                "grad_norm": grad_norm,
            }
            if mesh is not None:
                self._mean_over_mesh([metrics["rel_loss"]])
                evolved = self._gather_evolved(evolved)
        return metrics, evolved

    def _check_step(self, loss, grad_norm, batch: ExperienceBatch) -> None:
        """The sanitized step's test, before the optimizer step: a
        non-finite loss or grad norm replays the forward on the global
        batch under `checked` (one process, no collectives, so every rank
        raises alike), which raises naming the op; a finite replay means
        the backward made the NaN or inf."""
        loss_v, gn = float(loss), float(grad_norm)
        if np.isfinite(loss_v) and np.isfinite(gn):
            return
        from ..core.sanitize import checked

        with torch.no_grad():
            checked(unrolled_loss)(self.params, self.op, batch, cfg=self.cfg)
        raise FloatingPointError(
            f"non-finite training step (loss={loss_v}, grad_norm={gn}) with a "
            "finite forward pass: the NaN/inf was produced in the BACKWARD "
            "pass (e.g. a derivative at a non-differentiable point)")

    def _gather_evolved(self, evolved: dict) -> dict:
        """The global evolved experiences from every rank's part: tiles
        gathered over y and x (the states level by level), then the batch
        over data."""
        spatial = self.spatial
        if spatial is not None:
            arch = self.arch
            tile_states = arch.unflatten_states(evolved["states"], None,
                                                self.cfg.model, spatial=spatial)
            evolved = dict(
                evolved,
                wavefield=spatial.gather(evolved["wavefield"]),
                residual=spatial.gather(evolved["residual"]),
                states=arch.flatten_states([spatial.level(d).gather(st)
                                            for d, st in enumerate(tile_states)]),
            )
        n, group = self.mesh.size("data"), self.mesh.group("data")
        return {k: multihost.all_gather_dim(v, group, n, 0)
                for k, v in evolved.items()}

    def _mean_over_mesh(self, tensors) -> None:
        """Replace each tensor by its mean over every rank of the mesh, with
        one all-reduce of their concatenation."""
        if not multihost.is_initialized() or multihost.process_count() == 1:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        torch.distributed.all_reduce(flat)
        flat /= multihost.process_count()
        start = 0
        for t in tensors:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()

    def _init_experiences(self, source: np.ndarray, sos_maps: np.ndarray) -> dict:
        """Fresh experiences, computed on the device, as numpy arrays."""
        exp = fresh_experiences(
            self.op, torch.as_tensor(source, device=self.device),
            torch.as_tensor(sos_maps, device=self.device), self.cfg,
        )
        return {k: v.cpu().numpy() for k, v in exp.items()}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """`a` on the trainer's device. To a card through pinned memory and
        without a wait: a pageable copy would first wait for the work
        already queued, and the host would stop running ahead."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device(self, batch: ExperienceBatch) -> ExperienceBatch:
        return ExperienceBatch(
            *(torch.as_tensor(a, device=self.device) for a in batch[:-1]),
            batch.indices,
        )

    # ------------------------------------------------------------------

    def _build_source_pool(self) -> np.ndarray:
        """[K, H, W, 2] candidate training sources. Index 0 is the fixed
        training source (hybridnet.py:145-156); when p_random_source > 0 the
        distinct integer circle locations of the validation protocol
        (hybridnet.py:178-190) fill the next indices; when
        p_extended_source > 0 a seeded pool of random line segments follows
        (the JAX package's far-OOD curriculum)."""
        s = self.cfg.source
        maps = [self.source_map]
        if self.cfg.training.p_random_source > 0:
            for loc in self._circle_locations():
                maps.append(
                    point_source_map(
                        self.height, self.width, loc, s.amplitude,
                        s.phase, s.omega, 0.0, s.smoothing,
                    )
                )
        self._n_point_sources = len(maps)
        if self.cfg.training.p_extended_source > 0:
            seg_rng = np.random.default_rng(4242)
            for _ in range(256):
                p0, p1 = self.random_line_endpoints(seg_rng)
                maps.append(
                    line_source_map(
                        self.height, self.width, p0, p1, s.amplitude,
                        s.phase, s.omega, 0.0, s.smoothing,
                    )
                )
        return np.stack(maps).astype(np.float32)

    def _circle_locations(self) -> list:
        """Distinct integer circle locations of the validation protocol
        (hybridnet.py:178-190) used as the random-source curriculum pool."""
        L = self.height // 2
        dL = L - self.cfg.geometry.pml_size - 2
        locs = {
            (int(L + dL * np.cos(t)), int(L + dL * np.sin(t)))
            for t in np.linspace(0, 2 * np.pi, 720, endpoint=False)
        }
        return sorted(locs)

    def _build_source_locs(self) -> np.ndarray:
        """[K, 2] int32 point-source locations (the sparse pool): index 0 is
        the fixed training source, the rest the circle curriculum."""
        locs = [tuple(self.cfg.source.location)]
        if self.cfg.training.p_random_source > 0:
            locs.extend(self._circle_locations())
        self._n_point_sources = len(locs)
        return np.asarray(locs, np.int32)

    def random_line_endpoints(self, rng=None):
        """Endpoints of a random interior segment: center anywhere outside
        the PML, random orientation, length uniform in [n/8, n/2]."""
        rng = rng if rng is not None else self.rng
        n = min(self.height, self.width)
        margin = self.cfg.geometry.pml_size + 4
        length = rng.uniform(n / 8, n / 2)
        theta = rng.uniform(0, np.pi)
        dr = 0.5 * length * np.sin(theta)
        dc = 0.5 * length * np.cos(theta)
        cr = rng.uniform(margin + abs(dr), self.height - margin - abs(dr))
        cc = rng.uniform(margin + abs(dc), self.width - margin - abs(dc))
        p0 = (int(round(cr - dr)), int(round(cc - dc)))
        p1 = (int(round(cr + dr)), int(round(cc + dc)))
        return p0, p1

    def _sample_src_idx(self, n: int) -> np.ndarray:
        """Per-slot source-pool indices: extended segment with probability
        p_extended_source, else a random circle source with probability
        p_random_source, else the fixed training source."""
        p_rand = self.cfg.training.p_random_source
        p_ext = self.cfg.training.p_extended_source
        k = self.src_pool.shape[0]
        if (p_rand <= 0 and p_ext <= 0) or k == 1:
            return np.zeros(n, np.int64)
        n_pt = self._n_point_sources
        idx = np.zeros(n, np.int64)
        u = self.rng.random(n)
        if p_ext > 0 and k > n_pt:
            ext = u < p_ext
            idx[ext] = self.rng.integers(n_pt, k, size=int(ext.sum()))
        else:
            ext = np.zeros(n, bool)
        if p_rand > 0 and n_pt > 1:
            circ = (~ext) & (u < p_ext + p_rand)
            idx[circ] = self.rng.integers(1, n_pt, size=int(circ.sum()))
        return idx

    def fill_buffer(self, sos_maps: np.ndarray):
        """Seed all slots with fresh problems; slot i gets starting age 10*i
        (hybridnet.py:199-218) so curriculum ages are spread out."""
        cap = self.capacity
        src_idx = self._sample_src_idx(cap)
        maps = sos_maps[np.arange(cap) % len(sos_maps)]
        if self.device_buffer:
            dev = self.device
            self._sos_pool = torch.as_tensor(sos_maps, dtype=torch.float32, device=dev)
            self._dev_buf = self._init_dev_buffer(
                self.op, self.src_pool, torch.as_tensor(src_idx, device=dev),
                torch.as_tensor(maps, dtype=torch.float32, device=dev),
                torch.arange(cap, dtype=torch.int32, device=dev) * 10,
            )
            return
        chunk = 64
        for start in range(0, cap, chunk):
            sl = slice(start, min(start + chunk, cap))
            src = self._src_pool_host[src_idx[sl]]
            exp = self._init_experiences(src, maps[sl])
            self.buffer.append_batch(
                np.arange(sl.start, sl.stop),
                exp["wavefield"],
                exp["states"],
                exp["k_sq"],
                exp["residual"],
                src,
                np.arange(sl.start, sl.stop) * 10,
            )

    def max_allowed_iterations(self) -> int:
        t = self.cfg.training
        return min(self.epoch * t.curriculum_slope + 1, self.cfg.max_iterations)

    def training_epoch(self, train_maps: np.ndarray) -> dict:
        """One pass over the sos dataset (batch count = len/batch_size)."""
        if self.device_buffer:
            return self._training_epoch_device(train_maps)
        t = self.cfg.training
        bs = t.train_batch_size
        maxiter = self.max_allowed_iterations()
        num_batches = max(len(train_maps) // bs, 1)
        order = self.rng.permutation(len(train_maps))
        losses, grad_norms, restarts = [], [], 0
        tic = time.time()
        for b in range(num_batches):
            sos_batch = train_maps[order[b * bs : (b + 1) * bs]]
            batch = self.buffer.sample(bs)
            pick = int(self.rng.integers(t.unrolling_steps))
            metrics, evolved = self._train_step(self._to_device(batch), pick)
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            evolved = {k: v.cpu().numpy() for k, v in evolved.items()}

            # ---- buffer write-back (hybridnet.py:427-464) ----
            new_t = batch.iteration + pick + 1
            keep = (evolved["res_sq_mean"] < 1.0) & (new_t < maxiter)
            fresh_sos = sos_batch[self.rng.integers(len(sos_batch), size=bs)]
            fresh_src = self._src_pool_host[self._sample_src_idx(bs)]
            fresh = self._init_experiences(fresh_src, fresh_sos)
            k = keep[:, None, None, None]
            k3 = keep[:, None, None]
            self.buffer.append_batch(
                batch.indices,
                np.where(k, evolved["wavefield"], fresh["wavefield"]),
                np.where(k3, evolved["states"], fresh["states"]),
                np.where(k3, batch.k_sq, fresh["k_sq"]),
                np.where(k, evolved["residual"], fresh["residual"]),
                np.where(k, batch.source, fresh_src),
                np.where(keep, new_t, 0),
            )
            restarts += int((~keep).sum())
            self.global_step += 1

        return self._finish_epoch(losses, grad_norms, restarts, maxiter, tic)

    def _finish_epoch(self, losses, grad_norms, restarts, maxiter, tic) -> dict:
        """Shared epoch-end bookkeeping: nan guard, plateau LR, logging.
        Besides the JAX package's keys, the stats hold the epoch's mean raw
        grad norm (non-finite if any step's was)."""
        epoch_loss = float(np.mean(losses))
        if self.terminate_on_nan and not np.isfinite(epoch_loss):
            raise FloatingPointError(
                f"non-finite training loss at epoch {self.epoch}: {losses}"
            )
        lr = self.scheduler.step(epoch_loss)
        set_learning_rate(self.optimizer, lr)
        stats = {
            "epoch": self.epoch,
            "train_loss_mean": epoch_loss,
            "maxiter": maxiter,
            "new_sos": restarts,
            "grad_norm_mean": float(np.mean(grad_norms)),
            "lr": lr,
            "epoch_time_s": time.time() - tic,
            "global_step": self.global_step,
        }
        self._log(stats)
        if self._tb is not None:
            for k in ("train_loss_mean", "maxiter", "new_sos", "lr"):
                self._tb.add_scalar(f"train/{k}", stats[k], self.global_step)
        self.epoch += 1
        return stats

    def device_step(self, maxiter: int) -> dict:
        """One device-buffer train step: the host draws the slots, the fresh
        maps and sources and the kept step (in the JAX package's order);
        everything else runs on the device. Returns device scalars."""
        t = self.cfg.training
        bs = t.train_batch_size
        slot_idx = self._upload(self.rng.choice(self.capacity, bs, replace=False))
        fresh_idx = self._upload(self.rng.integers(len(self._sos_pool), size=bs))
        fresh_src_idx = self._upload(self._sample_src_idx(bs))
        pick = int(self.rng.integers(t.unrolling_steps))
        metrics = self._mega_step(
            self._dev_buf, self.op, self.src_pool, self._sos_pool, slot_idx,
            fresh_idx, fresh_src_idx, pick, maxiter,
        )
        self.global_step += 1
        return metrics

    def _training_epoch_device(self, train_maps: np.ndarray) -> dict:
        """Device-buffer epoch: host contributes RNG integers only."""
        bs = self.cfg.training.train_batch_size
        maxiter = self.max_allowed_iterations()
        num_batches = max(len(train_maps) // bs, 1)
        tic = time.time()
        # device scalars, fetched once at epoch end
        step_metrics = [self.device_step(maxiter) for _ in range(num_batches)]
        losses = torch.stack([m["loss"] for m in step_metrics]).tolist()
        grad_norms = torch.stack([m["grad_norm"] for m in step_metrics]).tolist()
        restarts = int(sum(m["restarts"] for m in step_metrics))
        return self._finish_epoch(losses, grad_norms, restarts, maxiter, tic)

    # ------------------------------------------------------------------

    def random_circle_location(self) -> tuple[int, int]:
        """Random source on a circle (hybridnet.py:178-190)."""
        theta = 2 * np.pi * self.rng.random()
        L = self.height // 2
        dL = L - self.cfg.geometry.pml_size - 2
        return (int(L + dL * np.cos(theta)), int(L + dL * np.sin(theta)))

    def make_val_sources(
        self, n: int, seed: int = 1234, extended_frac: float = 0.0
    ) -> np.ndarray:
        """Fixed random-circle validation sources [n, H, W, 2]: a dedicated
        seed keeps the set identical across epochs so in-run top-k selection
        compares checkpoints on the same problems (eval protocol parity).
        `extended_frac` > 0 replaces that fraction (the first entries) with
        seeded random line segments."""
        s = self.cfg.source
        rng = np.random.default_rng(seed)
        L = self.height // 2
        dL = L - self.cfg.geometry.pml_size - 2
        n_ext = int(round(n * extended_frac))
        out = []
        for _ in range(n_ext):
            p0, p1 = self.random_line_endpoints(rng)
            out.append(
                line_source_map(
                    self.height, self.width, p0, p1, s.amplitude, s.phase,
                    s.omega, 0.0, s.smoothing,
                )
            )
        for _ in range(n - n_ext):
            th = 2 * np.pi * rng.random()
            loc = (int(L + dL * np.cos(th)), int(L + dL * np.sin(th)))
            out.append(
                point_source_map(
                    self.height, self.width, loc, s.amplitude, s.phase,
                    s.omega, 0.0, s.smoothing,
                )
            )
        return np.stack(out).astype(np.float32)

    def validate(
        self, val_maps: np.ndarray, num_iterations=None, batch=8, sources=None
    ) -> dict:
        """Full rollouts (the port's `rollout`, no autograd) from random
        circle sources; terminal residual RMSE (hybridnet.py:333-376). Pass
        `sources` [N, H, W, 2] for a fixed validation set (comparable
        val_loss across epochs)."""
        s = self.cfg.source
        iters = num_iterations or self.cfg.max_iterations
        rmses = []
        first_wavefields = None  # decimated trajectory for TB images
        for start in range(0, len(val_maps), batch):
            maps = val_maps[start : start + batch]
            if sources is not None:
                src = np.asarray(sources[start : start + batch])
            else:
                locs = [self.random_circle_location() for _ in range(len(maps))]
                src = np.stack([
                    point_source_map(
                        self.height, self.width, loc, s.amplitude, s.phase,
                        s.omega, 0.0, s.smoothing,
                    )
                    for loc in locs
                ])
            # the first batch also collects a decimated wavefield trajectory
            # for TB (the reference's val/20-step/terminal images,
            # hybridnet.py:416-424, 507-520)
            want_traj = (
                self._tb is not None and start == 0
                and iters % 20 == 0 and iters >= 20
            )
            out = rollout(
                self.params, self.op, src, maps, cfg=self.cfg,
                num_iterations=iters,
                collect=("rmse", "wavefields") if want_traj else ("rmse",),
                decimate=20 if want_traj else 1,
                device=self.device,
            )
            if want_traj:
                first_wavefields = out["wavefields"][:, 0].cpu().numpy()
            final = out["rmse"][-1].cpu().numpy()
            rmses.append(np.where(np.isnan(final), np.inf, final))
        finals = np.concatenate(rmses)
        val_loss = float(np.mean(finals))
        val_median = float(np.median(finals))
        self._log({"epoch": self.epoch, "val_loss": val_loss})
        if self._tb is not None:
            self._tb.add_scalar("val/val_loss", val_loss, self.global_step)

            # wavefield images (reference log_wavefield, hybridnet.py:507-520)
            def log_img(tag, wf):
                img = (np.clip(wf, -1, 1) + 1) / 2
                self._tb.add_image(f"{tag}_real", img[None, :, :, 0],
                                   self.global_step)
                self._tb.add_image(f"{tag}_imag", img[None, :, :, 1],
                                   self.global_step)

            if first_wavefields is not None:
                log_img("wavefield/val_20step", first_wavefields[0])
                log_img("wavefield/val_terminal", first_wavefields[-1])
            else:
                log_img("wavefield/val", out["wavefield"][0].cpu().numpy())
        # the median is robust to the early-training long-rollout
        # divergence that dominates the mean
        return {"val_loss": val_loss, "val_median": val_median}

    def _log(self, record: dict):
        if self._log_file:
            self._log_file.write(json.dumps(record) + "\n")
            self._log_file.flush()

    # ------------------------------------------------------------------

    def _train_state(self):
        return {
            "params": map_leaves(self.params, lambda _, t: t.detach()),
            "opt_state": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "global_step": self.global_step,
        }

    def _scheduler_state(self) -> dict:
        s = self.scheduler
        return {"lr": s.lr, "best": s.best, "bad_epochs": s.bad_epochs}

    def save(self, directory: str):
        """Write a checkpoint (on the primary rank; every rank waits)."""
        from .checkpoint import save_checkpoint

        if multihost.is_primary():
            save_checkpoint(directory, self.epoch, self._train_state())
        multihost.barrier("save")

    def save_topk(self, directory: str, val_loss: float, k: int = 3):
        """ModelCheckpoint(save_top_k=k on val_loss, save_last) semantics
        (reference train.py:90-97): keep the k best validation checkpoints
        plus the latest; prune the rest; persist LR-scheduler state."""
        from .checkpoint import update_topk

        if multihost.is_primary():
            update_topk(
                directory, self.epoch, val_loss, self._train_state(), k=k,
                extra=self._scheduler_state(),
            )
        multihost.barrier("save_topk")

    def restore(self, directory: str, best: bool = False) -> bool:
        """Resume from the latest checkpoint in `directory` (the reference's
        resume-from-last.ckpt story, README.md:31); `best=True` restores the
        lowest-val_loss checkpoint instead (Lightning's best-model restore
        for eval)."""
        from .checkpoint import (
            best_step,
            latest_step,
            manifest_extra,
            restore_checkpoint,
        )

        step = best_step(directory) if best else latest_step(directory)
        if step is None:
            return False
        state = restore_checkpoint(directory, step, device=self.device)
        saved = dict(iter_leaves(state["params"]))
        with torch.no_grad():
            for path, leaf in iter_leaves(self.params):
                leaf.copy_(saved[path])
        self.optimizer.load_state_dict(state["opt_state"])
        self.epoch = int(state["epoch"])
        self.global_step = int(state["global_step"])
        sched = manifest_extra(directory, step)
        if sched:
            self.scheduler.lr = float(sched["lr"])
            self.scheduler.best = float(sched["best"])
            self.scheduler.bad_epochs = int(sched["bad_epochs"])
        return True

    def fit(
        self,
        train_maps: np.ndarray,
        val_maps: Optional[np.ndarray] = None,
        num_epochs: int = 1,
        val_every: int = 2,
        val_iterations: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        top_k: int = 3,
    ):
        """Reference Trainer.fit analog: train epochs, validate every
        `val_every` epochs on a FIXED random-circle source set, and keep the
        `top_k` best checkpoints by val_loss plus the last one
        (ModelCheckpoint semantics, train.py:90-97)."""
        if ckpt_dir:
            self.restore(ckpt_dir)
        if self.device_buffer:
            if self._dev_buf is None:
                self.fill_buffer(train_maps)
        elif not np.any(self.buffer.k_sq):
            self.fill_buffer(train_maps)
        val_sources = (
            self.make_val_sources(len(val_maps)) if val_maps is not None else None
        )
        history = []
        for _ in range(num_epochs):
            stats = self.training_epoch(train_maps)
            if val_maps is not None and self.epoch % val_every == 0:
                stats.update(
                    self.validate(val_maps, val_iterations, sources=val_sources)
                )
                if ckpt_dir:
                    self.save_topk(ckpt_dir, stats["val_loss"], k=top_k)
            elif ckpt_dir:
                self.save_topk(ckpt_dir, float("inf"), k=top_k)
            history.append(stats)
        return history

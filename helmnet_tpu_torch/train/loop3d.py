"""Unsupervised physics-residual training on 3D volumes, port of
`helmnet_tpu/train/loop3d.py`.

`Trainer3D` carries the 2D scheme (train/loop.py) to volumes with the
device-resident buffer as its only path, as the JAX package does:

* the replay buffer and the sos dataset are tensors on the trainer's
  device; one mega-step gathers a batch, unrolls `unrolling_steps`
  learned updates under autograd (`solvers/iterative3d.n_steps3d`, with
  `remat` per step), steps Adam, applies the re-admission gate (mean
  res^2 < 1 and age < the curriculum's maxiter), restarts the other slots
  fresh and writes back with `index_copy_` (train/device_buffer.py's
  semantics); the host contributes the RNG integers in the JAX package's
  draw order and reads the scalar metrics once an epoch;
* loss = loss_amplify * mean(residual^2) over the unrolled steps;
* Adam with L2 after the value clip, and the plateau scheduler: the 2D
  trainer's (`loop.make_optimizer`, `apply_gradients`, `PlateauScheduler`);
* checkpoints: params npz files in the JAX package's layout
  (`checkpoint.save_params_npz`, read by JAX's `load_params3d_npz`) with a
  top-k manifest, and a resume state `state3d.pt` (params, Adam state,
  epoch and scheduler).

Source pool: index 0 is the fixed training point source at
(n - pml - 4, n/2, n/2); with p_random_source > 0, `n_random_sources`
random interior point sources from a seed-42 generator follow.
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
from ..models import hybridnet3d
from ..models.hybridnet import iter_leaves, map_leaves
from ..ops.spectral3d import (
    SpectralPML3D,
    helmholtz_residual3d,
    make_operator3d,
    point_source_map3d,
)
from ..solvers.iterative3d import (
    SolverCarry3D,
    get_initials3d,
    n_steps3d,
    rollout3d,
    with_3d_channels,
)
from .checkpoint import save_params_npz
from .loop import PlateauScheduler, apply_gradients, make_optimizer, set_learning_rate

FIELDS = ("wavefield", "states", "k_sq", "residual", "source", "iteration")
STATE_FILE = "state3d.pt"


@torch.no_grad()
def fresh_experiences3d(op: SpectralPML3D, source: torch.Tensor,
                        sos_maps: torch.Tensor, cfg: Config) -> dict:
    """Iteration-0 experiences for sos volumes [B, D, H, W] on their device:
    zero wavefield and states, k^2 and the residual of the zero field."""
    k_sq, wavefield = get_initials3d(sos_maps, cfg.source.omega)
    states = hybridnet3d.init_states(sos_maps.shape[0], tuple(sos_maps.shape[1:4]),
                                     cfg.model, sos_maps.dtype, device=sos_maps.device)
    residual = helmholtz_residual3d(op, wavefield, k_sq, source, cfg.operator_mode)
    return {"wavefield": wavefield, "states": hybridnet3d.flatten_states(states),
            "k_sq": k_sq, "residual": residual}


class Trainer3D:
    """Owns params, Adam state and the device-resident replay buffer; runs
    epochs of mega-steps."""

    def __init__(
        self,
        cfg: Config,
        params=None,
        generator: Optional[torch.Generator] = None,
        log_dir: Optional[str] = None,
        n_random_sources: int = 32,
        device=None,
    ):
        """`params`: the port's HybridNet3D params (copied; defaults to a
        seeded init). Entry point: runs on `cuda` unless `device` says
        otherwise."""
        cfg = with_3d_channels(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            params = hybridnet3d.init_params(gen, cfg.model)
        self.params = map_leaves(params, lambda _, t: t.detach().to(
            self.device, torch.float32).clone().requires_grad_(True))
        g = cfg.geometry
        n = g.domain_size
        self.depth = self.height = self.width = n
        self.op = make_operator3d(n, n, n, g.pml_size, g.sigma_max, cfg.k0,
                                  device=self.device)
        self.src_pool = torch.as_tensor(self._build_source_pool(n_random_sources),
                                        device=self.device)
        self.optimizer = make_optimizer(cfg, self.params)
        t = cfg.training
        self.capacity = t.buffer_size
        self.rng = np.random.default_rng(0)
        self.scheduler = PlateauScheduler(t.learning_rate, t.plateau_factor,
                                          t.plateau_patience, t.minimum_learning_rate)
        self.epoch = 0
        self.global_step = 0
        self.log_dir = log_dir
        self._log_file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._log_file = open(os.path.join(log_dir, "train3d_log.jsonl"), "a")
        self._buf = None
        self._sos_pool = None

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    # ------------------------------------------------------------------

    def _build_source_pool(self, n_random: int) -> np.ndarray:
        """[K, D, H, W, 2] candidate sources; index 0 is the fixed training
        source."""
        s = self.cfg.source
        n = self.depth
        pml = self.cfg.geometry.pml_size
        fixed_loc = (n - pml - 4, n // 2, n // 2)
        pool = [point_source_map3d(n, n, n, fixed_loc, s.amplitude, s.phase, s.omega)]
        if self.cfg.training.p_random_source > 0:
            rng = np.random.default_rng(42)
            margin = min(pml + 4, (n - 2) // 2)  # tiny-domain safe
            lo, hi = margin, max(n - margin, margin + 1)
            for _ in range(n_random):
                loc = tuple(int(v) for v in rng.integers(lo, hi, size=3))
                pool.append(point_source_map3d(n, n, n, loc, s.amplitude, s.phase,
                                               s.omega))
        return np.stack(pool)

    def _sample_src_idx(self, m: int) -> np.ndarray:
        p = self.cfg.training.p_random_source
        k = self.src_pool.shape[0]
        if p <= 0 or k == 1:
            return np.zeros(m, np.int64)
        idx = np.zeros(m, np.int64)
        rand = self.rng.random(m) < p
        idx[rand] = self.rng.integers(1, k, size=int(rand.sum()))
        return idx

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def unrolled_loss(self, batch: dict):
        """loss_amplify * mean(residual^2) over the unrolled steps from a
        gathered batch (the buffer's fields), with autograd on; (loss, ys)."""
        t = self.cfg.training
        carry = SolverCarry3D(
            batch["wavefield"], batch["residual"],
            hybridnet3d.unflatten_states(batch["states"],
                                         tuple(batch["wavefield"].shape[1:4]),
                                         self.cfg.model))
        _, ys = n_steps3d(self.params, self.op, batch["source"], batch["k_sq"], carry,
                          cfg=self.cfg, num_steps=t.unrolling_steps, remat=t.remat)
        return t.loss_amplify * torch.mean(ys["residuals"] ** 2), ys

    def mega_step(self, slot_idx: torch.Tensor, fresh_idx: torch.Tensor,
                  fresh_src_idx: torch.Tensor, pick: int, maxiter: int) -> dict:
        """One train step on the buffer slots `slot_idx` (int64 [B] on the
        device): gather, BPTT loss, Adam, then the gate and the write-back
        of step `pick`'s experiences, restarted slots taking
        sos_pool[fresh_idx] and src_pool[fresh_src_idx]. Returns the
        step's metrics as device scalars."""
        # advanced indexing copies: the batch never aliases the buffer
        batch = {k: self._buf[k][slot_idx] for k in FIELDS}
        self.optimizer.zero_grad(set_to_none=True)
        loss, ys = self.unrolled_loss(batch)
        loss.backward()
        grad_norm = apply_gradients(self.optimizer, self.cfg.training.gradient_clip)
        with torch.no_grad():
            ev_wf = ys["wavefields"][pick].detach()
            ev_states = ys["states"][pick].detach()
            ev_res = ys["residuals"][pick].detach()
            new_age = batch["iteration"] + (pick + 1)
            keep = (torch.mean(ev_res**2, dim=(1, 2, 3, 4)) < 1.0) & (new_age < maxiter)
            fresh_src = self.src_pool[fresh_src_idx]
            fresh = fresh_experiences3d(self.op, fresh_src, self._sos_pool[fresh_idx],
                                        self.cfg)
            k5 = keep[:, None, None, None, None]
            k4 = keep[:, None, None, None]
            k3 = keep[:, None, None]
            rows = {
                "wavefield": torch.where(k5, ev_wf, fresh["wavefield"]),
                "states": torch.where(k3, ev_states, fresh["states"]),
                "k_sq": torch.where(k4, batch["k_sq"], fresh["k_sq"]),
                "residual": torch.where(k5, ev_res, fresh["residual"]),
                "source": torch.where(k5, batch["source"], fresh_src),
                "iteration": torch.where(keep, new_age, torch.zeros_like(new_age)),
            }
            for key, value in rows.items():
                self._buf[key].index_copy_(0, slot_idx, value)
            res = ys["residuals"].detach()
            return {
                "loss": loss.detach(),
                "rel_loss": torch.mean(torch.sqrt(torch.mean(res**2, dim=(2, 3, 4, 5)))),
                "grad_norm": grad_norm,
                "restarts": (~keep).sum(),
            }

    # ------------------------------------------------------------------

    def fill_buffer(self, sos_maps: np.ndarray) -> None:
        """Seed all slots; slot i gets starting age 10*i so curriculum ages
        are spread out (hybridnet.py:199-218)."""
        cap = self.capacity
        self._sos_pool = torch.as_tensor(np.asarray(sos_maps), dtype=torch.float32,
                                         device=self.device)
        maps = self._sos_pool[torch.arange(cap, device=self.device) % len(sos_maps)]
        src = self.src_pool[self._index(self._sample_src_idx(cap))]
        self._buf = fresh_experiences3d(self.op, src, maps, self.cfg)
        self._buf["source"] = src
        self._buf["iteration"] = torch.arange(cap, dtype=torch.int32,
                                              device=self.device) * 10

    def max_allowed_iterations(self) -> int:
        t = self.cfg.training
        return min(self.epoch * t.curriculum_slope + 1, self.cfg.max_iterations)

    def device_step(self, maxiter: int) -> dict:
        """One mega-step on the host's draws, in the JAX package's order:
        the slots, the fresh maps, the fresh sources, the kept step."""
        t = self.cfg.training
        bs = min(t.train_batch_size, self.capacity)
        slot_idx = self._index(self.rng.choice(self.capacity, bs, replace=False))
        fresh_idx = self._index(self.rng.integers(len(self._sos_pool), size=bs))
        fresh_src_idx = self._index(self._sample_src_idx(bs))
        pick = int(self.rng.integers(t.unrolling_steps))
        metrics = self.mega_step(slot_idx, fresh_idx, fresh_src_idx, pick, maxiter)
        self.global_step += 1
        return metrics

    def training_epoch(self, n_batches: Optional[int] = None) -> dict:
        """`n_batches` mega-steps (default: the sos pool over the batch
        size); the plateau scheduler steps on the epoch's mean loss, and a
        non-finite one raises FloatingPointError. Besides the JAX package's
        keys, the stats hold the epoch's mean raw grad norm."""
        bs = min(self.cfg.training.train_batch_size, self.capacity)
        maxiter = self.max_allowed_iterations()
        num_batches = n_batches or max(len(self._sos_pool) // bs, 1)
        tic = time.time()
        metrics = [self.device_step(maxiter) for _ in range(num_batches)]
        losses = torch.stack([m["loss"] for m in metrics]).tolist()
        grad_norms = torch.stack([m["grad_norm"] for m in metrics]).tolist()
        epoch_loss = float(np.mean(losses))
        if not np.isfinite(epoch_loss):
            raise FloatingPointError(f"non-finite 3D training loss at epoch {self.epoch}")
        lr = self.scheduler.step(epoch_loss)
        set_learning_rate(self.optimizer, lr)
        stats = {
            "epoch": self.epoch,
            "train_loss_mean": epoch_loss,
            "maxiter": maxiter,
            "new_sos": int(torch.stack([m["restarts"] for m in metrics]).sum()),
            "grad_norm_mean": float(np.mean(grad_norms)),
            "lr": lr,
            "epoch_time_s": time.time() - tic,
            "global_step": self.global_step,
        }
        self._log(stats)
        self.epoch += 1
        return stats

    def _log(self, record: dict) -> None:
        if self._log_file is not None:
            self._log_file.write(json.dumps(record) + "\n")
            self._log_file.flush()

    # ------------------------------------------------------------------

    def validate(self, val_maps: np.ndarray, num_iterations: Optional[int] = None,
                 batch_size: int = 4, random_sources: bool = True) -> dict:
        """Median and p90 of the best residual RMSE within `num_iterations`
        over held-out volumes; with `random_sources` sample i takes pool
        source 1 + i mod (K - 1)."""
        iters = num_iterations or self.cfg.max_iterations
        n_src = self.src_pool.shape[0]
        rmses = []
        for start in range(0, len(val_maps), batch_size):
            sos = np.asarray(val_maps[start : start + batch_size])
            b = sos.shape[0]
            if random_sources and n_src > 1:
                idx = 1 + (np.arange(start, start + b) % (n_src - 1))
            else:
                idx = np.zeros(b, np.int64)
            out = rollout3d(self.params, self.op, self.src_pool[self._index(idx)], sos,
                            cfg=self.cfg, num_iterations=iters,
                            collect=("rmse", "best"), device=self.device)
            rmses.extend(out["best_rmse"].cpu().numpy().tolist())
        arr = np.asarray(rmses)
        return {"val_median": float(np.median(arr)),
                "val_p90": float(np.percentile(arr, 90)), "val_n": len(arr)}

    # ------------------------------------------------------------------

    def save(self, directory: str, tag: str = "last") -> str:
        """`params3d_<tag>.npz` in the JAX package's layout."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"params3d_{tag}.npz")
        save_params_npz(path, self.params)
        return path

    def save_topk(self, directory: str, val_loss: float, k: int = 3) -> None:
        """Keep the k best-val param files and the last one
        (ModelCheckpoint semantics) in `manifest3d.json`."""
        os.makedirs(directory, exist_ok=True)
        mpath = os.path.join(directory, "manifest3d.json")
        manifest = {"top": []}
        if os.path.exists(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        self.save(directory, "last")
        top = manifest["top"]
        top.append({"epoch": self.epoch, "val": val_loss})
        top.sort(key=lambda e: e["val"])
        for drop in top[k:]:
            p = os.path.join(directory, f"params3d_ep{drop['epoch']}.npz")
            if os.path.exists(p):
                os.remove(p)
        manifest["top"] = top[:k]
        if any(e["epoch"] == self.epoch for e in manifest["top"]):
            self.save(directory, f"ep{self.epoch}")
        with open(mpath, "w") as f:
            json.dump(manifest, f)

    def save_state(self, directory: str) -> str:
        """The full resume state (params, Adam state, epoch, step and
        scheduler) as `state3d.pt`, written atomically."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, STATE_FILE)
        s = self.scheduler
        state = {
            "params": map_leaves(self.params, lambda _, t: t.detach()),
            "opt_state": self.optimizer.state_dict(),
            "meta": {"epoch": self.epoch, "global_step": self.global_step,
                     "lr": s.lr, "best": s.best, "bad_epochs": s.bad_epochs},
        }
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def _set_params(self, params) -> None:
        saved = dict(iter_leaves(params))
        with torch.no_grad():
            for path, leaf in iter_leaves(self.params):
                leaf.copy_(saved[path])

    def restore(self, directory: str) -> bool:
        """Resume from `save_state`; False when absent. The replay buffer is
        not saved (it is rebuilt by `fill_buffer`), and the host RNG is
        re-seeded from the restored step so that a resumed run does not
        replay the first epochs' draws."""
        path = os.path.join(directory, STATE_FILE)
        if not os.path.exists(path):
            return False
        state = torch.load(path, map_location=self.device, weights_only=True)
        self._set_params(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        meta = state["meta"]
        self.epoch = int(meta["epoch"])
        self.global_step = int(meta["global_step"])
        self.scheduler.lr = float(meta["lr"])
        self.scheduler.best = float(meta["best"])
        self.scheduler.bad_epochs = int(meta["bad_epochs"])
        self.rng = np.random.default_rng(self.global_step + 1)
        return True

    def restore_best(self, directory: str) -> bool:
        """Load the manifest's best params file into the trainer's params."""
        from ..weights import load_params3d_npz

        mpath = os.path.join(directory, "manifest3d.json")
        if not os.path.exists(mpath):
            return False
        with open(mpath) as f:
            top = json.load(f)["top"]
        if not top:
            return False
        path = os.path.join(directory, f"params3d_ep{top[0]['epoch']}.npz")
        if not os.path.exists(path):
            return False
        self._set_params(load_params3d_npz(path, self.cfg, device=self.device))
        return True

    # ------------------------------------------------------------------

    def fit(
        self,
        train_maps: np.ndarray,
        val_maps: Optional[np.ndarray] = None,
        epochs: Optional[int] = None,
        ckpt_dir: Optional[str] = None,
        val_every: int = 10,
        val_iterations: Optional[int] = None,
        top_k: int = 3,
        n_batches: Optional[int] = None,
    ) -> list[dict]:
        if self._buf is None:
            self.fill_buffer(train_maps)
        history = []
        for _ in range(epochs or self.cfg.training.max_epochs):
            stats = self.training_epoch(n_batches)
            if val_maps is not None and val_every and self.epoch % val_every == 0:
                v = self.validate(val_maps, val_iterations or self.max_allowed_iterations())
                stats.update(v)
                if ckpt_dir:
                    self.save_topk(ckpt_dir, v["val_median"], top_k)
                self._log(v)
            elif ckpt_dir:
                self.save(ckpt_dir, "last")
            history.append(stats)
        return history

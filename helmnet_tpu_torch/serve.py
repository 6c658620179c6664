"""Serving layer: shape-bucketed, micro-batched learned solves, port of
`helmnet_tpu/serve.py`.

One worker thread owns the solver and the card; `submit` only validates
and enqueues. Requests are bucketed by (grid shape, iterations rounded up
to a multiple of the chunk), coalesced for up to `batch_window_s`, and
every batch runs at the one batch size `max_batch`: an under-full batch
is padded with copies of sample 0, as the JAX service does. There the
pinned shape reuses one compiled executable per bucket; eager PyTorch
compiles nothing, so here the padding only buys a fixed shape per bucket
(what CUDA graphs per bucket would need), and costs device work when
occupancy is low: a lone request runs `max_batch` samples. Slots are
independent, so the padding changes no request's result beyond rounding.

The worker runs on the default stream of the solver's device, its
results are copied to the host (numpy) before a future resolves, and
every failure of a batch, a kernel's included, is set on each of its
futures. Nothing falls back to another device or path.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .solvers.auto import choose_solver
from .solvers.iterative import IterativeSolver, load_solver


@dataclass
class ServeConfig:
    """Service knobs.

    max_batch: the batch size every solve runs at, per grid-size bucket.
    chunk_iterations: the rollout chunk; requested iterations round UP to
        a multiple of it.
    batch_window_s: how long the worker waits to coalesce more same-bucket
        requests after the first one arrives (micro-batching window).
    default_iterations: used when a request does not specify iterations.
    """

    max_batch: int = 8
    chunk_iterations: int = 100
    batch_window_s: float = 0.005
    default_iterations: int = 500
    max_queue: int = 1024


@dataclass
class _Request:
    sos: np.ndarray                       # [H, W]
    source_map: Optional[np.ndarray]      # [H, W, 2] or None
    source_location: Optional[tuple]      # (y, x) or None
    iterations: int                       # already rounded to chunk multiple
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SolverService:
    """Micro-batching inference service over one `IterativeSolver`.

    >>> service = SolverService.from_checkpoint("trained_models/tpu_r2c_best.npz")
    >>> service.warmup([(96, 96)])
    >>> fut = service.submit(sos_map, source_location=(80, 48))
    >>> out = fut.result(timeout=60)        # wavefield, rmse, best_rmse, ...
    """

    def __init__(self, solver: IterativeSolver, config: ServeConfig = None):
        self.solver = solver
        self.config = config or ServeConfig()
        # set_domain_size rewrites cfg.geometry in place: pin the training
        # geometry now so default source locations keep scaling correctly
        self._base_size = solver.cfg.geometry.domain_size
        self._base_loc = tuple(solver.cfg.source.location)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self.config.max_queue
        )
        self._stats = {
            "requests": 0,
            "completed": 0,
            "failed": 0,
            "batches": 0,
            "padded_slots": 0,
            "batched_slots": 0,
            "by_size": {},
        }
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="helmnet-serve", daemon=True
        )
        self._worker.start()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, config: ServeConfig = None, *,
                        device=None) -> "SolverService":
        """Service over the weights at `path` (`solvers/iterative.load_solver`):
        an orbax run directory at its best step or a flat params `.npz`,
        both with the default config, or a reference `.ckpt` with its own.
        Runs on `device`, by default the card (raises without one)."""
        return cls(load_solver(path, device=device), config)

    # -- client API ----------------------------------------------------------

    def submit(
        self,
        sos_map,
        source_location: Optional[Sequence[int]] = None,
        source_map=None,
        iterations: Optional[int] = None,
    ) -> Future:
        """Enqueue one solve; returns a Future resolving to the result dict.

        sos_map: [H, W] sound-speed map (1.0 = background). H and W must be
        divisible by 2^depth (the UNet stride), validated here so bad
        requests fail fast in the caller's thread, not the worker's.
        """
        if self._stop.is_set():
            raise RuntimeError("service is shut down")
        sos = np.asarray(sos_map, np.float32)
        if sos.ndim != 2:
            raise ValueError(f"sos_map must be [H, W], got {sos.shape}")
        stride = 2 ** self.solver.cfg.model.depth
        h, w = sos.shape
        if h % stride or w % stride:
            raise ValueError(
                f"grid {h}x{w} must be divisible by 2^depth = {stride}"
            )
        if source_map is not None:
            source_map = np.asarray(source_map, np.float32)
            if source_map.shape[:2] != (h, w):
                raise ValueError(
                    f"source_map {source_map.shape} does not match sos "
                    f"{sos.shape}"
                )
            if source_map.ndim == 2:  # real-only convenience
                source_map = np.stack(
                    [source_map, np.zeros_like(source_map)], axis=-1
                )
        # policy advisory (solvers/auto.choose_solver, pure host policy):
        # the service runs the learned family; if the decision surface says
        # a classical solver wins for this problem, warn at submit time so
        # the operator can route the request through cli/solve instead
        plan = choose_solver(sos, cfg=self.solver.cfg, params=self.solver.params)
        if plan.method != "learned":
            warnings.warn(
                f"serve: policy winner for this {h}x{w} problem is "
                f"'{plan.method}' ({plan.rationale}); serving the learned "
                "rollout anyway — consider cli/solve for this request",
                stacklevel=2,
            )
        chunk = self.config.chunk_iterations
        want = iterations or self.config.default_iterations
        rounded = ((want + chunk - 1) // chunk) * chunk
        req = _Request(
            sos=sos,
            source_map=source_map,
            source_location=tuple(source_location) if source_location else None,
            iterations=rounded,
        )
        with self._stats_lock:
            self._stats["requests"] += 1
        self._queue.put(req)
        return req.future

    def solve(self, sos_map, timeout: Optional[float] = None, **kw) -> dict:
        """Synchronous convenience wrapper around submit()."""
        return self.submit(sos_map, **kw).result(timeout=timeout)

    def warmup(self, sizes: Sequence[tuple] = ((96, 96),), batch: int = None,
               timeout: Optional[float] = None):
        """One dummy solve of `chunk_iterations` per grid size at the full
        batch, before traffic: the card's first calls (kernel library
        load, cuDNN's plans, the operator tables) are paid here. Blocking."""
        futures = []
        n = batch or self.config.max_batch
        for h, w in sizes:
            for _ in range(n):
                futures.append(
                    self.submit(
                        np.ones((h, w), np.float32),
                        iterations=self.config.chunk_iterations,
                    )
                )
        for f in futures:
            f.result(timeout=timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
            s["by_size"] = dict(self._stats["by_size"])
        s["queue_depth"] = self._queue.qsize()
        if s["batches"]:
            s["mean_occupancy"] = (
                (s["batched_slots"] - s["padded_slots"]) / s["batched_slots"]
            )
        return s

    def shutdown(self, wait: bool = True):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        if wait:
            self._worker.join(timeout=60)

    # -- worker ----------------------------------------------------------

    def _bucket_key(self, req: _Request) -> tuple:
        return (req.sos.shape, req.iterations)

    def _collect_batch(self) -> list:
        """Block for one request, then coalesce same-bucket requests for up
        to batch_window_s (or until the batch is full). Different-bucket
        requests are left in an overflow list and re-queued."""
        first = self._queue.get()
        if first is None:
            return []
        batch, overflow = [first], []
        key = self._bucket_key(first)
        deadline = time.monotonic() + self.config.batch_window_s
        while len(batch) < self.config.max_batch:
            remaining = deadline - time.monotonic()
            try:
                if remaining > 0:
                    req = self._queue.get(timeout=remaining)
                else:
                    req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is None:
                overflow.append(None)
                break
            if self._bucket_key(req) == key:
                batch.append(req)
            else:
                overflow.append(req)
        for req in overflow:  # preserve arrival order within the bucket
            self._queue.put(req)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                self._execute(batch)
            except Exception as exc:  # noqa: BLE001 — propagate per-request
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
                with self._stats_lock:
                    self._stats["failed"] += len(batch)
        # drain: fail anything still queued
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("service shut down"))

    def _execute(self, batch: list):
        (h, w), iterations = self._bucket_key(batch[0])
        n, pinned = len(batch), self.config.max_batch
        sos = np.stack([r.sos for r in batch])
        if n < pinned:  # pad to the full batch with copies of sample 0
            sos = np.concatenate(
                [sos, np.repeat(sos[:1], pinned - n, axis=0)]
            )

        solver = self.solver
        if (solver.height, solver.width) != (h, w):
            solver.set_domain_size((h, w))
        default_loc = tuple(
            int(round(c * h / self._base_size)) for c in self._base_loc
        )
        maps = []
        for r in batch:
            if r.source_map is not None:
                maps.append(torch.as_tensor(r.source_map, device=solver.device))
            else:
                solver.set_sources([r.source_location or default_loc])
                maps.append(solver.source[0])
        maps.extend([maps[0]] * (pinned - n))
        solver.set_source_maps(torch.stack(maps))

        t0 = time.monotonic()
        out = solver.forward(
            sos,
            num_iterations=iterations,
            chunk_iterations=min(self.config.chunk_iterations, iterations),
        )
        wavefield = _host(out["wavefield"])
        rmse = _host(out["rmse"])
        best = _host(out["best_rmse"])
        device_s = time.monotonic() - t0

        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["batched_slots"] += pinned
            self._stats["padded_slots"] += pinned - n
            self._stats["completed"] += n
            k = f"{h}x{w}"
            self._stats["by_size"][k] = self._stats["by_size"].get(k, 0) + n
        for i, req in enumerate(batch):
            req.future.set_result(
                {
                    "wavefield": wavefield[i],
                    "rmse": rmse[:, i],
                    "best_rmse": float(best[i]),
                    "iterations": iterations,
                    "batch_size": n,
                    "device_s": device_s,
                    "latency_s": time.monotonic() - req.enqueued_at,
                }
            )

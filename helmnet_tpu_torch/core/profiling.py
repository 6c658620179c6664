"""Profiling and timing hooks, port of `helmnet_tpu/core/profiling.py`.

* `trace(dir)`: a context manager around `torch.profiler` that writes a
  Chrome/Perfetto trace file of the enclosed block into `dir` (CPU ops,
  and the card's kernels when CUDA is available).
* `Timer`: wall-clock section timing that waits for the card.
* `solver_roofline`: analytic per-iteration FLOP and byte counts for the
  learned step (the gridpoints/s accounting of bench.py), the same
  arithmetic as the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block; the trace is
    written to `log_dir/trace_<pid>_<ns>.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nested dict/list/tuple."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_cuda_devices, tree))
    return set()


class Timer:
    """Wall-clock section timer for device work.

    Register the result inside the block so __exit__ waits until the card
    has finished it (launches are asynchronous, so otherwise only the
    launch time is measured):

        with Timer() as t:
            y = fn(x)
            t.block(y)
        print(t.seconds)

    `block` takes a tensor or a nested dict/list/tuple of them; __exit__
    synchronises every CUDA device they lie on and does nothing for CPU
    tensors.
    """

    def __enter__(self):
        self._tree = None
        self.start = time.perf_counter()
        return self

    def block(self, tree):
        """Register device output(s) to synchronize on at exit."""
        self._tree = tree
        return tree

    def __exit__(self, *exc):
        if self._tree is not None:
            for dev in _cuda_devices(self._tree):
                torch.cuda.synchronize(dev)
        self.seconds = time.perf_counter() - self.start
        return False


@dataclass
class Roofline:
    flops_per_iteration: float
    bytes_per_iteration: float
    gridpoints: int

    def gridpoints_per_s(self, seconds_per_iteration: float) -> float:
        return self.gridpoints / seconds_per_iteration


def solver_roofline(batch: int, height: int, width: int, features: int = 8,
                    depth: int = 4) -> Roofline:
    """Analytic cost of one learned iteration (UNet forward + matmul
    Laplacian).

    Conv flops: sum over UNet levels of B*(H W/4^d)*(9 Cin Cout)*2 for the
    double convs + down/up k=8 convs; Laplacian: two dense complex matmuls
    = 8*B*H*W*(H+W) real flops (4 real matmuls per axis).
    """
    f = features
    conv_flops = 0.0
    hw = height * width
    for d in range(depth + 1):
        level_hw = hw / (4**d)
        cin = 6 if d == 0 else f
        # double conv (2 convs) at this level on both enc+dec paths
        paths = 2 if d < depth else 1
        conv_flops += paths * batch * level_hw * 2 * 9 * (cin + 2) * f * 2
        if d < depth:
            conv_flops += 2 * batch * level_hw * 64 * f * f * 2 / 4  # down+up
    lap_flops = 8.0 * batch * hw * (height + width)
    # bytes: carry (wf, res, states) + params traffic per iteration
    bytes_per_iter = 4.0 * batch * hw * (2 + 2 + 6) * 3
    return Roofline(
        flops_per_iteration=conv_flops + lap_flops,
        bytes_per_iteration=bytes_per_iter,
        gridpoints=batch * hw,
    )

"""The device trace of a run's traced units, and the arithmetic on it.

`traced(fn)` runs `fn` under torch.profiler with CUDA activity only (the
host's ops would carry the same time again and slow the reading) and
returns a `Trace`: every device operation as (name, start, end) in
seconds, the traced window's length on the host clock, and the busy time
(the union of the operations' intervals). Kernels are the operations
that are not a Memcpy or a Memset.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch

COPY = re.compile(r"^(Memcpy|Memset)")


@dataclass
class Trace:
    ops: list  # (name, start_s, end_s), by start
    window_s: float
    counts: dict = field(default_factory=dict)  # what the traced units did

    @property
    def kernels(self) -> list:
        return [op for op in self.ops if not COPY.match(op[0])]

    def busy_s(self) -> float:
        busy, end = 0.0, -float("inf")
        for _, s, e in self.ops:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy

    def time_of(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n))

    def breakdown(self, top: int = 10) -> dict:
        """The operations that took most device time, and the longest idle
        time between operations, by the operation the device waited for
        (names cut to 100 characters)."""
        by_op, gaps = {}, {}
        end = None
        for full, s, e in self.ops:
            name = full[:100]
            by_op[name] = by_op.get(name, 0.0) + (e - s)
            if end is not None and s > end:
                key = f"idle_before_{name}"
                gaps[key] = gaps.get(key, 0.0) + (s - end)
            end = e if end is None else max(end, e)
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_op), "idle_gaps": order(gaps)}


def traced(fn) -> Trace:
    """Run `fn` (which ends synchronised) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops = sorted((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    ops.sort(key=lambda op: op[1])
    return Trace(ops=ops, window_s=window)


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) falls in set-up and not in a traced window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

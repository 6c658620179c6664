"""K1's share of its roofline: the sum of the bounds of a step's 14 K1
calls (`portbench.counts.bound`: the larger of operations at the bf16
peak and bytes at 3.35 TB/s) times the traced steps, over the device time
of the K1 kernels in the trace, in %. Nothing where K1 did not run."""


def read(trace):
    entry = trace.counts.get("bounds", {}).get("k1")
    if entry is None:
        return None
    pattern, per_step = entry
    seconds = trace.time_of(pattern)
    if seconds <= 0:
        return None
    return 100.0 * per_step * trace.counts["steps"] / seconds

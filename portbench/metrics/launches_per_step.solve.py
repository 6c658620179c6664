"""Kernel launches a solver step: the kernels in the traced window over
the iterations its solves ran (one iteration steps a whole batch)."""


def read(trace):
    steps = trace.counts.get("steps")
    return len(trace.kernels) / steps if steps else None

"""Kernel launches a train step: the kernels in the traced window over the
train steps its epochs ran."""


def read(trace):
    steps = trace.counts.get("train_steps")
    return len(trace.kernels) / steps if steps else None

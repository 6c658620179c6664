"""The whole step's share of the chip's peak: the model FLOPs of the traced
solves (every conv of the network at its output grid, a
transposed conv as its phase convs, and the dense operator's products;
`portbench.counts`) over the traced window, over the peak of the
precision the configuration declares for its convolutions, in %."""


def read(trace):
    flops, peak = trace.counts.get("flops"), trace.counts.get("peak")
    if not flops or not peak or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peak

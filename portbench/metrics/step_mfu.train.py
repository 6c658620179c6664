"""The whole train step's share of the chip's peak: the forward and
backward model FLOPs of the traced epochs' unrolled steps (three times
each conv's forward work, remat's recompute not counted, and the fft
operator at 5 N log2 N a transform; `portbench.train.TrainCell.
layer_counts`) over the traced window, over the f32 peak, in %."""


def read(trace):
    flops, peak = trace.counts.get("flops"), trace.counts.get("peak")
    if not flops or not peak or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / peak

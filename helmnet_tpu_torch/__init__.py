"""PyTorch and CUDA port of helmnet-tpu, for NVIDIA Hopper (H100).

A second package beside `helmnet_tpu/`, which stays the reference that
each module here is tested against. The layout mirrors it (`core/`,
`ops/`, `models/`, `solvers/`), and the public layout is the same: NHWC
channel pairs `[B, H, W, 2]` for wavefields, residuals and sources, and
`[B, H, W]` for sound-speed maps.

The port imports `torch` and numpy, never `jax` or `helmnet_tpu`. Entry
points put their tensors on `cuda` unless the caller passes
`device="cpu"`, and raise when no card is present and no device is given.
"""

__version__ = "0.1.0"

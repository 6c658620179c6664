"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
`device` given they take `cuda`, and raise when there is none. They never
fall back to the CPU on their own.

The JAX operator runs in f32 at HIGHEST precision, so on the card TF32 is
off for both matmul and cuDNN. The only reduced precision the port uses
is the bf16 taps of the fused DoubleConv kernel (ops/double_conv.py).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when it is None; raises if there is no card.
    Resolving a CUDA device turns TF32 off for matmuls and cuDNN."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

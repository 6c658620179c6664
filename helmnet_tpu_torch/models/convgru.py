"""ConvGRU cell, port of `helmnet_tpu/models/convgru.py` (reference
architectures.py:135-183).

Defined but disabled in the reference (the EncoderBlock's ConvGRU call
site is commented out); kept for API completeness as a functional
(init, apply) pair. NHWC tensors, OIHW weights (models/blocks.py).
"""

from __future__ import annotations

import torch

from .blocks import conv2d, init_conv


def init_convgru(generator: torch.Generator, in_channels: int,
                 hidden_channels: int, k: int = 3):
    cin = in_channels + hidden_channels
    return {
        "update_gate": init_conv(generator, k, cin, hidden_channels),
        "reset_gate": init_conv(generator, k, cin, hidden_channels),
        "out_gate": init_conv(generator, k, cin, hidden_channels),
    }


def convgru(params, x: torch.Tensor, h: torch.Tensor,
            precision: str = "default") -> torch.Tensor:
    """One ConvGRU step. x: [B,H,W,Cin], h: [B,H,W,Ch] -> new h."""
    pad = params["update_gate"]["w"].shape[-1] // 2
    xh = torch.cat([x, h], dim=-1)
    update = torch.sigmoid(conv2d(params["update_gate"], xh, padding=pad,
                                  precision=precision))
    reset = torch.sigmoid(conv2d(params["reset_gate"], xh, padding=pad,
                                 precision=precision))
    out = torch.tanh(conv2d(params["out_gate"], torch.cat([x, h * reset], dim=-1),
                            padding=pad, precision=precision))
    return h * (1 - update) + out * update

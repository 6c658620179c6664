"""HybridNet3D, port of `helmnet_tpu/models/hybridnet3d.py`: the
learned-iteration UNet with a multi-resolution hidden state on NDHWC
volumes, paired with the 3D spectral PML operator by
solvers/iterative3d.py.

Structure as in 2D (models/hybridnet.py):
- hidden states are an explicit tuple, one per encoder level
  d < state_depth, shaped [B, D/2^d, H/2^d, W/2^d, state_channels];
- encoder: double_conv3d over [signal, state], state update double_conv3d
  over [out, state], k=4/s=2/p=1 down conv;
- decoder: transposed conv (input-dilated semantics, or the 8-octant
  sub-pixel form) + double_conv3d over [up, skip]; a 1x1x1 head to the
  2-channel wavefield update.

Input channels: wavefield(2) + 1e3*residual(2) + sigma_x/y/z(3) = 7. Every
conv is cuDNN in f32 (the JAX package runs no Pallas kernel in 3D).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.config import ModelConfig
from .blocks3d import (
    conv3d,
    conv_transpose3d,
    conv_transpose3d_subpixel,
    double_conv3d,
    init_conv3d,
    init_conv_transpose3d,
    init_double_conv3d,
)
from .hybridnet import count_params, iter_leaves, map_leaves  # noqa: F401

RESAMPLE_K = 4  # down/up kernel (the JAX package's 3D choice)


def states_dimension3d(domain_size, depth: int):
    """Per-level state grid sizes [(D/2^d, H/2^d, W/2^d)]."""
    if isinstance(domain_size, int):
        d = h = w = domain_size
    else:
        d, h, w = domain_size
    return [(d // (2**l), h // (2**l), w // (2**l)) for l in range(depth)]


def init_params(generator: torch.Generator, cfg: ModelConfig):
    """Random parameters in the port's layout, on the generator's device.
    The draws differ from `jax.random`'s; weights shared with the JAX
    package go through `weights.py`."""
    act = cfg.activation_function
    gen = generator
    params = {
        "inc": init_double_conv3d(gen, cfg.in_channels, cfg.features, act),
        "enc": [],
        "decode": [],
        "up": [],
        "outc": init_conv3d(gen, 1, cfg.features, 2),
    }
    for d in range(cfg.depth):
        use_state = d < cfg.state_depth
        blk = {
            "conv_signal": init_double_conv3d(
                gen, cfg.features + (cfg.state_channels if use_state else 0),
                cfg.features, act),
            "down": init_conv3d(gen, RESAMPLE_K, cfg.features, cfg.features),
        }
        if use_state:
            blk["conv_state"] = init_double_conv3d(
                gen, cfg.features + cfg.state_channels, cfg.state_channels, act)
        params["enc"].append(blk)
    for i in range(cfg.depth + 1):
        cin = cfg.features + cfg.features * (i < cfg.depth)
        params["decode"].append(init_double_conv3d(gen, cin, cfg.features, act))
    for _ in range(cfg.depth):
        params["up"].append(
            init_conv_transpose3d(gen, RESAMPLE_K, cfg.features, cfg.features))
    return params


def init_states(batch: int, domain_size, cfg: ModelConfig, dtype=torch.float32,
                device="cpu") -> Tuple[torch.Tensor, ...]:
    """Zero hidden states on `device`."""
    dims = states_dimension3d(domain_size, cfg.depth)
    return tuple(
        torch.zeros((batch,) + dims[d] + (cfg.state_channels,), dtype=dtype,
                    device=device)
        for d in range(cfg.state_depth)
    )


def apply(
    params,
    x: torch.Tensor,
    states: Sequence[torch.Tensor],
    *,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Forward pass. x: [B, D, H, W, in_channels]. Returns (out[..., 2], states')."""
    act = cfg.activation_function
    prec = cfg.precision

    def dconv(p, *parts):
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return double_conv3d(p, t, act, prec)

    x = dconv(params["inc"], x)
    inner_signals = []
    new_states = []
    for d in range(cfg.depth):
        blk = params["enc"][d]
        if d < cfg.state_depth:
            out = dconv(blk["conv_signal"], x, states[d])
            new_states.append(dconv(blk["conv_state"], out, states[d]))
        else:
            out = dconv(blk["conv_signal"], x)
        inner_signals.append(out)
        x = conv3d(blk["down"], out, stride=2, padding=1, precision=prec)

    up = conv_transpose3d_subpixel if cfg.up_mode == "subpixel" else conv_transpose3d
    x = dconv(params["decode"][-1], x)
    for d in range(cfg.depth - 1, -1, -1):
        x = up(params["up"][d], x, stride=2, padding=1, precision=prec)
        x = dconv(params["decode"][d], x, inner_signals[d])
    out = conv3d(params["outc"], x, precision=prec)
    return out, tuple(new_states)


# ---------------------------------------------------------------------------
# State pack/unpack: flat [B, C, sum(n_d^3)] channel-first layout (the
# replay buffer's, as hybridnet.flatten_states in 2D)
# ---------------------------------------------------------------------------


def flatten_states(states: Sequence[torch.Tensor]) -> torch.Tensor:
    flat = []
    for s in states:
        b, d, h, w, c = s.shape
        flat.append(s.permute(0, 4, 1, 2, 3).reshape(b, c, d * h * w))
    return torch.cat(flat, dim=2)


def unflatten_states(flat: torch.Tensor, domain_size,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    dims = states_dimension3d(domain_size, cfg.depth)
    states = []
    start = 0
    b, c = flat.shape[0], flat.shape[1]
    for l in range(cfg.state_depth):
        dd, hd, wd = dims[l]
        n = dd * hd * wd
        chunk = flat[:, :, start : start + n]
        states.append(chunk.reshape(b, c, dd, hd, wd).permute(0, 2, 3, 4, 1).contiguous())
        start += n
    return tuple(states)


def total_state_length(domain_size, cfg: ModelConfig) -> int:
    dims = states_dimension3d(domain_size, cfg.depth)
    return sum(d * h * w for d, h, w in dims[: cfg.state_depth])

"""Stateful flat ResNet variant, port of `helmnet_tpu/models/resnet.py`
(reference architectures.py:255-314).

In-conv 7x7 on [input, state] -> `depth` x ResDoubleConv at
cmid = 2 * features -> out-conv 7x7 producing 2 + state_channels channels,
the first `state_channels` of which become the next hidden state and the
last 2 the wavefield update. Selected with
`ModelConfig.architecture == "resnet"`.

The state is one full-resolution `[B, H, W, state_channels]` tensor,
carried as a 1-tuple (the same `(out, new_states)` contract as
`hybridnet.apply`). Its convs are cuDNN calls (f32 on the card, TF32
off); like the JAX package's resnet it never reaches a fused DoubleConv
kernel. With `spatial=` (distributed/spatial.Spatial) the input, the
state and the output are this rank's tiles and every conv exchanges its
halo, as `hybridnet.apply` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.config import ModelConfig
from .blocks import conv2d, init_conv, init_double_conv, res_double_conv
from .hybridnet import iter_leaves, map_leaves  # noqa: F401  (registry contract)


def init_params(generator: torch.Generator, cfg: ModelConfig):
    """Random parameters in the port's layout (OIHW), on the generator's
    device. The draws differ from `jax.random`'s; shared weights go
    through `weights.py`."""
    return {
        "inc": init_conv(generator, 7, cfg.in_channels + cfg.state_channels,
                         cfg.features),
        "blocks": [
            init_double_conv(generator, cfg.features, cfg.features,
                             cfg.activation_function, cmid=cfg.features * 2)
            for _ in range(cfg.depth)
        ],
        "outc": init_conv(generator, 7, cfg.features, 2 + cfg.state_channels),
    }


def prepare_params(params, cfg: ModelConfig):
    """The params as they are: the resnet has no kernel weights to convert."""
    return params


def _hw(domain_size, spatial=None) -> tuple[int, int]:
    """The state's grid: `domain_size`, or with `spatial` this rank's tile
    (`domain_size` is not read)."""
    if spatial is not None:
        return spatial.tile_h, spatial.tile_w
    if isinstance(domain_size, int):
        return domain_size, domain_size
    return tuple(domain_size)


def init_states(batch: int, domain_size, cfg: ModelConfig, dtype=torch.float32,
                device="cpu", spatial=None) -> Tuple[torch.Tensor, ...]:
    h, w = _hw(domain_size, spatial)
    return (torch.zeros((batch, h, w, cfg.state_channels), dtype=dtype,
                        device=device),)


def apply(params, x: torch.Tensor, states: Sequence[torch.Tensor], *,
          cfg: ModelConfig, spatial=None) -> tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    prec = cfg.precision
    h = torch.cat([x, states[0]], dim=-1)
    h = conv2d(params["inc"], h, padding=3, precision=prec, spatial=spatial)
    for blk in params["blocks"]:
        h = res_double_conv(blk, h, cfg.activation_function, prec, spatial=spatial)
    y = conv2d(params["outc"], h, padding=3, precision=prec, spatial=spatial)
    new_state = y[..., : cfg.state_channels]
    out = y[..., cfg.state_channels :]
    return out, (new_state,)


def flatten_states(states: Sequence[torch.Tensor]) -> torch.Tensor:
    s = states[0]
    b, h, w, c = s.shape
    return s.permute(0, 3, 1, 2).reshape(b, c, h * w)


def unflatten_states(flat: torch.Tensor, domain_size, cfg: ModelConfig,
                     spatial=None) -> Tuple[torch.Tensor, ...]:
    h, w = _hw(domain_size, spatial)
    b, c = flat.shape[0], flat.shape[1]
    return (flat.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous(),)


def total_state_length(domain_size, cfg: ModelConfig) -> int:
    h, w = _hw(domain_size)
    return h * w

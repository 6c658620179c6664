"""Architecture registry, port of `helmnet_tpu/models/registry.py`.

Each architecture is a namespace exposing the functional model contract:
  init_params(generator, cfg)           -> params tree
  init_states(batch, domain, cfg, ...)  -> tuple of state tensors
  apply(params, x, states, cfg=cfg)     -> (out[B,H,W,2], new_states)
  flatten_states(states)                -> [B, C, S]
  unflatten_states(flat, domain, cfg)   -> tuple of state tensors
  total_state_length(domain, cfg)       -> S

Only `custom_unet` (HybridNet) is ported so far; the JAX package's other
architectures (`resnet`) raise NotImplementedError here.
"""

from __future__ import annotations

from . import hybridnet

ARCHITECTURES = {
    "custom_unet": hybridnet,
}


def get_architecture(name: str):
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to PyTorch yet"
        ) from None

"""Architecture registry, port of `helmnet_tpu/models/registry.py`.

Each architecture is a namespace exposing the functional model contract:
  init_params(generator, cfg)           -> params tree
  init_states(batch, domain, cfg, ...)  -> tuple of state tensors
  prepare_params(params, cfg)           -> params a rollout runs on
  apply(params, x, states, cfg=cfg)     -> (out[B,H,W,2], new_states)
  flatten_states(states)                -> [B, C, S]
  unflatten_states(flat, domain, cfg)   -> tuple of state tensors
  total_state_length(domain, cfg)       -> S

`apply`, `init_states` and `unflatten_states` take `spatial=` (a
distributed/spatial.Spatial): the tensors are then this rank's tiles,
each state at its level's partition (`Spatial.level`).

`custom_unet` (HybridNet) and `resnet`, as in the JAX package; any other
name raises NotImplementedError.
"""

from __future__ import annotations

from . import hybridnet, resnet

ARCHITECTURES = {
    "custom_unet": hybridnet,
    "resnet": resnet,
}


def get_architecture(name: str):
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise NotImplementedError(f"Unknown architecture {name}") from None

"""Activation-function factory, port of `helmnet_tpu/models/activations.py`.

Activations are (init, apply) pairs over a params dict, so the learnable
one (PReLU) lives in the same tree as the conv weights. All are
elementwise and layout-agnostic.

`jax.nn.gelu` defaults to the tanh approximation while torch's GELU
defaults to the exact form, so 'gelu' here is `approximate="tanh"`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _stateless(fn):
    return (lambda generator=None: {}, lambda params, x: fn(x))


def _prelu_init(generator=None):
    # torch nn.PReLU default: single shared slope 0.25
    device = generator.device if generator is not None else "cpu"
    return {"a": torch.full((1,), 0.25, dtype=torch.float32, device=device)}


def _prelu_apply(params, x):
    a = params["a"]
    return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


_ACTIVATIONS = {
    "relu": _stateless(F.relu),
    "celu": _stateless(F.celu),
    "tanh": _stateless(torch.tanh),
    "gelu": _stateless(lambda x: F.gelu(x, approximate="tanh")),
    "tanhshrink": _stateless(lambda x: x - torch.tanh(x)),
    "softplus": _stateless(F.softplus),
    "leakyrelu": _stateless(lambda x: F.leaky_relu(x, 0.01)),
    "prelu": (_prelu_init, _prelu_apply),
}


def get_activation(name: str):
    """Returns (init_fn, apply_fn) for the named activation.

    `relu_batchnorm` maps to plain relu, as in the JAX package.
    """
    key = name.lower()
    if key == "relu_batchnorm":
        key = "relu"
    if key not in _ACTIVATIONS:
        raise NotImplementedError(f"Unknown activation function {name}")
    return _ACTIVATIONS[key]

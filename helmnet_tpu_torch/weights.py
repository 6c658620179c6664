"""Weights carried across from the JAX package, without JAX.

The JAX package keeps conv kernels HWIO and transposed-conv kernels
spatially flipped HWIO (`helmnet_tpu/models/blocks.py`); the port keeps
PyTorch's OIHW and ConvTranspose2d layouts (models/blocks.py).

- `from_jax_params(tree)` converts a JAX params tree, given as nested
  dicts and lists of numpy arrays, to the port's parameters.
- `load_params_npz(path, cfg)` reads the flat `p0 ... pN` npz that
  `helmnet_tpu.train.checkpoint.save_params_npz` writes. The keys carry
  only the JAX tree order (dict keys sorted at every level, lists in
  order), so the leaf paths come from the port's own template of the
  same architecture, walked in that order: for the default model
  `decode[i].{act.a, c1.b, c1.w, c2.b, c2.w}`, then
  `enc[d].{conv_signal..., conv_state..., down.b, down.w}`, then `inc`,
  `outc` and `up[i].{b, w}` — 88 leaves. A count or shape that does not
  match raises.

The 3D model (models/hybridnet3d.py) keeps DHWIO and flipped DHWIO
kernels in the JAX package and OIDHW and ConvTranspose3d's layout here;
`from_jax_params3d(tree)` and `load_params3d_npz(path, cfg)` (the
counterpart of `helmnet_tpu.train.loop3d.load_params3d_npz`: 69 leaves
for the tpu3d_a and tpu3d_het models) convert them the same way.

Orbax checkpoint directories (`checkpoints/`) need orbax, which imports
JAX, and are not read here: `tools/export_orbax_npz.py` writes a run's
params as such an npz (`trained_models/tpu_r2c_best.npz` is
`checkpoints/tpu_r2c` at its best step). The CLIs refuse a directory with
`ORBAX_REFUSAL`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import Config, ModelConfig
from .core.device import resolve_device
from .models.blocks import hwio_to_torch_conv, hwio_to_torch_convtranspose
from .models.blocks3d import dhwio_to_torch_conv3d, dhwio_to_torch_convtranspose3d
from .models.registry import get_architecture

ORBAX_REFUSAL = (
    "is a directory (an orbax checkpoint); the PyTorch port reads a flat "
    "params .npz or a reference .ckpt. Export the run with "
    "`python tools/export_orbax_npz.py DIR OUT.npz` and pass OUT.npz")


def _model_cfg(cfg) -> ModelConfig:
    return cfg.model if isinstance(cfg, Config) else cfg


def _template(cfg):
    model = _model_cfg(cfg)
    arch = get_architecture(model.architecture)
    return arch, arch.init_params(torch.Generator().manual_seed(0), model)


def _to_port_layout(path: str, a) -> np.ndarray:
    a = np.array(a, dtype=np.float32)  # a writable copy
    transposed = path.startswith("up[")
    if a.ndim == 4:
        return hwio_to_torch_convtranspose(a) if transposed else hwio_to_torch_conv(a)
    if a.ndim == 5:
        return (dhwio_to_torch_convtranspose3d(a) if transposed
                else dhwio_to_torch_conv3d(a))
    return a


def leaf_paths(cfg) -> list[str]:
    """The architecture's leaf paths in the JAX package's tree order."""
    arch, template = _template(cfg)
    return [p for p, _ in arch.iter_leaves(template)]


def from_jax_params(tree, device=None):
    """JAX params (nested dicts/lists of numpy arrays) -> port params."""
    from .models.hybridnet import map_leaves

    dev = resolve_device(device)
    return map_leaves(
        tree, lambda p, a: torch.as_tensor(_to_port_layout(p, a), device=dev)
    )


def load_params_npz(path: str, cfg, device=None):
    """Read a flat `p0 ... pN` params npz into the port's parameters."""
    arch, template = _template(cfg)
    return _load_npz(path, template, arch.iter_leaves, arch.map_leaves,
                     _model_cfg(cfg).architecture, device)


# JAX HybridNet3D params -> port params: the same conversion, whose 5-D
# leaves are the 3D kernels
from_jax_params3d = from_jax_params


def load_params3d_npz(path: str, cfg, device=None):
    """Read a HybridNet3D params npz (`p0 ... p68` for depth 3) into the
    port's parameters; `cfg` is a Config or ModelConfig, its input
    channels set to 7 as the JAX loader sets them."""
    from .models import hybridnet3d
    from .solvers.iterative3d import IN_CHANNELS_3D

    model = dataclasses.replace(_model_cfg(cfg), in_channels=IN_CHANNELS_3D)
    template = hybridnet3d.init_params(torch.Generator().manual_seed(0), model)
    return _load_npz(path, template, hybridnet3d.iter_leaves,
                     hybridnet3d.map_leaves, "HybridNet3D", device)


def _load_npz(path, template, iter_leaves, map_leaves, name, device):
    dev = resolve_device(device)
    leaves = dict(iter_leaves(template))
    order = list(leaves)
    with np.load(path) as f:
        expected = {f"p{i}" for i in range(len(order))}
        if set(f.files) != expected:
            raise ValueError(
                f"{path} holds {len(f.files)} arrays; the {name} model has "
                f"{len(order)} leaves p0..p{len(order) - 1}"
            )
        values = {}
        for i, p in enumerate(order):
            a = _to_port_layout(p, f[f"p{i}"])
            want = tuple(leaves[p].shape)
            if a.shape != want:
                raise ValueError(
                    f"{path}: p{i} ({p}) has port shape {a.shape}, "
                    f"expected {want}"
                )
            values[p] = torch.as_tensor(a, device=dev)
    return map_leaves(template, lambda p, _: values[p])

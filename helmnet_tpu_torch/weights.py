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

`load_params_orbax(step_dir, cfg)` reads the params of one step of an
orbax training run (`checkpoints/<run>/step_<n>`, written by
`helmnet_tpu.train.checkpoint.save_checkpoint`) with `train/orbax.py`,
numpy alone, and checks them against the same template.
`tools/export_orbax_npz.py` (optional; needs JAX) writes a run's params
as a flat npz instead: `trained_models/tpu_r2c_best.npz` is
`checkpoints/tpu_r2c` at its best step.
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


def load_params_orbax(step_dir: str, cfg, device=None):
    """The params of one orbax step (`train/orbax.read_step`) as the
    port's parameters; a leaf path or shape that does not match the
    architecture's template raises."""
    from .train.orbax import read_step

    arch, template = _template(cfg)
    tree = read_step(step_dir, subtree="params")["params"]
    found = dict(arch.iter_leaves(tree))
    want = [p for p, _ in arch.iter_leaves(template)]
    if list(found) != want:
        raise ValueError(
            f"{step_dir} holds {len(found)} params leaves; the "
            f"{_model_cfg(cfg).architecture} model has {len(want)}")
    return _checked(template, arch.iter_leaves, arch.map_leaves,
                    lambda p: (p, found[p]), step_dir, device)


def _load_npz(path, template, iter_leaves, map_leaves, name, device):
    order = [p for p, _ in iter_leaves(template)]
    with np.load(path) as f:
        expected = {f"p{i}" for i in range(len(order))}
        if set(f.files) != expected:
            raise ValueError(
                f"{path} holds {len(f.files)} arrays; the {name} model has "
                f"{len(order)} leaves p0..p{len(order) - 1}"
            )
        index = {p: i for i, p in enumerate(order)}
        return _checked(template, iter_leaves, map_leaves,
                        lambda p: (f"p{index[p]} ({p})", f[f"p{index[p]}"]),
                        path, device)


def _checked(template, iter_leaves, map_leaves, value, source, device):
    """The template with each leaf replaced by `value(path)`'s array in
    the port's layout; `value` returns (name, JAX-layout array)."""
    dev = resolve_device(device)
    values = {}
    for p, leaf in iter_leaves(template):
        name, a = value(p)
        a = _to_port_layout(p, a)
        want = tuple(leaf.shape)
        if a.shape != want:
            raise ValueError(
                f"{source}: {name} has port shape {a.shape}, expected {want}")
        values[p] = torch.as_tensor(a, device=dev)
    return map_leaves(template, lambda p, _: values[p])

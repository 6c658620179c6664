"""Checkpoints, port of `helmnet_tpu/train/checkpoint.py`.

- The importer of the reference PyTorch-Lightning checkpoint
  (`trained_models/*.ckpt`, :22-143). It stores tensors under names like
  `f.enc.0.conv_signal.double_conv.0.weight`, already in the port's layouts
  (OIHW convs, `[I, O, k, k]` transposed convs; models/blocks.py), so they
  are taken as they are, with no round trip through the JAX package's HWIO.
- The trainer's own checkpoints (:149-308): a train state (params, Adam
  state, epoch, global step) as one torch file `step_<n>/state.pt`, with
  the JAX package's `manifest.json` semantics (`update_topk`, `best_step`,
  `latest_step`, `manifest_extra`). `restore_checkpoint` also reads a step
  that the JAX package wrote with orbax (train/orbax.py), so a run
  directory may hold steps of both formats; each step is read in its own.
  The port writes only `state.pt` steps.
- `save_params_npz`, the flat `p0 ... pN` npz in the JAX package's leaf
  order and HWIO layout, which `helmnet_tpu.train.checkpoint.load_params_npz`
  and the port's `weights.load_params_npz` both read.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import types
from typing import Any, Tuple

import numpy as np
import torch

from ..core.config import Config, ModelConfig
from ..core.device import resolve_device


def _install_lightning_shim() -> None:
    """Make `pytorch_lightning.utilities.parsing.AttributeDict` importable
    for unpickling when lightning itself is not installed."""
    if "pytorch_lightning" in sys.modules:
        return
    try:
        import pytorch_lightning  # noqa: F401
        return
    except ImportError:
        pass
    m = types.ModuleType("pytorch_lightning")
    u = types.ModuleType("pytorch_lightning.utilities")
    p = types.ModuleType("pytorch_lightning.utilities.parsing")

    class AttributeDict(dict):
        def __getattr__(self, k):
            return self[k]

    p.AttributeDict = AttributeDict
    m.utilities = u
    u.parsing = p
    sys.modules["pytorch_lightning"] = m
    sys.modules["pytorch_lightning.utilities"] = u
    sys.modules["pytorch_lightning.utilities.parsing"] = p


def _load_torch_state_dict(path: str) -> tuple[dict, dict]:
    """A lightning checkpoint's state_dict (f32 CPU tensors) and
    hyper_parameters."""
    _install_lightning_shim()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.detach().to(torch.float32) for k, v in ckpt["state_dict"].items()}
    hparams = dict(ckpt.get("hyper_parameters", {}))
    return sd, hparams


def _conv(sd: dict, prefix: str) -> dict:
    return {"w": sd[f"{prefix}.weight"], "b": sd[f"{prefix}.bias"]}


def _double_conv(sd: dict, prefix: str) -> dict:
    out = {
        "c1": _conv(sd, f"{prefix}.double_conv.0"),
        "c2": _conv(sd, f"{prefix}.double_conv.2"),
    }
    # activation between the convs: PReLU stores a learnable slope at .1
    act_key = f"{prefix}.double_conv.1.weight"
    out["act"] = {"a": sd[act_key]} if act_key in sd else {}
    return out


def params_from_torch_state_dict(sd: dict, cfg: ModelConfig, device=None) -> dict:
    """Map the reference `f.*` tensors to the port's params tree."""
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "inc": _double_conv(sd, "f.inc"),
        "enc": [],
        "decode": [],
        "up": [],
        "outc": _conv(sd, "f.outc.conv"),
    }
    for d in range(cfg.depth):
        blk = {
            "conv_signal": _double_conv(sd, f"f.enc.{d}.conv_signal"),
            "down": _conv(sd, f"f.enc.{d}.down"),
        }
        if f"f.enc.{d}.conv_state.double_conv.0.weight" in sd:
            blk["conv_state"] = _double_conv(sd, f"f.enc.{d}.conv_state")
        params["enc"].append(blk)
    for i in range(cfg.depth + 1):
        params["decode"].append(_double_conv(sd, f"f.decode.{i}"))
    for d in range(cfg.depth):
        params["up"].append(_conv(sd, f"f.up.{d}"))

    from ..models.hybridnet import map_leaves

    return map_leaves(params, lambda _, t: t.contiguous().to(dev))


def load_reference_checkpoint(path: str, device=None) -> Tuple[dict, Config]:
    """Import the reference .ckpt -> (params, Config).

    As the reference's `load_from_checkpoint(strict=False)`: buffers that
    do not map (source, Lap.*) are ignored and rebuilt from the config."""
    sd, hp = _load_torch_state_dict(path)
    cfg = Config()
    cfg = cfg.replace(
        max_iterations=int(hp.get("max_iterations", cfg.max_iterations)),
        geometry=cfg.geometry.__class__(
            domain_size=int(hp.get("domain_size", 96)),
            pml_size=int(hp.get("PMLsize", 8)),
            sigma_max=float(hp.get("sigma_max", 2.0)),
        ),
        model=cfg.model.__class__(
            architecture=hp.get("architecture", "custom_unet"),
            activation_function=hp.get("activation_function", "prelu"),
            features=int(hp.get("features", 8)),
            depth=int(hp.get("depth", 4)),
            state_depth=int(hp.get("state_depth", 4)),
            state_channels=int(hp.get("state_channels", 2)),
        ),
        source=cfg.source.__class__(
            amplitude=float(hp.get("source_amplitude", 10.0)),
            location=tuple(hp.get("source_location", (82, 48))),
            omega=float(hp.get("omega", 1.0)),
            phase=float(hp.get("source_phase", 0.0)),
            smoothing=bool(hp.get("source_smoothing", False)),
        ),
    )
    params = params_from_torch_state_dict(sd, cfg.model, device=device)
    return params, cfg


# ---------------------------------------------------------------------------
# The trainer's checkpoints
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_checkpoint(directory: str, step: int, state: dict) -> None:
    """Save a train state (a dict of tensors, nested dicts and lists of
    them, optimizer state dicts and numbers) as `step_<step>/state.pt`.
    The step directory is written beside its place and then put there,
    replacing whatever step of that number was there (orbax's
    `force=True`), so a step directory holds one format, whole."""
    path = _step_dir(directory, step)
    tmp = f"{path}.saving"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def restore_checkpoint(directory: str, step: int, device=None) -> dict:
    """The train state saved at `step`, its tensors on `device`: the
    port's `state.pt`, or a step of the JAX package's orbax checkpoints
    (`train/orbax.train_state`: params, Adam state, the injected learning
    rate as the one param group's `lr`, epoch, global step)."""
    from .orbax import is_orbax_step, train_state

    dev = resolve_device(device)
    path = _step_dir(directory, step)
    if os.path.isfile(os.path.join(path, STATE_FILE)):
        return torch.load(os.path.join(path, STATE_FILE), map_location=dev,
                          weights_only=True)
    if is_orbax_step(path):
        return train_state(path, device=dev)
    raise FileNotFoundError(
        f"{path} holds neither {STATE_FILE} nor an orbax checkpoint")


def _manifest_path(directory: str) -> str:
    return os.path.join(directory, "manifest.json")


def _load_manifest(directory: str) -> dict:
    path = _manifest_path(directory)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"scores": {}, "last": None, "scheduler": {}}


def _write_manifest(directory: str, manifest: dict) -> None:
    with open(_manifest_path(directory), "w") as f:
        json.dump(manifest, f, indent=1)


def update_topk(
    directory: str,
    step: int,
    val_loss: float,
    state,
    k: int = 3,
    extra: dict | None = None,
) -> None:
    """ModelCheckpoint(save_top_k=k, monitor='val_loss', save_last=True)
    semantics (reference train.py:90-97): save this step, keep the k best
    steps by val_loss plus the most recent one, delete the rest.

    `extra` (JSON-serializable, e.g. plateau-scheduler state) is recorded in
    the manifest per step so multi-segment runs resume the LR schedule.
    """
    save_checkpoint(directory, step, state)
    manifest = _load_manifest(directory)
    score = float(val_loss)
    if not math.isfinite(score):
        score = float("1e30")  # divergent val: eligible for pruning, not top-k
    manifest["scores"][str(step)] = score
    manifest["last"] = step
    if extra is not None:
        manifest.setdefault("scheduler", {})[str(step)] = extra
    ranked = sorted(manifest["scores"].items(), key=lambda kv: kv[1])
    keep = {int(s) for s, _ in ranked[:k]} | {step}
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            s = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if s not in keep and str(s) in manifest["scores"]:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    manifest["scores"] = {
        s: v for s, v in manifest["scores"].items() if int(s) in keep
    }
    manifest["scheduler"] = {
        s: v
        for s, v in manifest.get("scheduler", {}).items()
        if int(s) in keep
    }
    _write_manifest(directory, manifest)


def best_step(directory: str):
    """Step with the lowest recorded val_loss (restore-best for eval)."""
    manifest = _load_manifest(directory)
    if not manifest["scores"]:
        return None
    return int(min(manifest["scores"].items(), key=lambda kv: kv[1])[0])


def manifest_extra(directory: str, step: int) -> dict | None:
    return _load_manifest(directory).get("scheduler", {}).get(str(step))


def pick_step(directory: str, step=None, best: bool = True) -> int:
    """`step`, or else the manifest's best step (`best=True`), or else the
    latest (the JAX package's `from_orbax_checkpoint` choice); no step
    raises FileNotFoundError."""
    if step is None:
        step = best_step(directory) if best else None
        if step is None:  # explicit None check: step 0 is valid
            step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return step


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_params_npz(path: str, params) -> None:
    """Flat-npz export of the port's params in the JAX package's leaf order
    and layouts (HWIO or DHWIO convs, spatially flipped HWIO or DHWIO
    transposed convs): the inverse of `weights.load_params_npz` (and of
    `load_params3d_npz`), read by the JAX package's loaders as their own."""
    from ..models.blocks import torch_conv_to_hwio, torch_convtranspose_to_hwio
    from ..models.blocks3d import torch_conv3d_to_dhwio, torch_convtranspose3d_to_dhwio
    from ..models.hybridnet import iter_leaves

    def jax_layout(leaf_path: str, t: torch.Tensor) -> np.ndarray:
        a = t.detach().cpu().numpy().astype(np.float32)
        transposed = leaf_path.startswith("up[")
        if a.ndim == 4:
            return torch_convtranspose_to_hwio(a) if transposed else torch_conv_to_hwio(a)
        if a.ndim == 5:  # HybridNet3D
            return (torch_convtranspose3d_to_dhwio(a) if transposed
                    else torch_conv3d_to_dhwio(a))
        return a

    np.savez_compressed(path, **{
        f"p{i}": jax_layout(p, t) for i, (p, t) in enumerate(iter_leaves(params))
    })
